"""ctypes binding of the map store's host-side table scans
(`csrc/mapops.cpp`; port of `multicol_slam_tpu/native.py`).

g++ builds the library at first use into `multicol_slam_tpu_torch/build/`,
once per content of the source. Each scan has its plain numpy version
beside it (`*_plain`): the tests hold the two equal, exactly. A failed
build raises; nothing falls back to numpy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "mapops.cpp"
BUILD_DIR = _PKG / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64
_ARGTYPES = {
    "covisibility_counts": ([_i32p, _u8p, _i64, _i64, _i64, _i32p], None),
    "covisibility_counts2": ([_i32p, _u8p, _i64, _i64, _i64, _i64, _i32p], None),
    "redundancy_counts_fast": ([_i32p, _i32p, _u8p, _i64, _i64, _i64, _i32p], None),
    "vote_counts": ([_i32p, _u8p, _i64, _i64, _u8p, _i64, _i32p], None),
    "find_slots": ([_i32p, _u8p, _i64, _i64, _u8p, _i64, _i32p, _i32p, _i32p, _i64], _i64),
    "count_observations": ([_i32p, _u8p, _i64, _i64, _i32p, _i64, _i32p], None),
}


class _Library:
    """The shared library built from `SOURCE` (thread-safe, built once)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None

    def build(self) -> Path:
        src = SOURCE.read_bytes()
        tag = hashlib.sha1(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
        lib = BUILD_DIR / f"libmapops_{tag}.so"
        if lib.is_file():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return lib

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, (args, res) in _ARGTYPES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = args
                    fn.restype = res
                self._lib = lib
            return self._lib


_LIBRARY = _Library()


def available() -> bool:
    """True when the library builds and loads (g++ present)."""
    try:
        _LIBRARY.get()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _table(kf_point, kf_valid):
    return np.ascontiguousarray(kf_point, np.int32), np.ascontiguousarray(kf_valid, np.uint8)


def _point_mask(pt_ids, n_points: int) -> np.ndarray:
    mask = np.zeros(n_points, np.uint8)
    sp = np.asarray(pt_ids, np.int64)
    mask[sp[(sp >= 0) & (sp < n_points)]] = 1
    return mask


def covisibility_counts(kf_point: np.ndarray, kf_valid: np.ndarray, k: int,
                        n_points: int = 0) -> np.ndarray:
    """counts[j] = slots of keyframe j holding a point that keyframe k also
    observes; 0 for k and for invalid keyframes. `n_points` > 0 is the
    point-id capacity and takes the dense-bitmap scan (ids >= it are not
    counted); 0 takes the hash-probe scan over every id."""
    K, F = kf_point.shape
    out = np.zeros(K, np.int32)
    table = _table(kf_point, kf_valid)
    if n_points > 0:
        _LIBRARY.get().covisibility_counts2(*table, K, F, int(k), int(n_points), out)
    else:
        _LIBRARY.get().covisibility_counts(*table, K, F, int(k), out)
    return out


def covisibility_counts_plain(kf_point, kf_valid, k: int, n_points: int = 0) -> np.ndarray:
    pts = kf_point[k]
    pts = pts[pts >= 0]
    if n_points > 0:
        pts = pts[pts < n_points]
    pts = np.unique(pts)
    counts = (np.isin(kf_point, pts) & (kf_point >= 0)).sum(axis=1).astype(np.int32)
    counts[k] = 0
    counts[~kf_valid.astype(bool)] = 0
    return counts


def count_observations(kf_point: np.ndarray, kf_valid: np.ndarray, pt_ids: np.ndarray) -> np.ndarray:
    """n_obs[i] = slots of valid keyframes observing pt_ids[i] (unique ids
    >= 0)."""
    K, F = kf_point.shape
    pt_ids = np.ascontiguousarray(pt_ids, np.int32)
    out = np.zeros(len(pt_ids), np.int32)
    if len(pt_ids):
        _LIBRARY.get().count_observations(*_table(kf_point, kf_valid), K, F, pt_ids, len(pt_ids), out)
    return out


def count_observations_plain(kf_point, kf_valid, pt_ids) -> np.ndarray:
    pt_ids = np.asarray(pt_ids, np.int64)
    vp = kf_point[kf_valid.astype(bool)]
    flat = vp[vp >= 0]
    counts = np.bincount(flat, minlength=int(pt_ids.max(initial=-1)) + 1)
    return counts[pt_ids].astype(np.int32)


def vote_counts(kf_point: np.ndarray, kf_valid: np.ndarray, seed_pts: np.ndarray,
                n_points: int) -> np.ndarray:
    """votes[j] = slots of valid keyframe j assigned to a point in seed_pts
    (the tracker's per-frame local-map vote)."""
    K, F = kf_point.shape
    out = np.zeros(K, np.int32)
    _LIBRARY.get().vote_counts(*_table(kf_point, kf_valid), K, F,
                               _point_mask(seed_pts, n_points), int(n_points), out)
    return out


def vote_counts_plain(kf_point, kf_valid, seed_pts, n_points: int) -> np.ndarray:
    sp = np.asarray(seed_pts, np.int64)
    votes = (np.isin(kf_point, sp[(sp >= 0) & (sp < n_points)]) & (kf_point >= 0)).sum(axis=1)
    votes = votes.astype(np.int32)
    votes[~kf_valid.astype(bool)] = 0
    return votes


def find_slots(kf_point: np.ndarray, kf_valid: np.ndarray, pt_ids: np.ndarray, n_points: int,
               expected_hits: int):
    """All (kf, feat, point) slots of valid keyframes observing any of
    pt_ids, in row-major order. `expected_hits` sizes the buffers (callers
    pass the store's observation counts); a larger true count re-runs the
    scan. Returns (ks, fs, pid) int64 arrays."""
    K, F = kf_point.shape
    table = _table(kf_point, kf_valid)
    mask = _point_mask(pt_ids, n_points)
    cap = max(int(expected_hits), 1)
    while True:
        ok, of, op = (np.zeros(cap, np.int32) for _ in range(3))
        n = _LIBRARY.get().find_slots(*table, K, F, mask, int(n_points), ok, of, op, cap)
        if n <= cap:
            return ok[:n].astype(np.int64), of[:n].astype(np.int64), op[:n].astype(np.int64)
        cap = int(n)


def find_slots_plain(kf_point, kf_valid, pt_ids, n_points: int, expected_hits: int = 0):
    sp = np.asarray(pt_ids, np.int64)
    hit = (np.isin(kf_point, sp[(sp >= 0) & (sp < n_points)]) & (kf_point >= 0)
           & kf_valid.astype(bool)[:, None])
    ks, fs = np.nonzero(hit)
    return ks.astype(np.int64), fs.astype(np.int64), kf_point[ks, fs].astype(np.int64)


def redundancy_counts(kf_point: np.ndarray, kf_octave: np.ndarray, kf_valid: np.ndarray,
                      j: int) -> np.ndarray:
    """For each slot g of keyframe j: the slots of other valid keyframes
    observing its point at octave <= octave(j, g) + 1 (KeyFrameCulling)."""
    K, F = kf_point.shape
    out = np.zeros(F, np.int32)
    kp, kv = _table(kf_point, kf_valid)
    _LIBRARY.get().redundancy_counts_fast(kp, np.ascontiguousarray(kf_octave, np.int32), kv,
                                          K, F, int(j), out)
    return out


def redundancy_counts_plain(kf_point, kf_octave, kf_valid, j: int) -> np.ndarray:
    out = np.zeros(kf_point.shape[1], np.int32)
    others = kf_valid.astype(bool).copy()
    others[j] = False
    for g in np.nonzero(kf_point[j] >= 0)[0]:
        same = (kf_point == kf_point[j, g]) & others[:, None]
        out[g] = int((same & (kf_octave <= kf_octave[j, g] + 1)).sum())
    return out
