"""Host-side map store: keyframes, map points, observations, covisibility
(port of `multicol_slam_tpu/slam/map_store.py`; numpy only, as there).

The reference's pointer-graph map (cMap, cMapPoint, cMultiKeyFrame) becomes
fixed-capacity numpy arrays and index tables:

- the observation multimap (cMapPoint.h:78) is the dense assignment table
  `kf_point[kf, flat_feature] -> point_id` (-1 when none); one point may be
  attached to several features of the SAME keyframe (one per camera);
- covisibility weights and the spanning tree are recomputed from that table
  by the native scans (`multicol_slam_tpu_torch/native.py`);
- BA problems are views: `ba_problem()` gathers the flat observation arrays
  the LM solver takes.

Capacities double when full (the reference's map is unbounded and relies on
culling); erased slots are recycled.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np

from multicol_slam_tpu_torch import native

BAD_ID = -1
_POPCOUNT = np.asarray([bin(i).count("1") for i in range(256)], np.uint8)   # bits set in each byte


def cayley_to_rot_np(c: np.ndarray) -> np.ndarray:
    """Cayley 3-vector -> rotation in float64 numpy (misc.h:135-162), for the
    host bookkeeping that touches many tiny poses a frame."""
    c = np.asarray(c, np.float64)
    c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2]
    c1s, c2s, c3s = c1 * c1, c2 * c2, c3 * c3
    scale = 1.0 + c1s + c2s + c3s
    R = np.empty(c.shape[:-1] + (3, 3), np.float64)
    R[..., 0, 0] = 1.0 + c1s - c2s - c3s
    R[..., 0, 1] = 2.0 * (c1 * c2 - c3)
    R[..., 0, 2] = 2.0 * (c1 * c3 + c2)
    R[..., 1, 0] = 2.0 * (c1 * c2 + c3)
    R[..., 1, 1] = 1.0 - c1s + c2s - c3s
    R[..., 1, 2] = 2.0 * (c2 * c3 - c1)
    R[..., 2, 0] = 2.0 * (c1 * c3 - c2)
    R[..., 2, 1] = 2.0 * (c2 * c3 + c1)
    R[..., 2, 2] = 1.0 - c1s - c2s + c3s
    return R / scale[..., None, None]


def cayley_to_hom_np(c6: np.ndarray) -> np.ndarray:
    """[cayley(3), t(3)] -> 4x4, float64 numpy (misc.h:195-226)."""
    c6 = np.asarray(c6, np.float64)
    M = np.zeros(c6.shape[:-1] + (4, 4), np.float64)
    M[..., :3, :3] = cayley_to_rot_np(c6[..., :3])
    M[..., :3, 3] = c6[..., 3:6]
    M[..., 3, 3] = 1.0
    return M


def rot_to_cayley_np(R: np.ndarray) -> np.ndarray:
    """Rotation -> Cayley: C = (R - I)(R + I)^-1, c = (-C12, C02, -C01)."""
    R = np.asarray(R, np.float64)
    eye = np.eye(3)
    C = np.swapaxes(np.linalg.solve(np.swapaxes(R + eye, -1, -2), np.swapaxes(R - eye, -1, -2)), -1, -2)
    return np.stack([-C[..., 1, 2], C[..., 0, 2], -C[..., 0, 1]], axis=-1)


def hom_to_cayley_np(M: np.ndarray) -> np.ndarray:
    """4x4 -> [cayley(3), t(3)] float32."""
    M = np.asarray(M, np.float64)
    return np.concatenate([rot_to_cayley_np(M[..., :3, :3]), M[..., :3, 3]], axis=-1).astype(np.float32)


def hom_inverse_np(M: np.ndarray) -> np.ndarray:
    """SE(3) inverse in float64 numpy (cConverter::invMat)."""
    M = np.asarray(M, np.float64)
    out = np.zeros_like(M)
    Rt = np.swapaxes(M[..., :3, :3], -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, M[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out


@dataclasses.dataclass
class MapConfig:
    max_keyframes: int = 256
    max_points: int = 20000
    n_cams: int = 3
    feats_per_cam: int = 400
    n_levels: int = 8
    scale_factor: float = 1.2
    desc_bytes: int = 32

    @property
    def feats_per_kf(self) -> int:
        return self.n_cams * self.feats_per_cam


_KF_FIELDS = ("kf_valid", "kf_pose", "kf_timestamp", "kf_frame_id", "kf_uv", "kf_rays", "kf_octave",
              "kf_angle", "kf_desc", "kf_dmask", "kf_feat_valid", "kf_point", "kf_parent")
_KF_FILLS = (False, 0, 0, -1, 0, 0, 0, 0, 0, 255, False, BAD_ID, BAD_ID)
_PT_FIELDS = ("pt_valid", "pt_X", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_desc", "pt_dmask",
              "pt_first_kf", "pt_visible", "pt_found", "pt_created_kfid", "pt_nobs")
_PT_FILLS = (False, 0, 0, 0, 0, 0, 255, BAD_ID, 0, 0, 0, 0)


class MapStore:
    """Single-writer SLAM map. All arrays preallocated."""

    def __init__(self, cfg: MapConfig):
        self.cfg = cfg
        K, P, F = cfg.max_keyframes, cfg.max_points, cfg.feats_per_kf
        B = cfg.desc_bytes
        # --- keyframes -----------------------------------------------------
        self.kf_valid = np.zeros(K, bool)
        self.kf_pose = np.zeros((K, 6), np.float32)          # M_t cayley
        self.kf_timestamp = np.zeros(K, np.float64)
        self.kf_frame_id = np.full(K, -1, np.int64)
        # frozen frame features (flattened over cameras: f = cam * feats + i)
        self.kf_uv = np.zeros((K, F, 2), np.float32)
        self.kf_rays = np.zeros((K, F, 3), np.float32)
        self.kf_octave = np.zeros((K, F), np.int32)
        self.kf_angle = np.zeros((K, F), np.float32)
        self.kf_desc = np.zeros((K, F, B), np.uint8)
        self.kf_dmask = np.full((K, F, B), 255, np.uint8)
        self.kf_feat_valid = np.zeros((K, F), bool)
        # feature -> map point assignment (mvpMapPoints)
        self.kf_point = np.full((K, F), BAD_ID, np.int32)
        # covisibility spanning tree (cMultiKeyFrame.h:52-72): parent = the
        # max-covisibility keyframe among earlier ones, set at the keyframe's
        # first connection update
        self.kf_parent = np.full(K, BAD_ID, np.int32)
        # --- points --------------------------------------------------------
        self.pt_valid = np.zeros(P, bool)
        self.pt_X = np.zeros((P, 3), np.float32)
        self.pt_normal = np.zeros((P, 3), np.float32)
        self.pt_min_dist = np.zeros(P, np.float32)
        self.pt_max_dist = np.zeros(P, np.float32)
        self.pt_desc = np.zeros((P, B), np.uint8)
        self.pt_dmask = np.full((P, B), 255, np.uint8)
        self.pt_first_kf = np.full(P, BAD_ID, np.int32)
        self.pt_visible = np.zeros(P, np.int32)   # mnVisible
        self.pt_found = np.zeros(P, np.int32)     # mnFound
        self.pt_created_kfid = np.zeros(P, np.int32)
        # pt_nobs[p] == (kf_point == p).sum() at all times: every kf_point
        # mutation goes through the methods below
        self.pt_nobs = np.zeros(P, np.int32)
        self.n_kf = 0
        self.n_pt_alloc = 0
        self._free_pt: List[int] = []
        self._free_kf: List[int] = []
        # closed loops (current keyframe, loop keyframe): the essential graph's
        # loop edges
        self.loop_edges: List[Tuple[int, int]] = []
        self.scale_factors = cfg.scale_factor ** np.arange(cfg.n_levels)
        # called with the keyframe id when a keyframe is culled (the loop
        # closer's inverted file drops it: mpKeyFrameDB->erase)
        self.on_kf_erased: List[Callable[[int], None]] = []
        # covisibility cache, cleared on keyframe insert / erase: like the
        # reference's maintained connection lists, observation-level changes
        # leave entries stale for at most one keyframe interval
        self._covis_cache: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------ capacity
    def _grow_axis0(self, names, old_n: int, new_n: int, fills):
        for name, fill in zip(names, fills):
            a = getattr(self, name)
            grown = np.full((new_n,) + a.shape[1:], fill, a.dtype)
            grown[:old_n] = a
            setattr(self, name, grown)

    def _grow_keyframes(self):
        old, new = self.cfg.max_keyframes, 2 * self.cfg.max_keyframes
        self._grow_axis0(_KF_FIELDS, old, new, _KF_FILLS)
        self.cfg.max_keyframes = new
        print(f"[multicol-slam] map grew: keyframe capacity {old} -> {new}")

    def _grow_points(self):
        old, new = self.cfg.max_points, 2 * self.cfg.max_points
        self._grow_axis0(_PT_FIELDS, old, new, _PT_FILLS)
        self.cfg.max_points = new
        print(f"[multicol-slam] map grew: point capacity {old} -> {new}")

    # ------------------------------------------------------------------ kfs
    def add_keyframe(self, pose6, feats, timestamp: float, frame_id: int) -> int:
        """feats: the port's FrameFeatures (tensors on any device; copied to
        the host here). Returns the keyframe id."""
        if self._free_kf:
            k = self._free_kf.pop()
        else:
            k = self.n_kf
            if k >= self.cfg.max_keyframes:
                self._grow_keyframes()
            self.n_kf += 1
        F = self.cfg.feats_per_kf
        host = {name: getattr(feats, name).cpu().numpy()
                for name in ("uv", "rays", "octave", "angle", "desc", "dmask", "valid")}
        self.kf_valid[k] = True
        self.kf_pose[k] = np.asarray(pose6)
        self.kf_timestamp[k] = timestamp
        self.kf_frame_id[k] = frame_id
        self.kf_uv[k] = host["uv"].reshape(F, 2)
        self.kf_rays[k] = host["rays"].reshape(F, 3)
        self.kf_octave[k] = host["octave"].reshape(F)
        self.kf_angle[k] = host["angle"].reshape(F)
        self.kf_desc[k] = host["desc"].reshape(F, -1)
        self.kf_dmask[k] = host["dmask"].reshape(F, -1)
        self.kf_feat_valid[k] = host["valid"].reshape(F)
        self.kf_point[k] = BAD_ID
        self.kf_parent[k] = BAD_ID
        self._covis_cache.clear()
        return k

    def assign_parent(self, k: int):
        """First-connection parent (UpdateConnections sets mpParent the first
        time): the max-covisibility keyframe among EARLIER ones (frame-id
        order keeps the tree acyclic). No-op once parented."""
        if not self.kf_valid[k] or self.kf_parent[k] != BAD_ID:
            return
        best, bw = BAD_ID, 0
        my_fid = self.kf_frame_id[k]
        for j, w in self.covisibility(int(k)).items():
            if j != k and self.kf_valid[j] and self.kf_frame_id[j] < my_fid and w > bw:
                best, bw = int(j), int(w)
        self.kf_parent[k] = best

    def erase_keyframe(self, k: int):
        """SetBadFlag: detach all observations, free the slot
        (cMultiKeyFrame.cpp:583-660), and re-home spanning-tree children with
        the reference's candidate loop: candidates start as the erased
        keyframe's parent; each child attaches to its max-covisibility
        candidate and then becomes a candidate itself."""
        self._covis_cache.clear()
        children = [int(c) for c in np.nonzero((self.kf_parent == k) & self.kf_valid)[0]]
        parent_of_k = int(self.kf_parent[k])
        if children:
            candidates = [parent_of_k] if parent_of_k != BAD_ID else []
            while children and candidates:
                best = None  # (weight, child, new_parent)
                for c in children:
                    cov = self.covisibility(c)
                    for p in candidates:
                        w = cov.get(p, 0)
                        if w > 0 and (best is None or w > best[0]):
                            best = (w, c, p)
                if best is None:
                    break
                _, c, p = best
                self.kf_parent[c] = p
                candidates.append(c)
                children.remove(c)
            for c in children:  # no covisibility with any candidate
                self.kf_parent[c] = parent_of_k
        self.kf_parent[k] = BAD_ID
        row = self.kf_point[k]
        obs = row[row >= 0]
        pts = np.unique(obs)
        np.subtract.at(self.pt_nobs, obs, 1)
        self.kf_valid[k] = False
        self.kf_point[k] = BAD_ID
        self.kf_feat_valid[k] = False
        self._free_kf.append(k)
        # the re-homing above cached the children's covisibility with k still
        # valid: cleared again, or a child would name the erased keyframe
        # until the next insert (the reference keeps those entries, and its
        # CorrectLoop then looks the erased keyframe up in its pose snapshot)
        self._covis_cache.clear()
        for cb in self.on_kf_erased:
            cb(int(k))
        for p in pts:
            if self.pt_valid[p] and self.point_n_obs(p) < 2:
                self.erase_point(p)
        # re-home points whose first keyframe this was: the slot id will be
        # recycled, and a stale reference would name an unrelated keyframe
        live = pts[self.pt_valid[pts]]
        orphans = live[self.pt_first_kf[live] == k]
        if len(orphans):
            ks2, _, vals = native.find_slots(self.kf_point, self.kf_valid, orphans, self.cfg.max_points,
                                             expected_hits=int(self.pt_nobs[orphans].sum()))
            for p in orphans:
                owners = ks2[vals == p]
                self.pt_first_kf[p] = int(owners[0]) if len(owners) else BAD_ID

    def feat_cam(self, f):
        """flat feature index -> camera index."""
        return f // self.cfg.feats_per_cam

    # --------------------------------------------------------------- points
    def add_point(self, X, desc, dmask, first_kf: int, normal, min_dist, max_dist) -> int:
        if self._free_pt:
            p = self._free_pt.pop()
        else:
            p = self.n_pt_alloc
            if p >= self.cfg.max_points:
                self._grow_points()
            self.n_pt_alloc += 1
        self.pt_valid[p] = True
        self.pt_X[p] = X
        self.pt_desc[p] = desc
        self.pt_dmask[p] = dmask
        self.pt_first_kf[p] = first_kf
        self.pt_normal[p] = normal
        self.pt_min_dist[p] = min_dist
        self.pt_max_dist[p] = max_dist
        self.pt_visible[p] = 1
        self.pt_found[p] = 1
        self.pt_created_kfid[p] = first_kf
        self.pt_nobs[p] = 0
        return p

    def erase_point(self, p: int):
        self.pt_valid[p] = False
        if self.pt_nobs[p] > 0:  # unobserved points need no table scan
            self.kf_point[self.kf_point == p] = BAD_ID
        self.pt_nobs[p] = 0
        self._free_pt.append(p)

    def replace_point(self, old: int, new: int):
        """cMapPoint::Replace: redirect every observation of `old` to `new`,
        unless that keyframe already observes `new`."""
        ks, fs = np.nonzero(self.kf_point == old)
        for k, f in zip(ks, fs):
            if not (self.kf_point[k] == new).any():
                self.kf_point[k, f] = new
                self.pt_nobs[new] += 1
            else:
                self.kf_point[k, f] = BAD_ID
        self.pt_nobs[old] = 0
        self.pt_found[new] += self.pt_found[old]
        self.pt_visible[new] += self.pt_visible[old]
        self.pt_valid[old] = False
        self._free_pt.append(old)

    def add_observation(self, k: int, f: int, p: int):
        old = self.kf_point[k, f]
        if old >= 0:
            self.pt_nobs[old] -= 1
        self.kf_point[k, f] = p
        self.pt_nobs[p] += 1

    def erase_observation(self, k: int, f: int):
        old = self.kf_point[k, f]
        if old >= 0:
            self.pt_nobs[old] -= 1
        self.kf_point[k, f] = BAD_ID

    def point_n_obs(self, p: int) -> int:
        return int(self.pt_nobs[p])

    def point_n_obs_many(self, ps: np.ndarray) -> np.ndarray:
        return self.pt_nobs[np.asarray(ps, np.int64)]

    def recount_obs(self):
        """Rebuild pt_nobs from kf_point (a loaded checkpoint does not carry it)."""
        flat = self.kf_point[self.kf_point >= 0]
        self.pt_nobs[:] = 0
        if len(flat):
            np.add.at(self.pt_nobs, flat, 1)

    def point_observers(self, p: int):
        """(keyframes, feature slots) observing point p."""
        return np.nonzero(self.kf_point == p)

    # ---------------------------------------------------- derived structures
    def active_kfs(self) -> np.ndarray:
        return np.nonzero(self.kf_valid)[0]

    def active_points(self) -> np.ndarray:
        return np.nonzero(self.pt_valid)[0]

    def covisibility(self, k: int, min_weight: int = 1) -> Dict[int, int]:
        """Keyframes sharing map points with k and their shared-slot counts
        (UpdateConnections, cMultiKeyFrame.cpp:412-500); cached until the
        keyframe set changes."""
        counts = self._covis_cache.get(int(k))
        if counts is None:
            counts = native.covisibility_counts(self.kf_point, self.kf_valid, k, self.cfg.max_points)
            self._covis_cache[int(k)] = counts
        return {int(j): int(c) for j, c in enumerate(counts) if c >= min_weight}

    def best_covisible(self, k: int, n: int) -> List[int]:
        cov = self.covisibility(k)
        return [j for j, _ in sorted(cov.items(), key=lambda kv: -kv[1])[:n]]

    def update_point_stats(self, p: int):
        self.update_point_stats_many(np.asarray([p]))

    def update_point_stats_many(self, ps: np.ndarray):
        """Recompute each point's distinctive descriptor (median-Hamming
        medoid, cMapPoint.cpp:297-391), mean viewing normal and scale-
        invariance distance range (:453-497), with one table scan. Points
        with the same number of observations are computed together (the
        reference loops point by point; the results are the same, to the
        bit: tests/test_torch_map_store.py)."""
        ps = np.unique(np.asarray(ps, np.int64))
        ps = ps[(ps >= 0) & self.pt_valid[ps]]
        if len(ps) == 0:
            return
        ks_all, fs_all, pid = native.find_slots(self.kf_point, self.kf_valid, ps, self.cfg.max_points,
                                                expected_hits=int(self.pt_nobs[ps].sum()))
        if len(ks_all) == 0:
            return
        order = np.argsort(pid, kind="stable")
        ks_all, fs_all, pid = ks_all[order], fs_all[order], pid[order]
        starts = np.searchsorted(pid, ps, side="left")
        counts = np.searchsorted(pid, ps, side="right") - starts
        # body centres of all observing keyframes (camera offsets are small
        # against scene depth)
        centers_all = self.kf_pose[ks_all][:, 3:6].astype(np.float64)
        sf = self.cfg.scale_factor
        inv_band = 1.0 / (sf ** (self.cfg.n_levels - 1))
        for M in np.unique(counts[counts > 0]):
            sel = counts == M
            p, rows = ps[sel], starts[sel][:, None] + np.arange(M)          # [n], [n, M]
            ks, fs = ks_all[rows], fs_all[rows]
            descs, masks = self.kf_desc[ks, fs], self.kf_dmask[ks, fs]       # [n, M, B]
            if M > 1:
                # masked median-Hamming medoid: d = (popc(x & m_i) +
                # popc(x & m_j)) / 2; all-255 masks give the plain medoid
                x = descs[:, :, None, :] ^ descs[:, None, :, :]              # [n, M, M, B]
                xa = _POPCOUNT[x & masks[:, :, None, :]].sum(-1, dtype=np.int64)
                xb = _POPCOUNT[x & masks[:, None, :, :]].sum(-1, dtype=np.int64)
                best = np.argmin(np.median(0.5 * (xa + xb), axis=2), axis=1)
            else:
                best = np.zeros(len(p), np.int64)
            ar = np.arange(len(p))
            self.pt_desc[p] = descs[ar, best]
            self.pt_dmask[p] = masks[ar, best]
            vecs = self.pt_X[p][:, None, :] - centers_all[rows]              # [n, M, 3] float64
            dists = np.linalg.norm(vecs, axis=-1) + 1e-12
            nrm = (vecs / dists[..., None]).mean(1)
            n = np.linalg.norm(nrm, axis=-1)
            pos = n > 0
            nrm[pos] = nrm[pos] / n[pos, None]
            self.pt_normal[p] = nrm
            levels = self.kf_octave[ks[:, 0], fs[:, 0]]
            self.pt_max_dist[p] = dists[:, 0] * np.asarray([sf ** int(lv) for lv in levels])
            for q in p:   # float32 times a float, as the reference's scalar does
                self.pt_min_dist[q] = self.pt_max_dist[q] * inv_band

    # ------------------------------------------------------------ BA export
    def ba_problem(self, kf_ids: np.ndarray, fixed_kf_ids: np.ndarray = None):
        """Flatten (kf, feature) -> point into BA arrays (local indices).

        Local BA semantics (cOptimizer.cpp:489-909): free keyframes = kf_ids,
        fixed = fixed_kf_ids (anchors), points = every point the free
        keyframes observe. Rows are sorted by local point id."""
        fixed_kf_ids = np.asarray(fixed_kf_ids if fixed_kf_ids is not None else [], np.int64)
        all_kf = np.concatenate([np.asarray(kf_ids, np.int64), fixed_kf_ids])
        kf_local = {int(k): i for i, k in enumerate(all_kf)}
        pts = self.kf_point[np.asarray(kf_ids, np.int64)]
        pts = np.unique(pts[pts >= 0])
        pt_local = {int(p): i for i, p in enumerate(pts)}
        rows = []
        for k in all_kf:
            fp = self.kf_point[k]
            sel = np.nonzero((fp >= 0) & np.isin(fp, pts))[0]
            for f in sel:
                rows.append((kf_local[int(k)], pt_local[int(fp[f])], int(self.feat_cam(f)), f, int(k)))
        if not rows:
            return None
        rows = np.asarray(rows, np.int64)
        rows = rows[np.argsort(rows[:, 1], kind="stable")]
        inv_sigma2 = (1.0 / self.scale_factors**2)[self.kf_octave[rows[:, 4], rows[:, 3]]].astype(np.float32)
        return dict(
            kf_ids=all_kf,
            pt_ids=pts,
            n_free_kf=len(kf_ids),
            obs_kf=rows[:, 0].astype(np.int32),
            obs_pt=rows[:, 1].astype(np.int32),
            obs_cam=rows[:, 2].astype(np.int32),
            obs_feat=rows[:, 3].astype(np.int32),
            obs_kf_global=rows[:, 4].astype(np.int32),
            obs_uv=self.kf_uv[rows[:, 4], rows[:, 3]],
            obs_inv_sigma2=inv_sigma2,
            poses=self.kf_pose[all_kf].copy(),
            points=self.pt_X[pts].copy(),
        )

    def write_back(self, prob, poses=None, points=None):
        if poses is not None:
            self.kf_pose[prob["kf_ids"][: prob["n_free_kf"]]] = np.asarray(poses[: prob["n_free_kf"]])
        if points is not None:
            self.pt_X[prob["pt_ids"]] = np.asarray(points)
