"""Carry the reference package's state, given as numpy arrays, into the port.

The system learns nothing, so its state is the rig calibration, the map,
a frame's features and, for tests and benchmarks, the synthetic world.
Each function takes the arrays the JAX package holds (`np.asarray` of its
fields) and returns the port's objects on `device`: the card unless the
caller passes device="cpu". The map store is host numpy on both sides.
"""
from __future__ import annotations

import numpy as np
import torch

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from multicol_slam_tpu_torch.io.synthetic import SyntheticWorld
from multicol_slam_tpu_torch.models.camera import OmniCamera
from multicol_slam_tpu_torch.models.rig import MultiCamRig
from multicol_slam_tpu_torch.models.vocab import Vocabulary
from multicol_slam_tpu_torch.slam.features import FrameFeatures
from multicol_slam_tpu_torch.slam.map_store import MapConfig, MapStore
from multicol_slam_tpu_torch.slam.tracking_kernels import LocalPoints


def _t(a, dtype, device):
    return torch.tensor(np.asarray(a, dtype), device=device)


def rig_from_numpy(pol, invpol, cde, pp, wh, mc_cayley, device=DEFAULT_DEVICE) -> MultiCamRig:
    """OmniCamera fields [C, MAX_POL], [C, MAX_INVPOL], [C, 3], [C, 2], [C, 2]
    and extrinsics [C, 6] -> MultiCamRig."""
    device = resolve_device(device)
    f32 = np.float32
    cams = OmniCamera(_t(pol, f32, device), _t(invpol, f32, device), _t(cde, f32, device),
                      _t(pp, f32, device), _t(wh, f32, device))
    return MultiCamRig.from_cayley(cams, _t(mc_cayley, f32, device))


def local_points_from_numpy(X, desc, min_dist, max_dist, valid, normal=None, dmask=None,
                            device=DEFAULT_DEVICE) -> LocalPoints:
    device = resolve_device(device)
    f32 = np.float32
    return LocalPoints(
        X=_t(X, f32, device), desc=_t(desc, np.uint8, device),
        min_dist=_t(min_dist, f32, device), max_dist=_t(max_dist, f32, device),
        valid=_t(valid, bool, device),
        normal=None if normal is None else _t(normal, f32, device),
        dmask=None if dmask is None else _t(dmask, np.uint8, device),
    )


def frame_features_from_numpy(uv, response, octave, angle, rays, desc, dmask, valid,
                              device=DEFAULT_DEVICE) -> FrameFeatures:
    device = resolve_device(device)
    f32 = np.float32
    return FrameFeatures(
        uv=_t(uv, f32, device), response=_t(response, f32, device),
        octave=_t(octave, np.int32, device), angle=_t(angle, f32, device),
        rays=_t(rays, f32, device), desc=_t(desc, np.uint8, device),
        dmask=_t(dmask, np.uint8, device), valid=_t(valid, bool, device),
    )


def world_from_numpy(points, descs, poses, timestamps, n_feats, noise_px, seed, max_vis_dist,
                     rig: MultiCamRig) -> SyntheticWorld:
    """A reference `SyntheticWorld`'s fields -> the port's, with `rig` made
    by `rig_from_numpy` (the arrays stay numpy, as in the reference)."""
    return SyntheticWorld(rig, np.asarray(points, np.float32), np.asarray(descs, np.uint8),
                          np.asarray(poses, np.float32), np.asarray(timestamps),
                          int(n_feats), float(noise_px), int(seed), float(max_vis_dist))


def map_store_from_numpy(cfg: dict, arrays: dict, n_kf: int, n_pt_alloc: int, free_kf, free_pt,
                         loop_edges=(), covis_cache=None) -> MapStore:
    """A reference `MapStore` -> the port's: `cfg` its MapConfig's fields
    (`dataclasses.asdict`), `arrays` its kf_* and pt_* arrays, then its
    slot counters, free lists, closed loops and covisibility cache
    (keyframe -> counts; its entries may be up to a keyframe stale, and a
    store answers covisibility queries from it). Every array is copied."""
    store = MapStore(MapConfig(**cfg))
    for name, a in arrays.items():
        old = getattr(store, name)
        if not (name.startswith(("kf_", "pt_")) and isinstance(old, np.ndarray)):
            raise ValueError(f"{name} is not an array of the map store")
        setattr(store, name, np.array(a, dtype=old.dtype))
    store.n_kf, store.n_pt_alloc = int(n_kf), int(n_pt_alloc)
    store._free_kf, store._free_pt = [int(k) for k in free_kf], [int(p) for p in free_pt]
    store.loop_edges = [(int(a), int(b)) for a, b in loop_edges]
    store._covis_cache = {int(k): np.array(v) for k, v in (covis_cache or {}).items()}
    return store


def vocabulary_from_numpy(k, depth, node_desc, children, is_leaf, word_id, word_weight, node_level) -> Vocabulary:
    """A reference `Vocabulary`'s fields -> the port's (host numpy on both
    sides; the descent's device tables are made at first use)."""
    return Vocabulary(int(k), int(depth), np.array(node_desc, np.uint8), np.array(children, np.int32),
                      np.array(is_leaf, bool), np.array(word_id, np.int32), np.array(word_weight, np.float32),
                      np.array(node_level, np.int32))
