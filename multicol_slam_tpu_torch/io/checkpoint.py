"""Map checkpoint and resume (port of `multicol_slam_tpu/io/checkpoint.py`).

The map lives in host arrays (slam/map_store.py), so a snapshot is one
compressed npz: the arrays of `_ARRAY_FIELDS` and a `__meta__` JSON string
with the store's config, counters, free lists, loop edges and the
descriptor pipeline's version. The file format is the JAX package's: each
package loads the other's files. `pt_nobs` is not saved; loading rebuilds
it from `kf_point`. A loaded store starts with an empty covisibility cache.
"""
from __future__ import annotations

import dataclasses
import json
import warnings

import numpy as np

from multicol_slam_tpu_torch.slam.features import DESC_PIPELINE_VERSION
from multicol_slam_tpu_torch.slam.map_store import MapConfig, MapStore

_ARRAY_FIELDS = [
    "kf_valid", "kf_pose", "kf_timestamp", "kf_frame_id",
    "kf_uv", "kf_rays", "kf_octave", "kf_angle", "kf_desc", "kf_dmask",
    "kf_feat_valid", "kf_point", "kf_parent",
    "pt_valid", "pt_X", "pt_normal", "pt_min_dist", "pt_max_dist",
    "pt_desc", "pt_dmask", "pt_first_kf", "pt_visible", "pt_found",
    "pt_created_kfid",
]


def _py(o):
    """JSON for the numpy scalars and arrays the metadata may hold."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def save_map(path: str, store: MapStore) -> None:
    """Write the store to `path` (np.savez_compressed; numpy appends .npz
    to a path without it)."""
    meta = dict(
        config=dataclasses.asdict(store.cfg),
        n_kf=store.n_kf,
        n_pt_alloc=store.n_pt_alloc,
        free_pt=store._free_pt,
        free_kf=store._free_kf,
        loop_edges=store.loop_edges,
        desc_version=DESC_PIPELINE_VERSION,
    )
    arrays = {f: getattr(store, f) for f in _ARRAY_FIELDS}
    np.savez_compressed(path, __meta__=json.dumps(meta, default=_py), **arrays)


def load_map(path: str) -> MapStore:
    """A MapStore at the saved config (a grown store loads at its grown
    capacity). Fields missing from an older file keep the store's initial
    values; a file of another descriptor-pipeline version loads with a
    warning."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        store = MapStore(MapConfig(**meta["config"]))
        for f in _ARRAY_FIELDS:
            if f in data:
                getattr(store, f)[...] = data[f]
    store.n_kf = int(meta["n_kf"])
    store.n_pt_alloc = int(meta["n_pt_alloc"])
    store._free_pt = [int(x) for x in meta["free_pt"]]
    store._free_kf = [int(x) for x in meta["free_kf"]]
    store.loop_edges = [tuple(e) for e in meta["loop_edges"]]
    store.recount_obs()
    saved_v = int(meta.get("desc_version", 1))
    if saved_v != DESC_PIPELINE_VERSION:
        warnings.warn(
            f"map checkpoint was saved with descriptor-pipeline v{saved_v}, "
            f"current extractor is v{DESC_PIPELINE_VERSION}: descriptors in "
            "the map will not match freshly extracted ones bit-for-bit; "
            "relocalization against this map may be degraded"
        )
    return store
