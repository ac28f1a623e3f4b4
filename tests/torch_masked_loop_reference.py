"""The JAX package's result on chip_smoke.py's masked loop cell, on the CPU:
recipe (A) of the loop phase (tests/test_loop_reloc._drift_world: 3
cameras of 256x192, 150 oracle features a camera, one 85-frame lap and a
50-frame revisit, fps 7.5, sync, loops on) with mdBRIEF's learned masks
(`ExtractorSettings(use_mdbrief=1, learn_masks=1)`; every feature carries
its landmark's seeded stability mask, tests/torch_mdbrief_masks.py) and a
store that starts small (chip_smoke.MASKED_LOOP_MAP: 16 keyframes, 512
points), so that both capacities grow during the run. The system runs
under the RANSAC seeds chip_smoke.MASKED_LOOP_SEEDS (0, the cell's, and two
more: the counts vary with the seed in the reference itself).
chip_smoke.py's masked loop phase and tests/test_torch_masked_loop.py gate
the port around the numbers this prints (they hold them as constants: the
card's machine has no JAX).

    python tests/torch_masked_loop_reference.py

Prints, for each seed, one line a frame and one JSON line: the frame it
initialized on, frames tracked, keyframes, map points, loops, `_try_close`
calls, the masked candidate matrices and their threshold, the store's final
capacities and the keyframe ATE (tests/test_loop_reloc._kf_ate). Takes ~4
min a seed on the CPU.
"""
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from multicol_slam_tpu.ops import matching  # noqa: E402
from multicol_slam_tpu.slam.features import FrameFeatures  # noqa: E402
from multicol_slam_tpu.slam.loop_closing import LoopCloser  # noqa: E402
from multicol_slam_tpu.slam.map_store import MapConfig  # noqa: E402
from multicol_slam_tpu.slam.system import WORKING, MultiColSLAM  # noqa: E402
from multicol_slam_tpu.utils.config import ExtractorSettings, SlamSettings  # noqa: E402
from test_loop_reloc import _drift_world, _kf_ate  # noqa: E402
from torch_mdbrief_masks import landmark_masks, masked_fields  # noqa: E402


def run(seed: int) -> dict:
    world = _drift_world()
    masks = landmark_masks(world, seed=cs.MASKED_LOOP_MASK_SEED, keep=cs.MASKED_LOOP_KEEP)
    n_feats = cs.LOOP_RECIPES["A"]["n_feats"]
    settings = SlamSettings(fps=7.5, extractor=ExtractorSettings(n_features=n_feats, n_levels=1, scale_factor=1.2,
                                                                 use_mdbrief=1, learn_masks=1))
    cfg = MapConfig(n_cams=cs.C, feats_per_cam=n_feats, n_levels=1, scale_factor=1.2, **cs.MASKED_LOOP_MAP)
    slam = MultiColSLAM(world.rig, settings, cfg, use_loop_closing=True, seed=seed)
    calls = {"try_close": 0, "masked_matrix": 0, "inside": False}
    thresholds = set()
    orig_try, orig_masked = LoopCloser._try_close, matching.hamming_matrix_masked

    def try_close(lc, *a, **kw):
        calls["try_close"] += 1
        calls["inside"] = True
        try:
            return orig_try(lc, *a, **kw)
        finally:
            calls["inside"] = False

    def masked(*a, **kw):
        # the candidate matrices of _try_close only (other callers use it too)
        if calls["inside"]:
            calls["masked_matrix"] += 1
            thresholds.add(1.0 * slam.store.cfg.desc_bytes)
        return orig_masked(*a, **kw)

    LoopCloser._try_close, matching.hamming_matrix_masked = try_close, masked
    try:
        return _drive(world, masks, slam, calls, thresholds)
    finally:
        LoopCloser._try_close, matching.hamming_matrix_masked = orig_try, orig_masked


def _drive(world, masks, slam, calls, thresholds) -> dict:
    t0 = time.perf_counter()
    frames = []
    for t in range(len(world.poses)):
        f = masked_fields(world.frame_features(t), world, masks)
        m = slam.track(feats=FrameFeatures(**{k: jnp.asarray(v) for k, v in f.items()}),
                       timestamp=world.timestamps[t])
        frames.append(m)
        print(f"frame {t:3d} state {m.state} inliers {m.n_inliers:4d} keyframe {int(m.is_keyframe)} keyframes "
              f"{int(slam.store.kf_valid.sum())} points {int(slam.store.pt_valid.sum())} loops "
              f"{slam.loop_closer.n_loops_closed}", flush=True)
    working = [m for m in frames if m.state == WORKING]
    s = slam.store
    out = dict(init_frame=working[0].frame_id if working else None, tracked=len(working),
               n_kf=int(s.kf_valid.sum()), n_pt=int(s.pt_valid.sum()), loops=slam.loop_closer.n_loops_closed,
               try_close=calls["try_close"], masked_matrices=calls["masked_matrix"],
               masked_threshold=sorted(thresholds), use_masks=bool(slam.use_masks),
               kf_capacity=int(s.cfg.max_keyframes), pt_capacity=int(s.cfg.max_points),
               ate_kf=float(_kf_ate(slam, world)), seconds=round(time.perf_counter() - t0, 1))
    print(json.dumps(out), flush=True)
    return out


def main():
    runs = {seed: run(seed) for seed in cs.MASKED_LOOP_SEEDS}
    print(json.dumps({k: [r[k] for r in runs.values()] for k in ("tracked", "n_kf", "n_pt", "loops", "ate_kf")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
