"""The JAX package's result on chip_smoke.py's mdBRIEF system recipe, on the
CPU: the room world of bench.py:207-211 (3000 landmarks, a 3 m circle at
400 frames a lap, seed 12) rendered at 3 x 754x480 for 60 frames, 400
features, 8 levels, FAST 20, mdBRIEF with learned masks, sync mode, loop
closing on. chip_smoke.py's phase 15 gates the port on the card around the
numbers this prints (it holds them as constants: the card's machine has
no JAX).

    python tests/torch_mdbrief_reference.py [--frames N]

Prints the frame it initialized on, the frames tracked, the keyframes, the
map points, the ATE of the track-time poses (Sim3-aligned) and one JSON
line. Takes ~5 min and ~2.6 GB (resident) on the CPU.
"""
import argparse
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from multicol_slam_tpu.io.render import render_frame  # noqa: E402
from multicol_slam_tpu.io.synthetic import make_world  # noqa: E402
from multicol_slam_tpu.io.trajectory import umeyama_align  # noqa: E402
from multicol_slam_tpu.models.camera import OmniCamera  # noqa: E402
from multicol_slam_tpu.models.rig import MultiCamRig  # noqa: E402
from multicol_slam_tpu.slam.map_store import MapConfig, cayley_to_hom_np  # noqa: E402
from multicol_slam_tpu.slam.system import WORKING, MultiColSLAM  # noqa: E402
from multicol_slam_tpu.utils.config import ExtractorSettings, SlamSettings  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=cs.SYS_FRAMES)
    n = ap.parse_args(argv).frames
    C, H, W = cs.C, cs.H, cs.W
    cams = OmniCamera.from_params([cs.POL] * C, [cs.INVPOL] * C, [[1.0, 0.0, 0.0]] * C, [[W / 2.0, H / 2.0]] * C,
                                  [[W, H]] * C)
    rig = MultiCamRig.from_cayley(cams, np.asarray(cs.MC_CAYLEY, np.float32))
    world = make_world(n_points=3000, n_frames=n, n_cams=C, n_feats=400, noise_px=0.0, trajectory="circle_noyaw",
                       radius=3.0, seed=12, period=400, landmarks="room", max_vis_dist=12.0, rig=rig)
    ex = ExtractorSettings(n_features=400, n_levels=8, scale_factor=1.2, fast_th=20, use_mdbrief=1, learn_masks=1)
    slam = MultiColSLAM(rig, SlamSettings(fps=25.0, extractor=ex),
                        MapConfig(max_keyframes=64, max_points=20000, n_cams=C, feats_per_cam=400, n_levels=8,
                                  scale_factor=1.2, desc_bytes=cs.B), async_mapping=False)
    t0 = time.perf_counter()
    frames = []
    for t in range(n):
        m = slam.track(images=np.asarray(render_frame(world, t)), timestamp=float(world.timestamps[t]))
        frames.append(m)
        print(f"frame {t:2d} state {m.state} inliers {m.n_inliers:4d} keyframe {int(m.is_keyframe)} "
              f"keyframes {int(slam.store.kf_valid.sum())} points {int(slam.store.pt_valid.sum())}", flush=True)
    working = [m for m in frames if m.state == WORKING]
    pos = lambda p: cayley_to_hom_np(np.asarray(p, np.float64))[..., :3, 3]  # noqa: E731
    est = pos(np.stack([m.pose for m in working]))
    gt = pos(np.asarray(world.poses)[[m.frame_id for m in working]])
    ate = float(np.sqrt(np.mean(np.sum((umeyama_align(est, gt) - gt) ** 2, -1))))
    out = dict(init_frame=working[0].frame_id if working else None, tracked=len(working),
               n_kf=int(slam.store.kf_valid.sum()), n_pt=int(slam.store.pt_valid.sum()), ate=ate,
               kf_frames=[m.frame_id for m in frames if m.is_keyframe],
               loops=slam.loop_closer.n_loops_closed if slam.loop_closer else 0,
               seconds=round(time.perf_counter() - t0, 1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
