"""End-to-end accuracy evaluation of the port (port of the repository's
`eval.py`, which stays the JAX package's).

Renders a Lafida-layout synthetic dataset (fisheye images, the three YAML
schemas), runs the port's CLI on it as on Lafida (4 positional args,
MKFTrajectoryLAFIDA.txt), and scores the ATE RMSE against the ground truth
with `io/trajectory.ate_rmse` (Sim3-aligned). Prints ONE JSON line, e.g.

  {"metric": "synthetic_lafida_ate_rmse", "value": 0.0093, "unit": "m", ...}

    python3 -m multicol_slam_tpu_torch.eval [--frames N] [--out DIR] [--seed S]
                                            [--seeds N] [--async] [--mdbrief]
                                            [--real-calib [--calib-dir DIR]]

Modes:
  (default)     the synthetic rig, 600 landmarks, 200 features x 2 levels,
                the `line` trajectory, seed 7; --sync-mapping unless --async
  --seeds N     seeds seed..seed+N-1, the median ATE reported and gated on
  --mdbrief     mdBRIEF with learned stability masks (extractor.usemdBRIEF: 1,
                extractor.masks: 1): every matcher on the masked Hamming
                distance at x0.5 thresholds
  --real-calib  the Lafida calibration YAMLs (754x480) at the reference's
                400 features x 8 levels; prints a "skipped" line when the
                calibration directory is absent

The command line runs on the card; `main([...], device="cpu")` runs on the
CPU. --selfcal (ROADMAP.md, Queue 1 item 4) is not ported yet.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from multicol_slam_tpu_torch import cli
from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from multicol_slam_tpu_torch.io.render import write_dataset
from multicol_slam_tpu_torch.io.synthetic import make_world
from multicol_slam_tpu_torch.io.trajectory import ate_rmse, load_tum_trajectory
from multicol_slam_tpu_torch.utils.config import load_rig

# where the Lafida calibration YAMLs go when they are in the repository
LAFIDA_CALIB = str(Path(__file__).resolve().parent.parent / "Examples" / "Lafida")


def main(argv=None, device=DEFAULT_DEVICE) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    n_frames = 35
    out_dir = os.path.join(tempfile.gettempdir(), "mcslam_torch_eval")
    real_calib = False
    calib_dir = LAFIDA_CALIB
    use_async = False
    seed = 7
    n_seeds = 1
    mdbrief = False
    it = iter(argv)
    for a in it:
        if a == "--frames":
            n_frames = int(next(it))
        elif a == "--out":
            out_dir = next(it)
        elif a == "--real-calib":
            real_calib = True
        elif a == "--calib-dir":
            calib_dir = next(it)
        elif a == "--async":
            use_async = True
        elif a == "--seed":
            seed = int(next(it))
        elif a == "--seeds":
            n_seeds = int(next(it))
        elif a == "--mdbrief":
            mdbrief = True
        elif a == "--selfcal":
            raise NotImplementedError("--selfcal: the self-calibrating BA demo is not ported yet (ROADMAP.md, "
                                      "Queue 1 item 4)")
        else:
            raise SystemExit(f"unknown arg {a}")
    device = resolve_device(device)
    if real_calib:
        return _real_calib(n_frames if n_frames != 35 else 40, out_dir + "_real", calib_dir, device)
    if n_seeds > 1:
        # the reference's multi-run protocol ("SLAM is not deterministic",
        # Slam_Settings_indoor1.yaml:44-57 traj.trajrun): the median and
        # the worst over seeds, gated on the median
        vals, tracked = [], []
        for i in range(n_seeds):
            r = _synthetic(n_frames, f"{out_dir}_s{seed + i}", use_async, seed + i, device, mdbrief)
            vals.append(r["value"])
            tracked.append(r["frames_tracked"])
        result = {
            "metric": "synthetic_lafida_ate_rmse_multiseed" + ("_mdbrief" if mdbrief else ""),
            "value": round(float(np.median(vals)), 5),
            "unit": f"m (MEDIAN over {n_seeds} seeds, Sim3-aligned, full pixel pipeline)",
            "max": round(float(np.max(vals)), 5),
            "per_seed": [round(float(v), 5) for v in vals],
            "seeds": list(range(seed, seed + n_seeds)),
            "frames_tracked": tracked,
            "n_frames": n_frames,
            "platform": device.type,
            "pipeline": "async" if use_async else "sync",
        }
        print(json.dumps(result))
        return 0 if np.isfinite(result["value"]) else 1
    r = _synthetic(n_frames, out_dir, use_async, seed, device, mdbrief)
    print(json.dumps(r))
    return 0 if np.isfinite(r["value"]) else 1


def _run_cli(args, out_dir: str, device: torch.device):
    """cli.main in `out_dir` (it writes MKFTrajectoryLAFIDA.txt in the
    working directory). Returns the trajectory's path and the wall time."""
    cwd = os.getcwd()
    os.chdir(out_dir)
    t0 = time.perf_counter()
    try:
        rc = cli.main(args, device=device)
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"the CLI exited with {rc}")
    return os.path.join(out_dir, "MKFTrajectoryLAFIDA.txt"), time.perf_counter() - t0


def _synthetic(n_frames: int, out_dir: str, use_async: bool, seed: int, device: torch.device,
               mdbrief: bool = False) -> dict:
    """One synthetic-Lafida CLI run (full pixel pipeline) -> result dict.
    The sequential pipeline by default (deterministic); --async measures
    the CLI's default pipeline instead. `mdbrief` switches the extractor to
    mdBRIEF with learned stability masks."""
    world = make_world(n_points=600, n_frames=n_frames, n_cams=3, n_feats=200, noise_px=0.0,
                       trajectory="line", seed=seed)
    seq_dir = write_dataset(world, out_dir)
    if mdbrief:
        set_yaml_keys(os.path.join(seq_dir, "Slam_Settings_synthetic.yaml"),
                      {"extractor.usemdBRIEF": 1, "extractor.masks": 1})
    traj_path, wall = _run_cli(["no_voc.yml", os.path.join(seq_dir, "Slam_Settings_synthetic.yaml"), seq_dir,
                                seq_dir] + ([] if use_async else ["--sync-mapping"]), out_dir, device)
    est_t, est_xyz = load_tum_trajectory(traj_path)
    ate = ate_rmse(est_t, est_xyz, world.timestamps, world.poses[:, 3:6])
    return {
        "metric": "synthetic_lafida_ate_rmse" + ("_mdbrief" if mdbrief else ""),
        "value": round(float(ate), 5),
        "unit": f"m (Sim3-aligned, {len(est_t)}/{n_frames} frames tracked, full pixel pipeline)",
        "frames_tracked": int(len(est_t)),
        "n_frames": n_frames,
        "seed": seed,
        "wall_s": round(wall, 1),
        "platform": device.type,
        "pipeline": "async" if use_async else "sync",
        "descriptor": "mdBRIEF+masks" if mdbrief else "ORB",
    }


def set_yaml_keys(path: str, kv: dict) -> None:
    """Overwrite the `key: value` lines of an OpenCV-YAML settings file
    (appending the keys it lacks)."""
    with open(path) as f:
        lines = f.read().splitlines()
    done = set()
    for i, ln in enumerate(lines):
        for k, v in kv.items():
            if ln.startswith(k + ":"):
                lines[i] = f"{k}: {v}"
                done.add(k)
    lines += [f"{k}: {v}" for k, v in kv.items() if k not in done]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _real_calib(n_frames: int, out_dir: str, calib_dir: str, device: torch.device) -> int:
    """The synthetic indoor world rendered through the rig of the Lafida
    calibration YAMLs at 754x480, the CLI run with calib_dir pointing at
    those files (LoadMCS, cSystem.cpp:125-180), the ATE scored."""
    if not os.path.isdir(calib_dir):
        print(json.dumps({"metric": "real_calib_ate_rmse", "value": None, "unit": "m",
                          "skipped": "no reference calibration dir"}))
        return 0
    rig = load_rig(calib_dir, device="cpu")
    # period 400: walking speed at the 25 fps camera rate
    world = make_world(n_points=2400, n_frames=n_frames, n_cams=rig.n_cams, n_feats=400, noise_px=0.0,
                       trajectory="circle_noyaw", radius=3.0, seed=11, period=400, landmarks="room",
                       max_vis_dist=12.0, rig=rig)
    seq_dir = write_dataset(world, out_dir)
    # the reference's Lafida extractor load (Slam_Settings_indoor1.yaml:11-38)
    with open(os.path.join(seq_dir, "Slam_Settings_synthetic.yaml"), "w") as f:
        f.write(lafida_settings(n_frames))
    traj_path, wall = _run_cli(["no_voc.yml", os.path.join(seq_dir, "Slam_Settings_synthetic.yaml"), calib_dir,
                                seq_dir, "--sync-mapping"], out_dir, device)
    est_t, est_xyz = load_tum_trajectory(traj_path)
    ate = ate_rmse(est_t, est_xyz, world.timestamps, world.poses[:, 3:6])
    print(json.dumps({
        "metric": "real_calib_ate_rmse",
        "value": round(float(ate), 5),
        "unit": f"m (Sim3-aligned, {len(est_t)}/{n_frames} frames, Lafida 754x480 calibration, 400 feats x "
                f"8 levels, full pixel pipeline)",
        "frames_tracked": int(len(est_t)),
        "n_frames": n_frames,
        "wall_s": round(wall, 1),
        "platform": device.type,
    }))
    return 0 if np.isfinite(ate) else 1


def lafida_settings(n_frames: int) -> str:
    """A Slam_Settings file with the reference's Lafida extractor load: 400
    features, 8 levels, FAST 20, frames 1..n_frames."""
    return ("%YAML:1.0\n\nCamera.fps: 25.0\nCamera.RGB: 0\n"
            "extractor.usemdBRIEF: 0\nextractor.masks: 0\nextractor.useAgast: 0\n"
            "extractor.fastAgastType: 2\nextractor.descSize: 32\n"
            "extractor.nFeatures: 400\nextractor.scaleFactor: 1.2\n"
            "extractor.nLevels: 8\nextractor.fastTh: 20\n"
            "extractor.nScoreType: 0\nUseMotionModel: 1\n"
            f"traj.StartFrame: 1\ntraj.EndFrame: {n_frames + 1}\n")


if __name__ == "__main__":
    raise SystemExit(main())
