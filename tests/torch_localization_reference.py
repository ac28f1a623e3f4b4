"""The JAX package's result on chip_smoke.py's resume recipe (phase 16), on
the CPU: phase 13's dataset (the system phase's room world, 60 frames of
3 x 754x480, the reference's Lafida settings: 400 features, 8 levels,
FAST 20) written by `chip_smoke.write_cli_dataset`; the JAX CLI over it
with --sync-mapping --save-map MAP, then the JAX CLI with --load-map MAP
--localization --sync-mapping over the frames from `--start` on (the
settings' traj.StartFrame), which overlap the map's last keyframes: a
resumed map relocalizes against its last five keyframes only (no
vocabulary, an empty keyframe database).

    python tests/torch_localization_reference.py [--start FRAME] [--out DIR]

Prints the saved map's keyframe frames, then for the localization run the
first frame it relocalized on (counted from the run's first frame), the
frames tracked, the ATE of its MKFTrajectoryLAFIDA.txt (Sim3-aligned), the
keyframes and points before and after, and one JSON line. chip_smoke.py's
phase 16 gates the port on the card around these numbers (it holds them
as constants: the card's machine has no JAX). Takes ~5 min and ~3 GB on
the CPU.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from multicol_slam_tpu import cli as jcli  # noqa: E402
from multicol_slam_tpu.io.checkpoint import load_map  # noqa: E402
from multicol_slam_tpu.io.trajectory import ate_rmse, load_tum_trajectory  # noqa: E402
from multicol_slam_tpu.slam.map_store import cayley_to_hom_np  # noqa: E402
from multicol_slam_tpu_torch.eval import set_yaml_keys  # noqa: E402


def run_cli(args, run_dir):
    """The JAX CLI in run_dir (it writes MKFTrajectoryLAFIDA.txt there)."""
    os.makedirs(run_dir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        rc = jcli.main(args)
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"the JAX CLI exited with {rc}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--start", type=int, default=cs.LOC_START, help="the localization run's first frame (0-based)")
    ap.add_argument("--out", default=None, help="working directory (default: a new temporary one)")
    args = ap.parse_args(argv)
    out = args.out or tempfile.mkdtemp(prefix="loc_reference_")
    dataset = os.path.join(out, "dataset")
    t0 = time.perf_counter()
    cs.write_cli_dataset(dataset)
    world = cs.room_world()
    settings = os.path.join(dataset, "Slam_Settings_synthetic.yaml")
    map_path = os.path.join(out, "map.npz")
    run_cli(["no_voc.yml", settings, dataset, dataset, "--sync-mapping", "--save-map", map_path],
            os.path.join(out, "mapping"))
    store = load_map(map_path)
    kfs = store.active_kfs()
    n_kf, n_pt = len(kfs), int(store.pt_valid.sum())
    kf_frames = sorted(int(f) for f in store.kf_frame_id[kfs])
    print(f"saved map: {n_kf} keyframes on frames {kf_frames}, {n_pt} points", flush=True)

    loc_settings = os.path.join(out, "loc_settings.yaml")
    with open(settings) as f, open(loc_settings, "w") as g:
        g.write(f.read())
    set_yaml_keys(loc_settings, {"traj.StartFrame": args.start + 1})
    metrics = os.path.join(out, "loc_metrics.jsonl")
    run_dir = os.path.join(out, "localization")
    run_cli(["no_voc.yml", loc_settings, dataset, dataset, "--load-map", map_path, "--localization",
             "--sync-mapping", "--metrics", metrics], run_dir)
    with open(metrics) as f:
        rows = [json.loads(ln) for ln in f]
    frames, summary = rows[:-1], rows[-1]
    working = [r["frame"] for r in frames if r["state"] == 3]
    t_est, p_est = load_tum_trajectory(os.path.join(run_dir, "MKFTrajectoryLAFIDA.txt"))
    gt = cayley_to_hom_np(np.asarray(world.poses, np.float64))[:, :3, 3]
    ate = float(ate_rmse(t_est, p_est, world.timestamps, gt)) if len(t_est) >= 3 else float("inf")
    res = dict(start=args.start, n_frames=len(frames), first_reloc=working[0] if working else None,
               tracked=len(working), ate=ate, map_kf=n_kf, map_pt=n_pt, kf_frames=kf_frames,
               after_kf=summary["n_keyframes"], after_pt=summary["n_points"],
               seconds=round(time.perf_counter() - t0, 1))
    print(f"localization from frame {args.start}: {len(frames)} frames, first relocalized on run frame "
          f"{res['first_reloc']}, {len(working)} tracked, ATE {ate:.6f} m; keyframes / points {n_kf} / {n_pt} "
          f"before, {res['after_kf']} / {res['after_pt']} after")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
