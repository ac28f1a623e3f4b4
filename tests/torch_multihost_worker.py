"""One rank of the port's distributed bundle adjustment, for
tests/test_torch_multihost.py, tests/test_torch_parallel.py and
chip_smoke.py phase 18.

    python tests/torch_multihost_worker.py ADDRESS WORLD RANK JOB OUT
        [--device cpu|cuda] [--backend gloo|nccl] [--cases IN.npz]

Joins the process group at ADDRESS (host:port of rank 0), builds or loads
the job's problems, solves each with the layouts the job names and writes
OUT.rank<RANK>.npz: for case i and layout L, `i/L/poses`, `i/L/points`,
`i/L/cost` and `i/L/s` (seconds), and the case's `i/cost0`, `i/gt_poses`
where known. JOB is one job or several joined by commas, whose cases one
process group runs in turn. Jobs:
  large   make_large_ba_problem(8, 400, 4000, noise_px=0.2, seed=3) (the
          multihost test's problem), 10 LM iterations: `multihost` (padded,
          this rank's row shard, multihost_bundle_adjust), `points`
          (point_sharded_bundle_adjust) and, on rank 0, `single` (lm_solve);
  dryrun  the package's dry run (multicol_slam_tpu_torch.graft_entry.
          dryrun_multichip, the counterpart of __graft_entry__'s: 4 poses,
          32 points, 2 cameras, 256 rows, 2 LM / 4 CG iterations; it raises
          where the reference asserts): `rows` (distributed_bundle_adjust),
          `points` and `single`, and `i/s` the dry run's seconds;
  cases   the problems of --cases: `rows`, `points`, both or none, as each
          case's `i/layouts` says.
Imports torch and the port only (the card's machine has no JAX); each rank
runs torch on one intra-op thread. `run_ranks` starts the WORLD processes
and returns their outputs.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multicol_slam_tpu_torch.graft_entry import dryrun_multichip  # noqa: E402
from multicol_slam_tpu_torch.optim.lm import LMConfig, lm_solve  # noqa: E402
from multicol_slam_tpu_torch.optim.problem import BAParams, FreeMask, Observations  # noqa: E402
from multicol_slam_tpu_torch.parallel.ba import (  # noqa: E402
    distributed_bundle_adjust, make_mesh, pad_observations, point_sharded_bundle_adjust,
)
from multicol_slam_tpu_torch.parallel.distributed import (  # noqa: E402
    free_address, init_distributed, make_large_ba_problem, multihost_bundle_adjust, shard_rows_for_process,
)

PARAMS = ("poses", "points", "mc", "intr")
OBS = ("kf", "pt", "cam", "uv", "inv_sigma2", "valid")
LARGE = dict(n_kfs=8, n_points=400, n_obs=4000, noise_px=0.2, seed=3)
LARGE_CONFIG = LMConfig(max_iters=10, cg_iters=20)


def load_cases(path, device):
    """The cases of an npz: (params, obs, free, config, layouts) each."""
    data = np.load(path)
    cases = []
    for i in range(int(data["n"])):
        t = lambda k: torch.from_numpy(data[f"{i}/{k}"]).to(device)  # noqa: E731
        cfg = LMConfig(max_iters=int(data[f"{i}/max_iters"]), cg_iters=int(data[f"{i}/cg_iters"]))
        cases.append((BAParams(*(t(k) for k in PARAMS)), Observations(*(t(k) for k in OBS)),
                      FreeMask(t("free_poses"), t("free_points")), cfg,
                      [x for x in str(data[f"{i}/layouts"]).split(",") if x]))
    return cases


def run_ranks(world, job, out, device="cpu", backend=None, cases=None, timeout=300.0):
    """Run `job` in `world` rank processes of this script; each writes its
    log beside OUT. Waits at most `timeout` seconds, stops every rank once
    one fails, and raises with the failed rank's log. Returns the ranks'
    outputs (dicts of arrays), in rank order."""
    address = free_address()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, logs = [], []
    try:
        for r in range(world):
            cmd = [sys.executable, os.path.abspath(__file__), address, str(world), str(r), job, out,
                   "--device", device] + (["--backend", backend] if backend else []) + (
                       ["--cases", cases] if cases else [])
            logs.append(open(f"{out}.rank{r}.log", "w"))
            procs.append(subprocess.Popen(cmd, stdout=logs[-1], stderr=subprocess.STDOUT, env=env))
        t0 = time.perf_counter()
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.perf_counter() - t0 > timeout:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        with open(f"{out}.rank{bad[0]}.log") as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"{job}: ranks {bad} of {world} failed (exit codes "
                           f"{[p.returncode for p in procs]}); rank {bad[0]}'s log:\n{tail}")
    return [dict(np.load(f"{out}.rank{r}.npz")) for r in range(world)]


def solve(layout, params, obs, free, mesh, cfg):
    if layout == "rows":
        return distributed_bundle_adjust(params, obs, free, mesh, cfg)
    if layout == "points":
        return point_sharded_bundle_adjust(params, obs, free, mesh, cfg)
    if layout == "multihost":
        obs = pad_observations(obs, mesh.size)
        lo, hi = shard_rows_for_process(obs.kf.shape[0], mesh)
        return multihost_bundle_adjust(params, Observations(*(x[lo:hi] for x in obs)), free, mesh, cfg)
    return lm_solve(params, obs, free, cfg)                       # single


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("address")
    ap.add_argument("world", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("job", help="large, dryrun or cases, or several joined by commas (one group runs them in turn)")
    ap.add_argument("out")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--cases")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    init_distributed(args.address, args.world, args.rank, backend=args.backend, device=args.device)
    mesh = make_mesh(args.world, device=args.device)
    dev = mesh.device
    single = ["single"] if mesh.rank == 0 else []
    cases, extra = [], {}
    for job in args.job.split(","):
        i = len(cases)
        if job == "large":
            noisy, gt, obs, free = make_large_ba_problem(**LARGE, device=dev)
            cases.append((noisy, obs, free, LARGE_CONFIG, ["multihost", "points"] + single))
            extra[f"{i}/gt_poses"] = gt.poses.cpu().numpy()
        elif job == "dryrun":
            # the package's dry run (it asserts the reference's contract); its
            # solves are written out as a case's layouts
            t0 = time.perf_counter()
            dry = dryrun_multichip(args.world, device=dev)
            extra[f"{i}/cost0"] = dry["cost0"]
            for layout in ["rows", "points"] + single:
                p, cost = dry[layout]
                extra.update({f"{i}/{layout}/poses": p.poses.cpu().numpy(),
                              f"{i}/{layout}/points": p.points.cpu().numpy(), f"{i}/{layout}/cost": float(cost)})
            extra[f"{i}/s"] = time.perf_counter() - t0
            cases.append((None, None, None, None, []))
        else:
            cases += load_cases(args.cases, dev)
    out = dict(extra, n=len(cases), device=str(dev), backend=torch.distributed.get_backend())
    for i, (params, obs, free, cfg, layouts) in enumerate(cases):
        for layout in layouts:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, cost = solve(layout, params, obs, free, mesh, cfg)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out[f"{i}/{layout}/s"] = time.perf_counter() - t0
            out[f"{i}/{layout}/poses"] = p.poses.cpu().numpy()
            out[f"{i}/{layout}/points"] = p.points.cpu().numpy()
            out[f"{i}/{layout}/cost"] = float(cost)
    np.savez(f"{args.out}.rank{args.rank}.npz", **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
