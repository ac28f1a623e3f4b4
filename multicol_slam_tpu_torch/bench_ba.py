"""Benchmark of the port's bundle adjustment: LM iterations a second of the
large-map problem (BASELINE.md configuration 5), on one device and over the
ranks of a process group (port of the repository's `bench_ba.py`, which
stays the JAX package's).

The problem is `make_large_ba_problem`'s default (64 keyframes, 50k points,
500k rows), its rows sorted stably by point id (contiguous shards of a
sorted table stay sorted); 10 LM iterations of 20 PCG steps with gain_eps 0
(every iteration runs), the rig fixed. One warm solve, one timed, each
ended by a synchronize. Under a process group of n > 1 ranks (torchrun, one
card a rank) rank 0 also times `distributed_bundle_adjust` over the ranks
and reports its rate, the scaling efficiency and its final cost.

    python3 -m multicol_slam_tpu_torch.bench_ba            # the card
    torchrun --nproc-per-node N -m multicol_slam_tpu_torch.bench_ba
    python3 -m multicol_slam_tpu_torch.bench_ba --cpu8     # 8 gloo ranks on the CPU

Prints one JSON line {"metric": "ba_lm_iterations_per_s", "value", "unit",
"vs_baseline", "final_cost", "n_devices_visible", ...}; vs_baseline is the
rate over 75 (a 5 Hz local-BA cadence x 15 iterations, the load the
reference's mapping thread must carry on a laptop CPU). `--cpu8` is the
counterpart of the reference's virtual 8-device CPU mesh: 8 processes of
one thread each, joined by gloo. `n_devices_visible` is the world size (1
without a group): one device a process. Numbers are not rounded. The wall
seconds go to standard error.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch
import torch.distributed as dist

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from multicol_slam_tpu_torch.optim.lm import LMConfig, lm_solve
from multicol_slam_tpu_torch.parallel.ba import distributed_bundle_adjust, make_mesh
from multicol_slam_tpu_torch.parallel.distributed import free_address, init_distributed, make_large_ba_problem

PROBLEM = dict(n_kfs=64, n_points=50_000, n_obs=500_000)
N_LM, CG_ITERS = 10, 20
BASELINE_ITERS_PER_S = 75.0
CPU_RANKS = 8
# gain_eps=0: every one of the N_LM iterations runs (stable timing, no early out)
CONFIG = LMConfig(max_iters=N_LM, cg_iters=CG_ITERS, gain_eps=0.0)


def sorted_problem(n_kfs: int, n_points: int, n_obs: int, device=DEFAULT_DEVICE):
    """make_large_ba_problem(n_kfs, n_points, n_obs) drawn on the host, its
    rows sorted stably by point id, on `device`: (noisy, obs, free)."""
    device = resolve_device(device)
    noisy, _, obs, free = make_large_ba_problem(n_kfs=n_kfs, n_points=n_points, n_obs=n_obs, device="cpu")
    order = torch.argsort(obs.pt, stable=True)
    obs = type(obs)(*(c[order] for c in obs))
    return tuple(type(t)(*(x.to(device) if torch.is_tensor(x) else x for x in t)) for t in (noisy, obs, free))


def _timed(fn, device):
    """(fn(), seconds) between two synchronizations of `device`."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def warm_and_timed(solve, device):
    """solve() once to warm up, then once timed between synchronizations:
    ((params, cost) of the timed run, its seconds, whether it equals the
    warm run's bit for bit)."""
    warm, _ = _timed(solve, device)
    out, seconds = _timed(solve, device)
    same = all(torch.equal(a, b) for a, b in zip(out[0], warm[0])) and torch.equal(out[1], warm[1])
    return out, seconds, same


def bench(noisy, obs, free) -> dict:
    """The result line for one problem. Without a process group: the
    single-device solve. In a group of n > 1 ranks (every rank passes the
    whole problem): rank 0's single solve, then `distributed_bundle_adjust`
    over the ranks; every rank returns the line. Each solve is timed after
    a warm one."""
    device = noisy.poses.device
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    result = {}
    if rank == 0:
        (_, cost), dt1, _ = warm_and_timed(lambda: lm_solve(noisy, obs, free, CONFIG), device)
        iters1 = N_LM / dt1
        result = {
            "metric": "ba_lm_iterations_per_s",
            "value": iters1,
            "unit": f"LM iters/s ({int(noisy.poses.shape[0])} KFs, {int(noisy.points.shape[0]) // 1000}k pts, "
                    f"{int(obs.kf.shape[0]) // 1000}k obs, {CG_ITERS} CG/iter, 1 device)",
            "vs_baseline": iters1 / BASELINE_ITERS_PER_S,
            "final_cost": float(cost),
            "n_devices_visible": n_dev,
        }
    if n_dev > 1:
        mesh = make_mesh(n_dev, device=device)
        dist.barrier()
        (_, cost_d), dtn, _ = warm_and_timed(lambda: distributed_bundle_adjust(noisy, obs, free, mesh, CONFIG), device)
        sent = [result]
        dist.broadcast_object_list(sent, src=0)
        result = sent[0]
        itersn = N_LM / dtn
        result.update({
            "value_n_devices": itersn,
            "scaling_efficiency": itersn / (result["value"] * n_dev),
            "final_cost_n_devices": float(cost_d),
        })
    return result


def _rank(rank: int, world: int, address: str, problem: dict, results):
    """One rank of a group of `world` CPU processes on this host (spawned by
    `bench_over_ranks`), joined by gloo: one torch thread, the problem, the
    bench; rank 0 puts its line on `results`."""
    torch.set_num_threads(1)
    init_distributed(address, world, rank, backend="gloo", device="cpu")
    try:
        line = bench(*sorted_problem(**problem, device="cpu"))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        results.put(line)


def bench_over_ranks(world: int, problem: dict = PROBLEM) -> dict:
    """The bench over `world` spawned CPU processes of this host joined by
    gloo; rank 0's line."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    mp.spawn(_rank, args=(world, free_address(), problem, results), nprocs=world, join=True)
    return results.get()


def main(argv=None, device=DEFAULT_DEVICE) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv not in ([], ["--cpu8"]):
        raise SystemExit(f"unknown args {argv}")
    t0 = time.perf_counter()
    if argv == ["--cpu8"]:
        line = bench_over_ranks(CPU_RANKS)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:          # torchrun: one card a rank
        rank = int(os.environ["RANK"])
        init_distributed(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", int(os.environ["WORLD_SIZE"]),
                         rank, device=device)
        try:
            line = bench(*sorted_problem(**PROBLEM, device=make_mesh(device=device).device))
        finally:
            dist.destroy_process_group()
        if rank != 0:
            return 0
    else:
        line = bench(*sorted_problem(**PROBLEM, device=device))
    print(json.dumps(line), flush=True)
    print(f"bench_ba: wall seconds {time.perf_counter() - t0:.1f} (the problem's draw included)", file=sys.stderr,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
