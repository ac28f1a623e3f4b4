"""Whole-map bundle adjustments back to back, each from the same start.

Traffic parameters (benchmark/traffic/<name>.json):
  warm_solves   solves run in set-up (the first launches, the allocator,
                the solver libraries' handles)
  trace_solves  solves profiled right after the window in a traced run

Each solve is the program's LM (`optim.lm.lm_solve_interruptible`, one
iteration a chunk, as `lm_solve` runs it) with a host callback before each
iteration that stamps the time; the iteration before it has then finished
(the solve reads its `done` flag back after each iteration). An iteration
counts for ba_lm_iters_per_s when it finished inside the window. A solve
that raises or ends at a non-finite cost has failed.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import torch

from benchmark import baproblem, check
from benchmark.reference.geometry import Rig
from benchmark.trace import DeviceTrace, host_range


def run(ctx):
    from benchmark.run import Outcome, close_window, open_window
    from multicol_slam_tpu_torch.optim.lm import LMConfig, lm_solve_interruptible
    from multicol_slam_tpu_torch.optim.problem import BAParams, FreeMask, Observations

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    out = Outcome()
    rig = Rig(cfg["rig"], dev)
    prob = baproblem.draw(cfg, rig, ctx.seed, dev)
    lm = cfg["lm"]
    conf = LMConfig(max_iters=int(lm["max_iters"]), cg_iters=int(lm["cg_iters"]), huber_delta=float(lm["huber_delta"]),
                    init_lambda=float(lm["init_lambda"]), gain_eps=float(lm["gain_eps"]),
                    lambda_up=float(lm["lambda_up"]), lambda_down=float(lm["lambda_down"]))
    params = BAParams(prob.poses, prob.points, prob.mc, prob.intr)
    obs = Observations(prob.kf, prob.pt, prob.cam, prob.uv, torch.ones_like(prob.uv[:, 0]), prob.valid)
    free = FreeMask(poses=prob.free_poses, points=torch.ones(prob.points.shape[0], dtype=torch.bool, device=dev))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def solve(stamps):
        with host_range("lm_solve"):
            p, cost = lm_solve_interruptible(params, obs, free, conf, pre_step=lambda: stamps.append(time.perf_counter()))
        sync()
        stamps.append(time.perf_counter())
        return p, cost

    for _ in range(int(tr["warm_solves"])):
        solve([])
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    start = open_window(out)
    end = start + ctx.seconds
    out.metrics["setup_s"] = ctx.setup_s(start)
    results, iters = [], 0

    def one():
        nonlocal iters
        stamps = []
        out.attempted += 1
        try:
            p, cost = solve(stamps)
        except RuntimeError as e:          # a solve that raises has failed
            out.failed += 1
            out.errors.append(f"lm_solve: {e!r}")
            return
        iters += sum(1 for t in stamps[1:] if t <= end)
        if not math.isfinite(float(cost)):
            out.failed += 1
        results.append((p.poses.detach().clone(), p.points.detach().clone(), cost.detach().clone()))

    while time.perf_counter() < end:
        one()
    close_window(out)
    out.metrics["ba_lm_iters_per_s"] = iters / ctx.seconds
    if ctx.trace:                      # the traced solves follow the window
        with DeviceTrace(True) as dt:
            for _ in range(int(tr["trace_solves"])):
                solve([])
        out.trace = dt.summary()
    sync()
    if dev.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    print(f"ba_solves: {out.attempted} solves begun, {iters} LM iterations inside the window, "
          f"setup {out.metrics['setup_s']:.2f} s, host loop {out.host}", file=sys.stderr, flush=True)
    del params, obs, free
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out.compared = check.ba_solves(prob, lm, results, control=ctx.control)
    return out
