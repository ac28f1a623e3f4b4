"""One cell with the program's tracer on: the per-layer numbers of the
port's own spans and counters (benchmark/spans.py).

    python3 -m benchmark.traced --workload NAME --seed N --seconds S [--out FILE] [--cpu]

The run is the harness's `--trace 1` run of the cell (`run.run_cell`), with
the tracer (multicol_slam_tpu_torch/utils/tracing.py) turned on at the
window's start and kept on through the traced frames or solve that follow
the window, under the profiler. For this process only, it wraps the
harness's window (`run.open_window` / `close_window`), its output check
(`run.judge`, for the end-to-end metrics) and its device trace
(`trace.DeviceTrace`, `trace.reduce`); `python3 -m benchmark.run` leaves
the tracer off. `--cpu` runs a cell cut to the CPU's size.

Prints one JSON line: the cell's end-to-end metrics and correctness, the
spans' metrics (host ones over the window, device ones over the traced
stretch), the per-frame split of `system.track_begin`, and the accounting:
a frame's children and self time against its span, the span's median
against the harness's `system.track_begin_ms`, and the idle time and
kernels found against the harness's own reduction. `--out` also gets
`idle_by_span` and `device_by_span`.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
from pathlib import Path

from benchmark import run as harness
from benchmark import spans as bs
from benchmark import trace as devtrace

CPU_SIZES = {
    "ba-large": {"config": {"problem": {"n_kfs": 6, "n_points": 600, "n_obs": 4000}}},
    "slam": {"traffic": {"warm_frames": 10, "check_frames": 2, "check_local_ba": 1, "trace_frames": 1}},
}


class Hooks:
    """The harness's hooks, wrapped to turn the tracer on and keep what it
    and the harness saw."""

    def __init__(self, tracing):
        self.tracing = tracing
        self.state = {}

    def install(self):
        st, tr = self.state, self.tracing
        open_window, close_window, judge = harness.open_window, harness.close_window, harness.judge
        reduce, enter, exit_ = devtrace.reduce, devtrace.DeviceTrace.__enter__, devtrace.DeviceTrace.__exit__
        summary = devtrace.DeviceTrace.summary

        def open_w(out):
            tr.clear()
            tr.enable()
            start = open_window(out)
            st["start_ns"] = int(start * 1e9)
            return start

        def close_w(out):
            close_window(out)
            st["window"] = tr.records()
            tr.clear()

        def judge_(outcome, limits):
            st["outcome"] = outcome
            return judge(outcome, limits)

        def reduce_(kernels, ranges, window_s):
            merged = []
            for _, a, b in sorted(kernels, key=lambda k: k[1]):
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            st["harness_gap_s"] = sum(s1 - e0 for (_, e0), (s1, _) in zip(merged[:-1], merged[1:])) * 1e-9
            st["harness_kernels"] = len(kernels)
            return reduce(kernels, ranges, window_s)

        def enter_(dt):
            tr.clear()
            return enter(dt)

        def exit__(dt, *exc):
            r = exit_(dt, *exc)
            st["traced"] = tr.records()
            tr.disable()
            return r

        def summary_(dt):
            if dt.prof is not None:
                st["by_span"] = bs.reduce_by_span(*bs.profile_events(dt.prof))
            return summary(dt)

        harness.open_window, harness.close_window, harness.judge = open_w, close_w, judge_
        devtrace.reduce = reduce_
        devtrace.DeviceTrace.__enter__, devtrace.DeviceTrace.__exit__ = enter_, exit__
        devtrace.DeviceTrace.summary = summary_


def frame_accounting(records) -> float | None:
    """The largest |self + direct children - the span| over the frames'
    `system.track_begin` spans, in ms."""
    kids = bs.children(records)
    errs = [abs(bs.self_ns(r, kids[r.id]) + sum(k.end - k.start for k in kids[r.id]) - (r.end - r.start)) * 1e-6
            for r in records if r.name == "system.track_begin"]
    return max(errs, default=None)


def run(workload: str, seed: int, seconds: float, cpu: bool = False) -> dict:
    """The traced run's result (see the module docstring); `full` holds
    the by-span tables."""
    from multicol_slam_tpu_torch.utils import tracing

    start_wall = harness.process_start_time()
    hooks = Hooks(tracing)
    hooks.install()
    try:
        if cpu:
            sizes = CPU_SIZES["ba-large" if workload == "ba-large" else "slam"]
            line = harness.run_cell(workload, seed, seconds, True, device="cpu", start_wall=start_wall,
                                    overrides=sizes)
        else:
            line = harness.run_cell(workload, seed, seconds, True, start_wall=start_wall)
    finally:
        tracing.disable()
        tracing.clear()
    st = hooks.state
    start = st["start_ns"]
    win = bs.window(st["window"], start, start + int(seconds * 1e9))
    rows = bs.frame_table(win)
    me = threading.get_native_id()       # the thread that ran the profiler
    traced = st.get("traced", [])
    k1 = bs.counters(traced, "k1", me)
    solves = bs.counters(traced, "lm.solve", me)
    by = st.get("by_span")
    metrics = bs.host_metrics(win, seconds)
    if by is not None and by["n_kernels"]:
        metrics.update(bs.device_metrics(by, k1, solves))
    tb = [r["track_begin_ms"] for r in rows]
    harness_tb = line["metrics"].get("system.track_begin_ms", {}).get("value")
    out = {
        "workload": workload, "seed": seed, "seconds": seconds, "correct": line["correct"],
        "card": line["device"]["kind"], "power_limit_w": line["device"]["power_limit_w"],
        "end_to_end": dict(st["outcome"].metrics),
        "harness_per_layer": {k: v["value"] for k, v in line["metrics"].items()},
        "metrics": {k: v for k, v in metrics.items() if v is not None},
        "frames": len(rows),
        "frame_median_ms": {k: statistics.median(r[k] for r in rows) for k in (rows[0] if rows else {})},
        "accounting": {
            "frame_max_err_ms": frame_accounting(win),
            "track_begin_median_ms": statistics.median(tb) if tb else None,
            "harness_track_begin_ms": harness_tb,
            "idle_s": by["idle_s"] if by else None, "harness_gap_s": st.get("harness_gap_s"),
            "kernels": by["n_kernels"] if by else None, "harness_kernels": st.get("harness_kernels"),
            "kernels_joined": by["joined"] if by else None,
        },
        "k1_launches_traced": len(k1), "solves_traced": solves,
        "host": line["host"], "checks": {k: v["value"] for k, v in line["checks"].items()},
    }
    out["full"] = {"idle_by_span": by["idle_by_span"] if by else {},
                   "device_by_span": by["device_by_span"] if by else {}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="a JSON file for the whole result, with the by-span tables")
    ap.add_argument("--cpu", action="store_true", help="run the cell on the CPU, cut to a small size")
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    res = run(args.workload, args.seed, args.seconds, args.cpu)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({k: v for k, v in res.items() if k != "full"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
