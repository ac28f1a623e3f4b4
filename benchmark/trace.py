"""The device trace of a traced run: torch.profiler over a stretch of the
window, reduced to the device's busy time (the union of the intervals in
which an operation ran on the device), device time by operation name, and
the idle gaps labelled by the harness's host range ("bm.<call>") that
covers each gap's middle.

Host ranges are torch.profiler.record_function ranges the runners open
around their calls into the program; they cost nothing with the profiler
off.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch


def host_range(name: str):
    """A labelled host range in the trace (the label of idle gaps)."""
    return torch.profiler.record_function("bm." + name)


class DeviceTrace:
    """with DeviceTrace(on) as tr: ...; then tr.summary() (None when off)."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.t0 = self.t1 = 0.0

    def __enter__(self):
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def summary(self):
        if self.prof is None:
            return None
        kernels: List[Tuple[str, int, int]] = []
        ranges: List[Tuple[str, int, int]] = []
        for ev in self.prof.profiler.kineto_results.events():
            start, dur = ev.start_ns(), ev.duration_ns()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                # the device's copy of a host range is an annotation, no operation
                if not ev.is_user_annotation() and not ev.name().startswith("bm."):
                    kernels.append((ev.name(), start, start + dur))
            elif ev.name().startswith("bm."):
                ranges.append((ev.name()[3:], start, start + dur))
        return reduce(kernels, ranges, self.t1 - self.t0)


def reduce(kernels, ranges, window_s: float) -> dict:
    """busy_s, window_s, device seconds by name, and the breakdown."""
    by_name: Dict[str, float] = {}
    for name, a, b in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
    merged: List[List[int]] = []
    for _, a, b in sorted(kernels, key=lambda k: k[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-9
    gaps = []
    ranges = sorted(ranges, key=lambda r: r[1])
    for (_, e0), (s1, _) in zip(merged[:-1], merged[1:]):
        mid = (e0 + s1) // 2
        label = "other"
        for name, a, b in ranges:          # the innermost range that covers the middle
            if a <= mid <= b:
                label = name
        gaps.append((label, (s1 - e0) * 1e-9))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy,
        "window_s": window_s,
        "device_s_by_name": by_name,
        "n_device_ops": len(kernels),
        "breakdown": {"device_ops": [[n, s] for n, s in ops[:10]], "idle_gaps": [[n, s] for n, s in gaps[:10]]},
    }

