"""The program's own spans and counters (multicol_slam_tpu_torch/utils/
tracing.py), reduced to per-layer numbers.

Two kinds of input:
- the tracer's records over a window (`tracing.records()`): host spans on
  the perf_counter clock of every thread, grouped by request (a frame, a
  keyframe of the mapping worker, a bundle-adjustment solve);
- a torch.profiler run with the tracer on, in which the program's spans
  are "mcs." ranges of the thread that runs the profiler, on the
  profiler's clock: each kernel is joined, through the correlation id of
  the host op that launched it (or of its CUDA API call), to the innermost
  range open there (`device_by_span`), and each idle gap between kernels
  to the range over its middle (`idle_by_span`).

Rooflines (H100 SXM dense peaks: HBM 3.35 TB/s, int8 1,979 TOP/s) take the
work of a layer from the problem's shapes, not from the kernels that do it:
- K1 launch: bytes (C Q + n_t) B (x2 masked) + 28 C Q + 20 C T, with
  n_t = C T (T when the targets are shared by the cameras); operations
  16 B P (x2 masked), P the pairs inside the window and the level band;
  its least time max(bytes / HBM, ops / int8);
- segment sums of an LM iteration: S(O, 42, K) + S(O, 12, P) + cg (S(O, 6,
  K) + S(O, 3, P)) bytes, S(rows, w, n) = rows (4 w + 8) + 4 w n (each
  row's w floats and its int64 order read once, each segment's w floats
  written once); the rig fixed.

`benchmark/traced.py` runs a cell with the tracer on and prints these.
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1.979e15

FRAME_SPANS = ("track.local_map", "track.gather", "track.match", "track.pose", "track.readback", "lock.wait")


# ---------------------------------------------------------------- host spans
def by_request(records) -> Dict[tuple, list]:
    out: Dict[tuple, list] = defaultdict(list)
    for r in records:
        if r.request is not None:
            out[r.request].append(r)
    return out


def children(records) -> Dict[int, list]:
    out: Dict[int, list] = defaultdict(list)
    for r in records:
        out[r.parent].append(r)
    return out


def self_ns(rec, kids) -> int:
    """The span's duration less the union of its children's intervals."""
    covered, end = 0, rec.start
    for a, b in sorted((max(k.start, rec.start), min(k.end, rec.end)) for k in kids):
        if b <= end:
            continue
        covered += b - max(a, end)
        end = b
    return rec.end - rec.start - covered


def frame_table(records) -> List[dict]:
    """One row per frame that began (a `system.track_begin` record): its
    track_begin ms and self ms, and per span name of FRAME_SPANS its summed
    ms; `gather_ms` is track.gather less its lock.wait children."""
    kids = children(records)
    rows = []
    for (kind, _), recs in by_request(records).items():
        begin = [r for r in recs if r.name == "system.track_begin"]
        if kind != "frame" or not begin:
            continue
        row = {"track_begin_ms": sum(r.ms for r in begin),
               "self_ms": sum(self_ns(r, kids[r.id]) for r in begin) * 1e-6}
        for name in FRAME_SPANS:
            row[name] = sum(r.ms for r in recs if r.name == name)
        row["gather_ms"] = sum(r.ms - sum(k.ms for k in kids[r.id] if k.name == "lock.wait")
                               for r in recs if r.name == "track.gather")
        rows.append(row)
    return rows


def _median(values) -> Optional[float]:
    values = list(values)
    return statistics.median(values) if values else None


def host_metrics(records, window_s: float) -> Dict[str, float]:
    """The host-clock metrics of a window's records (None: nothing to read)."""
    rows = frame_table(records)
    out = {
        "system.track_begin_self_ms": _median(r["self_ms"] for r in rows),
        "tracking.local_map_ms": _median(r["track.local_map"] for r in rows),
        "tracking.gather_ms": _median(r["gather_ms"] for r in rows),
        "tracking.match_dispatch_ms": _median(r["track.match"] for r in rows),
        "tracking.pose_dispatch_ms": _median(r["track.pose"] for r in rows),
        "system.readback_wait_ms": _median(r["track.readback"] for r in rows),
        "system.map_lock_wait_ms": _median(r["lock.wait"] for r in rows),
        "lm.iter_dispatch_ms": _median(r.ms for r in records if r.name == "lm.iter"),
    }
    cpu = [r.cpu_ns for r in records if r.name in ("map.keyframe", "loop.process") and r.cpu_ns is not None]
    out["worker.cpu_share"] = 100.0 * sum(cpu) * 1e-9 / window_s if cpu and window_s > 0 else None
    return out


# ---------------------------------------------------------------- rooflines
def k1_least_s(c: dict) -> float:
    """The least time of one K1 launch from its counters."""
    C, Q, T, B = int(c["C"]), int(c["Q"]), int(c["T"]), int(c["B"])
    m = 2 if int(c["masked"]) else 1
    n_t = T if int(c["shared"]) else C * T
    nbytes = (C * Q + n_t) * B * m + 28 * C * Q + 20 * C * T
    ops = 16 * B * int(c["P"]) * m
    return max(nbytes / HBM_BYTES_S, ops / INT8_OPS_S)


def seg_bytes(rows: int, w: int, n: int) -> int:
    return rows * (4 * w + 8) + 4 * w * n


def segsum_least_s(c: dict) -> float:
    """The least time of a solve's segment sums from its counters."""
    O, K, P = int(c["rows"]), int(c["poses"]), int(c["points"])
    per_iter = seg_bytes(O, 42, K) + seg_bytes(O, 12, P)
    per_cg = seg_bytes(O, 6, K) + seg_bytes(O, 3, P)
    return (int(c["iters"]) * per_iter + int(c["cg_steps"]) * per_cg) / HBM_BYTES_S


def roofline_share(least_s: Iterable[float], device_s: float) -> Optional[float]:
    least = sum(least_s)
    return 100.0 * least / device_s if device_s > 0 and least > 0 else None


# ---------------------------------------------------------------- the profile
def profile_events(prof):
    """The events of a finished torch.profiler run that the reduction needs,
    on the profiler's clock: kernels [(start, end, corr, linked)] (device
    copies of host ranges are annotations, not operations; `corr` is the
    kernel's correlation id, `linked` that of the host op that launched
    it), the host ops {correlation id: (start, tid)}, the CUDA API calls
    ("cu..." names) {correlation id: (start, tid)} and the "mcs." ranges
    [(name, start, end, tid)]."""
    import torch

    kernels, ops, calls, notes = [], {}, {}, []
    for ev in prof.profiler.kineto_results.events():
        name, start = ev.name(), ev.start_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation() and not name.startswith(("mcs.", "bm.")):
                kernels.append((start, start + ev.duration_ns(), ev.correlation_id(), ev.linked_correlation_id()))
        elif name.startswith("cu"):
            calls[ev.correlation_id()] = (start, ev.start_thread_id())
        else:
            if ev.correlation_id():
                ops[ev.correlation_id()] = (start, ev.start_thread_id())
            if name.startswith("mcs."):
                notes.append((name[4:], start, start + ev.duration_ns(), ev.start_thread_id()))
    return kernels, ops, calls, notes


class _Range:
    __slots__ = ("id", "name", "parent", "start", "end")

    def __init__(self, id, name, parent, start, end):
        self.id, self.name, self.parent, self.start, self.end = id, name, parent, start, end


def _nest(notes) -> Dict[int, list]:
    """The profiler's ranges with parents, by thread (ranges of one thread
    nest)."""
    out: Dict[int, list] = defaultdict(list)
    stacks: Dict[int, list] = defaultdict(list)
    for n, (name, a, b, tid) in enumerate(sorted(notes, key=lambda x: (x[3], x[1], -x[2])), 1):
        stack = stacks[tid]
        while stack and stack[-1].end < a:
            stack.pop()
        span = _Range(n, name, stack[-1].id if stack else 0, a, b)
        stack.append(span)
        out[tid].append(span)
    return out


def _owners(spans, queries) -> Dict[object, tuple]:
    """For each query (t, key), the innermost of one thread's ranges that
    covers t, as (start, range)."""
    out, stack, j = {}, [], 0
    spans = sorted(spans, key=lambda x: (x.start, -x.end))
    for t, key in sorted(queries, key=lambda q: q[0]):
        while j < len(spans) and spans[j].start <= t:
            while stack and stack[-1].end < spans[j].start:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1].end < t:
            stack.pop()
        if stack:
            out[key] = (stack[-1].start, stack[-1])
    return out


def reduce_by_span(kernels, ops, calls, notes) -> dict:
    """device_by_span and idle_by_span of a profile (`profile_events`).

    A kernel belongs to the innermost "mcs." range around the host op that
    launched it, on that op's thread. A kernel launched outside any host op
    (K1, through its C entry point) is placed at its CUDA API call instead,
    on the thread of the host ops whose kernels' calls carry the same
    thread number (the profiler numbers the calls' threads apart from the
    ops'). An idle gap between kernels belongs
    to the innermost range over the gap's middle (the rule of the harness's
    "bm." labels, benchmark/trace.py). Each name gets its own time ("s";
    "n": kernels or gaps) and that of the ranges inside it ("incl_s",
    "incl_n"); "other" takes what no range covers, among it the kernels
    of threads the profiler records no ranges of (the mapping worker)."""
    ranges = _nest(notes)
    by_id = {r.id: r for v in ranges.values() for r in v}
    thread_of_call: Dict[int, int] = {}
    for _, _, corr, linked in kernels:
        if linked in ops and corr in calls:
            thread_of_call.setdefault(calls[corr][1], ops[linked][1])
    queries: Dict[int, list] = defaultdict(list)
    joined = {"op": 0, "call": 0}
    for i, (_, _, corr, linked) in enumerate(kernels):
        at = ops.get(linked)
        if at is not None:
            joined["op"] += 1
        elif corr in calls and calls[corr][1] in thread_of_call:
            at = (calls[corr][0], thread_of_call[calls[corr][1]])
            joined["call"] += 1
        if at is not None and at[1] in ranges:
            queries[at[1]].append((at[0], ("k", i)))
    gaps, end = [], None
    for a, b, *_ in sorted(kernels):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    for g, (a, b) in enumerate(gaps):
        for tid in ranges:
            queries[tid].append(((a + b) // 2, ("g", g)))
    found: Dict[tuple, tuple] = {}
    for tid, qs in queries.items():
        for key, hit in _owners(ranges[tid], qs).items():
            if key not in found or hit[0] > found[key][0]:
                found[key] = hit

    def add(table, key, s):
        hit = found.get(key)
        names, span = [], hit[1] if hit is not None else None
        while span is not None:
            names.append(span.name)
            span = by_id.get(span.parent)
        for n, name in enumerate(names or ["other"]):
            row = table.setdefault(name, {"s": 0.0, "n": 0, "incl_s": 0.0, "incl_n": 0})
            if n == 0:
                row["s"] += s
                row["n"] += 1
            row["incl_s"] += s
            row["incl_n"] += 1

    device: Dict[str, dict] = {}
    for i, (a, b, *_) in enumerate(kernels):
        add(device, ("k", i), (b - a) * 1e-9)
    idle: Dict[str, dict] = {}
    for g, (a, b) in enumerate(gaps):
        add(idle, ("g", g), (b - a) * 1e-9)
    span_ns = (end - min(k[0] for k in kernels)) if kernels else 0
    idle_ns = sum(b - a for a, b in gaps)
    return {"device_by_span": device, "idle_by_span": idle, "busy_s": (span_ns - idle_ns) * 1e-9,
            "idle_s": idle_ns * 1e-9, "n_kernels": len(kernels), "joined": joined}


def device_metrics(by_span: dict, launches_k1: List[dict], solves: List[dict]) -> Dict[str, Optional[float]]:
    """The device-trace metrics of a traced stretch: the share of its idle
    time inside track.fused, and the two rooflines (the counters of its K1
    launches and of its solves, against the device seconds launched under
    the `k1` and `lm.segsum` spans)."""
    idle, dev = by_span["idle_by_span"], by_span["device_by_span"]
    total_idle = sum(v["s"] for v in idle.values())
    fused = idle.get("track.fused", {}).get("incl_s", 0.0)
    return {
        "device_idle.fused_program_share": 100.0 * fused / total_idle if total_idle > 0 and "track.fused" in dev
        else None,
        "k1.roofline_share": roofline_share((k1_least_s(c) for c in launches_k1),
                                            dev.get("k1", {}).get("incl_s", 0.0)),
        "lm.segsum_roofline_share": roofline_share((segsum_least_s(c) for c in solves),
                                                   dev.get("lm.segsum", {}).get("incl_s", 0.0)),
    }


def counters(records, name: str, tid: Optional[int] = None) -> List[dict]:
    """The counters of every record of `name` (of thread `tid` only, when
    given), read as plain numbers."""
    return [r.read_counts() for r in records if r.name == name and r.counts and (tid is None or r.tid == tid)]


def window(records, start_ns: int, end_ns: int) -> list:
    """The records that began inside [start_ns, end_ns)."""
    return [r for r in records if start_ns <= r.start < end_ns]
