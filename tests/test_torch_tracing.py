"""The port's tracer (multicol_slam_tpu_torch/utils/tracing.py) and the
benchmark's reduction of its spans (benchmark/spans.py), on the CPU.

Off: the shared no-op span, nothing allocated or recorded, no profiler
range, and the tracking program's result bit-identical to the traced one.
On: the tracking program's span tree, the LM solve's iterations and
counters, the lock's waits, K1's launch counters on the plain path (P
computed when read), the records as JSON; then the per-frame, idle and
device reductions on synthetic spans and kernels, the rooflines from the
counters, an untraced benchmark run that leaves the tracer empty and a
traced run (benchmark/traced.py), each in a process of its own.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import tracemalloc
from pathlib import Path

import pytest
import torch

from benchmark import spans as bs
from multicol_slam_tpu_torch.io.synthetic import make_world
from multicol_slam_tpu_torch.ops import best_match
from multicol_slam_tpu_torch.optim.lm import LMConfig, lm_solve_interruptible
from multicol_slam_tpu_torch.parallel.distributed import make_large_ba_problem
from multicol_slam_tpu_torch.slam.tracking_kernels import LocalPoints, track_frame_fused
from multicol_slam_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def frame():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    world = make_world(n_points=300, n_frames=3, n_feats=100, seed=3)
    feats = world.frame_features(1, device="cpu")
    L = 256
    pts = LocalPoints(X=torch.as_tensor(world.points[:L], dtype=torch.float32),
                      desc=torch.as_tensor(world.descs[:L]), min_dist=torch.full((L,), 0.1),
                      max_dist=torch.full((L,), 30.0), valid=torch.ones(L, dtype=torch.bool))
    yield world, feats, pts
    torch.set_num_threads(threads)


def _track(frame):
    world, feats, pts = frame
    rig = world.rig
    pose = torch.as_tensor(world.poses[1], dtype=torch.float32) + 0.002
    return track_frame_fused(rig.Mc_cayley.to(torch.float32), rig.cams.to_vector(), rig.cams, feats, pose,
                             pts, pts, radius1=15.0, radius2=4.0)


def _raise(*a, **k):
    raise AssertionError("record_function entered")


def test_off_is_the_shared_noop_and_records_nothing(frame, monkeypatch):
    assert tracing.span("track.match") is tracing.NO_SPAN
    assert tracing.span("map.keyframe", "keyframe", 3, cpu=True) is tracing.NO_SPAN
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _track(frame)
    assert tracing.records() == []

    def spans(n):
        for _ in range(n):
            with tracing.span("track.pose"):
                pass
    spans(100)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        spans(2000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == tracing.__file__ and d.size_diff > 0]
    assert grown == []


def test_tracked_frame_is_bit_identical_on_and_off(frame):
    """On and off give the same result; on, under a profiler, each span is
    also a "mcs." range on the profiler's clock."""
    off = _track(frame)
    tracing.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = _track(frame)
    assert torch.equal(off, on)
    recs = tracing.records()
    kernels, ops, calls, notes = bs.profile_events(prof)
    assert kernels == [] and calls == {} and sorted(n[0] for n in notes) == sorted(r.name for r in recs)
    assert len(ops) > len(notes) and len({n[3] for n in notes}) == 1
    nested = bs.reduce_by_span(kernels, ops, calls, notes)
    assert nested["n_kernels"] == 0 and nested["idle_s"] == 0 and nested["device_by_span"] == {}


def test_fused_span_tree(frame):
    tracing.enable()
    with tracing.span("system.track_begin", "frame", 41):
        _track(frame)
    recs = tracing.records()
    by_id = {r.id: r for r in recs}
    (root,) = [r for r in recs if r.name == "system.track_begin"]
    (fused,) = [r for r in recs if r.name == "track.fused"]
    assert fused.parent == root.id
    for name in ("track.match", "track.pose"):
        kids = [r for r in recs if r.name == name]
        assert len(kids) == 2 and all(k.parent == fused.id for k in kids)
    k1 = [r for r in recs if r.name == "k1"]
    assert len(k1) == 2 and all(by_id[r.parent].name == "track.match" for r in k1)
    assert {r.request for r in recs} == {("frame", 41)}
    assert len({r.tid for r in recs}) == 1
    for r in recs:
        if r.parent:
            p = by_id[r.parent]
            assert p.start <= r.start <= r.end <= p.end


def test_lm_iterations_and_counters():
    params, _, obs, free = make_large_ba_problem(n_kfs=4, n_points=60, n_obs=500, device="cpu")
    conf = LMConfig(max_iters=3, cg_iters=4, gain_eps=0.0)
    tracing.enable()
    lm_solve_interruptible(params, obs, free, conf)
    lm_solve_interruptible(params, obs, free, conf)
    recs = tracing.records()
    solves = [r for r in recs if r.name == "lm.solve"]
    assert [r.request for r in solves] == [("solve", 1), ("solve", 2)]
    iters = [r for r in recs if r.name == "lm.iter"]
    assert len(iters) == 6 and len([r for r in recs if r.name == "lm.done_read"]) == 6
    # each iteration: 4 sums for the gradient and blocks, 2 per PCG step
    assert len([r for r in recs if r.name == "lm.segsum"]) == 2 * 3 * (4 + 2 * 4)
    assert solves[0].counts == dict(rows=obs.kf.shape[0], poses=4, points=60, iters=3, cg_steps=12)
    assert {r.request for r in iters} == {("solve", 1), ("solve", 2)}


def test_lock_records_contended_waits_only():
    lock = tracing.TracedLock()
    tracing.enable()
    with lock:
        pass
    assert lock.acquire() and not lock.acquire(False)
    lock.release()
    assert tracing.records() == []
    held, done = threading.Event(), threading.Event()

    def holder():
        with lock:
            held.set()
            time.sleep(0.05)
        done.set()
    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(5)
    with tracing.span("track.gather", "frame", 7):
        with lock:
            pass
    t.join(5)
    assert not t.is_alive() and done.is_set()
    (wait,) = [r for r in tracing.records() if r.name == "lock.wait"]
    assert wait.ms > 0 and wait.request == ("frame", 7)


@pytest.mark.parametrize("masked,shared", [(False, False), (True, True)])
def test_k1_counters_on_the_plain_path(masked, shared, monkeypatch):
    g = torch.Generator().manual_seed(2)
    C, Q, T, B = 2, 40, 70, 32

    def u8(*s):
        return torch.randint(0, 256, s, dtype=torch.uint8, generator=g)
    t_shape = (T, B) if shared else (C, T, B)
    args = (u8(C, Q, B), torch.rand(C, Q, 2, generator=g) * 100, torch.randint(0, 4, (C, Q), generator=g),
            u8(*t_shape), torch.rand(C, T, 2, generator=g) * 100, torch.rand(C, T, generator=g) * 30 - 5,
            torch.randint(0, 4, (C, T), generator=g).to(torch.float32))
    masks = dict(mask_q=u8(C, Q, B), mask_t=u8(*t_shape)) if masked else {}
    P = best_match.window_mask(args[1], args[2], args[4], args[5], args[6]).sum()
    calls = []
    window_mask = best_match.window_mask
    monkeypatch.setattr(best_match, "window_mask", lambda *a: calls.append(1) or window_mask(*a))
    off = best_match.masked_best_match_cams(*args, **masks)
    n_off = len(calls)           # the plain path's own
    tracing.enable()
    out = best_match.masked_best_match_cams(*args, **masks)
    (rec,) = tracing.records()
    assert len(calls) == 2 * n_off         # P is computed when the counters are read
    counts = rec.read_counts()
    assert rec.name == "k1" and {k: counts[k] for k in "CQTB"} == dict(C=C, Q=Q, T=T, B=B)
    assert counts["shared"] == int(shared) and counts["masked"] == int(masked)
    assert counts["P"] == int(P) > 0 and len(calls) == 2 * n_off + 1
    for a, b in zip(out, off):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- reductions
def _rec(id, name, start, end, parent=0, request=None, tid=1, cpu_ns=None, counts=None):
    r = tracing.Record(id, name, tid, parent, request)
    r.start, r.end, r.cpu_ns = start * 1_000_000, end * 1_000_000, cpu_ns
    r.counts = counts or {}
    return r


def _frame(base, fid, wait_ms):
    """One frame's spans in ms from `base`: track_begin 0-100 with the local
    map 5-15, the gather 20-30 (a lock wait inside), the fused program
    30-90 (match 30-40 with K1, pose 40-80; match 80-85, pose 85-90); then
    track_finish 150-160 with the read-back 150-152."""
    f = ("frame", fid)
    i = base * 100
    b = base
    recs = [_rec(i + 1, "system.track_begin", b, b + 100, request=f),
            _rec(i + 2, "track.local_map", b + 5, b + 15, i + 1, f),
            _rec(i + 3, "track.gather", b + 20, b + 30, i + 1, f),
            _rec(i + 5, "track.fused", b + 30, b + 90, i + 1, f),
            _rec(i + 6, "track.match", b + 30, b + 40, i + 5, f),
            _rec(i + 7, "k1", b + 32, b + 33, i + 6, f),
            _rec(i + 8, "track.pose", b + 40, b + 80, i + 5, f),
            _rec(i + 9, "track.match", b + 80, b + 85, i + 5, f),
            _rec(i + 10, "track.pose", b + 85, b + 90, i + 5, f),
            _rec(i + 11, "system.track_finish", b + 150, b + 160, request=f),
            _rec(i + 12, "track.readback", b + 150, b + 152, i + 11, f)]
    if wait_ms:
        recs.append(_rec(i + 4, "lock.wait", b + 21, b + 21 + wait_ms, i + 3, f))
    return recs


def test_frame_metrics_from_spans():
    recs = _frame(1000, 1, 0) + _frame(2000, 2, 4) + _frame(3000, 3, 6)
    recs += [_rec(9001, "map.keyframe", 1100, 1400, request=("keyframe", 5), tid=2, cpu_ns=150_000_000),
             _rec(9002, "loop.process", 1400, 1500, request=("keyframe", 5), tid=2, cpu_ns=50_000_000),
             _rec(9003, "lock.wait", 1410, 1420, 9002, ("keyframe", 5), tid=2)]
    m = bs.host_metrics(recs, window_s=4.0)
    assert m["system.track_begin_self_ms"] == pytest.approx(100 - 10 - 10 - 60)
    assert m["tracking.local_map_ms"] == pytest.approx(10)
    assert m["tracking.gather_ms"] == pytest.approx(10 - 4)
    assert m["tracking.match_dispatch_ms"] == pytest.approx(15)
    assert m["tracking.pose_dispatch_ms"] == pytest.approx(45)
    assert m["system.readback_wait_ms"] == pytest.approx(2)
    assert m["system.map_lock_wait_ms"] == pytest.approx(4)
    assert m["worker.cpu_share"] == pytest.approx(100 * 0.2 / 4.0)
    assert m["lm.iter_dispatch_ms"] is None
    rows = bs.frame_table(recs)
    for r in rows:         # the children and the self time make up the span
        assert r["self_ms"] + r["track.local_map"] + 10 + 60 == pytest.approx(r["track_begin_ms"])
    assert bs.host_metrics([], 1.0)["tracking.pose_dispatch_ms"] is None


def test_idle_and_device_by_span():
    """Kernels go to the range around their host op (or, launched outside
    any op, around their API call, on the thread its number maps to); idle
    gaps to the range over their middle; what no range covers to "other"."""
    ms = 1_000_000
    notes = [("system.track_begin", 0, 100 * ms, 1), ("track.fused", 10 * ms, 90 * ms, 1),
             ("k1", 20 * ms, 30 * ms, 1)]
    # op 103 ran on a thread without ranges (the mapping worker)
    ops = {101: (5 * ms, 1), 102: (25 * ms, 1), 103: (50 * ms, 2), 104: (95 * ms, 1)}
    # API calls: the tracker's are numbered 7, the worker's 8; kernel 3 (K1's
    # own launch) has no op, nor has kernel 7 (the worker's)
    calls = {1: (5 * ms, 7), 3: (27 * ms, 7), 4: (50 * ms, 8), 7: (152 * ms, 8)}
    kernels = [(a * ms, b * ms, corr, linked) for a, b, corr, linked in
               [(6, 8, 1, 101), (26, 29, 2, 102), (29, 30, 3, 0), (56, 58, 4, 103), (57, 96, 5, 104),
                (151, 152, 6, 0), (160, 161, 7, 999)]]
    out = bs.reduce_by_span(kernels, ops, calls, notes)
    dev, idle = out["device_by_span"], out["idle_by_span"]
    assert out["n_kernels"] == 7 and out["joined"] == {"op": 4, "call": 2}
    assert dev["k1"]["n"] == 2 and dev["k1"]["s"] == pytest.approx(0.004)
    assert dev["track.fused"]["incl_n"] == 2 and dev["track.fused"]["n"] == 0
    assert dev["system.track_begin"]["n"] == 2 and dev["system.track_begin"]["incl_n"] == 4
    assert dev["other"]["n"] == 3 and dev["other"]["s"] == pytest.approx(0.004)
    # gaps 8-26 and 30-56 (middles in track.fused), 96-151 and 152-160 (in none)
    assert idle["track.fused"]["n"] == 2 and idle["track.fused"]["s"] == pytest.approx(0.044)
    assert idle["system.track_begin"]["s"] == 0 and idle["system.track_begin"]["incl_s"] == pytest.approx(0.044)
    assert idle["other"]["n"] == 2 and idle["other"]["s"] == pytest.approx(0.063) and "k1" not in idle
    assert out["idle_s"] == pytest.approx(sum(v["s"] for v in idle.values()))
    assert out["busy_s"] + out["idle_s"] == pytest.approx(0.155)
    shares = bs.device_metrics(out, [dict(C=3, Q=400, T=4096, B=32, shared=1, masked=0, P=20000)],
                               [dict(rows=1000, poses=8, points=200, iters=10, cg_steps=200)])
    assert shares["device_idle.fused_program_share"] == pytest.approx(100 * 0.044 / 0.107)
    assert 0 < shares["k1.roofline_share"] < 100 and shares["lm.segsum_roofline_share"] is None


def test_records_as_json():
    """What `cli.py --profile` writes to spans.json: every record with its
    counters read."""
    tracing.enable()
    with tracing.span("lm.solve", "solve", 9) as sp:
        with tracing.span("lm.iter"):
            pass
        sp.count(rows=10, iters=torch.tensor(3), cg_steps=lambda: torch.tensor(60))
    recs = json.loads(json.dumps([r.as_dict() for r in tracing.records()]))
    it, solve = recs
    assert it["name"] == "lm.iter" and it["parent"] == solve["id"] and it["request"] == solve["request"]
    assert solve["request"] == ["solve", 9] and solve["counts"] == dict(rows=10, iters=3, cg_steps=60)
    assert solve["start_ns"] <= it["start_ns"] <= it["end_ns"] <= solve["end_ns"]
    assert it["tid"] == threading.get_native_id() and it["cpu_ns"] is None


def test_rooflines_from_counters():
    c = dict(C=3, Q=400, T=4096, B=32, shared=0, masked=0, P=15833)
    nbytes = (3 * 400 + 3 * 4096) * 32 + 28 * 1200 + 20 * 3 * 4096
    assert bs.k1_least_s(c) == pytest.approx(nbytes / bs.HBM_BYTES_S)
    dense = dict(c, P=3 * 400 * 4096 * 50)
    assert bs.k1_least_s(dense) == pytest.approx(16 * 32 * dense["P"] / bs.INT8_OPS_S)
    solve = dict(rows=500_000, poses=64, points=50_000, iters=10, cg_steps=200)
    per_iter = bs.seg_bytes(500_000, 42, 64) + bs.seg_bytes(500_000, 12, 50_000)
    per_cg = bs.seg_bytes(500_000, 6, 64) + bs.seg_bytes(500_000, 3, 50_000)
    assert bs.segsum_least_s(solve) == pytest.approx((10 * per_iter + 200 * per_cg) / 3.35e12)
    assert bs.roofline_share([], 1.0) is None and bs.roofline_share([1.0], 0.0) is None


def _python(args, timeout=300):
    """Run python in a process of its own from the repository's root (the
    harness sets its process's threads and environment on import)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


UNTRACED = """if True:
    import json
    from benchmark import run as harness
    from multicol_slam_tpu_torch.utils import tracing
    small = {"config": {"problem": {"n_kfs": 6, "n_points": 600, "n_obs": 4000}}}
    line = harness.run_cell("ba-large", 2 ** 31 + 77, 0.5, False, device="cpu", overrides=small)
    print(json.dumps(dict(keys=sorted(line), metrics=sorted(line["metrics"]), attempted=line["attempted"],
                          enabled=tracing.TRACER.enabled, records=len(tracing.records()))))
"""


def test_untraced_benchmark_run_leaves_the_tracer_empty():
    got = _python(["-c", UNTRACED])
    assert got["attempted"] >= 1 and "ba_lm_iters_per_s" in got["metrics"]
    assert not got["enabled"] and got["records"] == 0
    assert got["keys"] == ["attempted", "checks", "correct", "device", "errors", "failed", "host", "metrics"]


def test_traced_run_reads_the_ba_spans():
    """benchmark/traced.py on a small BA cell on the CPU: the window's LM
    iterations and the traced solve's counters (no device trace here)."""
    got = _python(["-m", "benchmark.traced", "--workload", "ba-large", "--seed", str(2 ** 31 + 78),
                   "--seconds", "0.5", "--cpu"])
    assert got["correct"] and got["end_to_end"]["ba_lm_iters_per_s"] > 0
    assert got["metrics"]["lm.iter_dispatch_ms"] > 0 and "lm.segsum_roofline_share" not in got["metrics"]
    assert got["solves_traced"] == [dict(rows=4000, poses=6, points=600, iters=10, cg_steps=200)]
    assert got["accounting"]["kernels"] == 0 and got["frames"] == 0
