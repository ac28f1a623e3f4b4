"""The port's async mapping worker (`MultiColSLAM(async_mapping=True)`): the
pipeline against the port's own sync run, the tracker-priority gate, the
worker's decisions against the JAX package's `LocalMapper.run`, the lock
discipline, and the locks around the kernel library and its counts.

- tests/test_loop_reloc.py's `test_async_mapping_pipeline`, mirrored: 40
  frames of the `line` world (2 cameras, 250 oracle features), sync then
  async. Async runs are not deterministic (the worker's timing moves which
  frames insert keyframes), so the gates are the reference's counts: >= 35
  frames tracked, >= 2 keyframes, more than 0.3 x the sync run's points,
  and no error on the worker.
- The credit gate: +2 a finished frame up to 6, one spent a launch, a
  bounded 0.2 s wait without credit and 0.05 s while a frame is in flight,
  a no-op on the tracker's own thread.
- `LocalMapper.run` under a scripted `interrupt` takes the fuse / BA /
  forced-BA decisions JAX's takes, from one JAX `MapStore` snapshot (the
  stages stubbed: only the decisions and the bookkeeping are compared).
- A recording lock: every store mutation of the mapper and of CorrectLoop's
  commits happens with the lock held, and every device phase (the
  triangulation, the K1 fusion and loop projections, the BA solve,
  `_eg_solve`) and every yield with it released.
"""
import copy
import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from multicol_slam_tpu.io.synthetic import make_world as jmake_world
from multicol_slam_tpu.slam import local_mapping as jlm
from multicol_slam_tpu.slam.map_store import MapConfig as JMapConfig
from multicol_slam_tpu.slam.system import MultiColSLAM as JSLAM
from multicol_slam_tpu.utils.config import ExtractorSettings as JExtractor
from multicol_slam_tpu.utils.config import SlamSettings as JSettings
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.io.synthetic import make_world
from multicol_slam_tpu_torch.ops import cuda_lib
from multicol_slam_tpu_torch.slam import local_mapping as tlm
from multicol_slam_tpu_torch.slam import loop_closing as tlc
from multicol_slam_tpu_torch.slam.map_store import MapConfig
from multicol_slam_tpu_torch.slam.system import NOT_INITIALIZED, WORKING, MultiColSLAM
from multicol_slam_tpu_torch.utils.config import ExtractorSettings, SlamSettings

N_FEATS, N_FRAMES = 250, 40
WORLD = dict(n_points=500, n_frames=N_FRAMES, n_cams=2, n_feats=N_FEATS, noise_px=0.2, trajectory="line", seed=4)
MAP = dict(max_keyframes=64, max_points=8000, n_cams=2, feats_per_cam=N_FEATS, n_levels=1, scale_factor=1.2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the system's ops are small, and the tier-1 run
    puts six test processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings():
    return SlamSettings(fps=25.0, extractor=ExtractorSettings(n_features=N_FEATS, n_levels=1, scale_factor=1.2))


@pytest.fixture(scope="module")
def world():
    return make_world(**WORLD)


def _run(world, async_mapping, n=N_FRAMES):
    slam = MultiColSLAM(world.rig, _settings(), MapConfig(**MAP), use_loop_closing=False,
                        async_mapping=async_mapping, device="cpu")
    for t in range(n):
        slam.track(feats=world.frame_features(t, device="cpu"), timestamp=world.timestamps[t])
    slam.wait_mapping_idle()
    slam.shutdown()
    return slam


@pytest.fixture(scope="module")
def sync_run(world):
    return _run(world, False)


def test_async_mapping_pipeline(world, sync_run):
    a = _run(world, True)
    working = sum(m.state == WORKING for m in a.trajectory)
    pt_sync, pt_async = int(sync_run.store.pt_valid.sum()), int(a.store.pt_valid.sum())
    assert working >= 35, f"async tracking lost frames: {working}"
    assert int(a.store.kf_valid.sum()) >= 2
    assert pt_async > 0.3 * pt_sync, (pt_async, pt_sync)
    assert a.worker_errors == []
    assert sum(m.state == WORKING for m in sync_run.trajectory) >= 35


# ---------------------------------------------------------------- the gate
def _idle_frame(slam):
    """One frame through begin/finish that ends inside begin (too few
    features to start): the cheapest finished frame."""
    C = slam.rig.n_cams
    f = convert.frame_features_from_numpy(
        np.zeros((C, 4, 2)), np.zeros((C, 4)), np.zeros((C, 4)), np.zeros((C, 4)), np.zeros((C, 4, 3)),
        np.zeros((C, 4, 32)), np.zeros((C, 4, 32)), np.zeros((C, 4), bool), device="cpu")
    return slam.track_finish(slam.track_begin(feats=f))


@pytest.fixture()
def async_slam(world):
    slam = MultiColSLAM(world.rig, _settings(), MapConfig(**MAP), use_loop_closing=False, async_mapping=True,
                        device="cpu")
    yield slam
    slam.shutdown()


def test_credits(async_slam):
    """+2 credits a finished frame, at most 6 banked; each yield spends one;
    without credit a yield waits 0.2 s at most."""
    s = async_slam
    assert s._budget == 0
    _idle_frame(s)
    assert s._budget == 2
    for _ in range(3):
        _idle_frame(s)
    assert s._budget == 6
    spent, waited = [], []

    def worker():
        for _ in range(7):
            t0 = time.perf_counter()
            s._yield_to_tracker()
            waited.append(time.perf_counter() - t0)
            spent.append(s._budget)
    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive() and spent == [5, 4, 3, 2, 1, 0, 0]
    assert max(waited[:6]) < 0.1 and 0.15 < waited[6] < 1.0


def test_yield_is_a_noop_on_the_tracker(async_slam):
    s = async_slam
    _idle_frame(s)                                  # the tracker's thread is now known
    assert s._tracker_tid == threading.get_ident()
    s._frame_idle.clear()                           # as inside a frame
    t0 = time.perf_counter()
    s._yield_to_tracker()
    assert time.perf_counter() - t0 < 0.01 and s._budget == 2
    # from the worker's side, the same call waits for the frame (0.05 s at most)
    th = threading.Thread(target=s._yield_to_tracker)
    t0 = time.perf_counter()
    th.start()
    th.join(timeout=10)
    assert not th.is_alive() and 0.04 < time.perf_counter() - t0 < 1.0 and s._budget == 1
    s._frame_idle.set()


def test_generators_and_wiring(world, async_slam):
    """One generator a thread in async mode (the loop closer's own), the
    system's one shared in sync mode; reset drains the queue, re-wires the
    gate and the lock, and drops a frame in flight across it."""
    sync = MultiColSLAM(world.rig, _settings(), MapConfig(**MAP), device="cpu")
    assert sync.loop_closer.generator is sync.generator and sync.mapper.yield_gate is None
    s = MultiColSLAM(world.rig, _settings(), MapConfig(**MAP), async_mapping=True, device="cpu")
    try:
        assert s.loop_closer.generator is not s.generator
        assert s.loop_closer.lock is s.map_lock is s.mapper.lock
        f = world.frame_features(0, device="cpu")
        h = s.track_begin(feats=f)
        s.reset()
        assert s.mapper.yield_gate == s._yield_to_tracker and s.loop_closer.yield_gate == s._yield_to_tracker
        assert s.mapper.lock is s.map_lock and s.loop_closer.generator is not s.generator
        m = s.track_finish(h)
        assert m.state == NOT_INITIALIZED and s.state == NOT_INITIALIZED and s._epoch == 1
    finally:
        s.shutdown()


def test_worker_errors_are_kept(async_slam, capsys):
    """An exception on the worker is printed and kept, and the worker goes
    on with the next keyframe."""
    s = async_slam
    calls = []

    def failing_run(k, **kw):
        calls.append(k)
        raise ValueError(f"keyframe {k}")
    s.mapper.run = failing_run
    s._kf_queue.put(3)
    s._kf_queue.put(4)
    s.wait_mapping_idle()
    assert calls == [3, 4] and [str(e) for e in s.worker_errors] == ["keyframe 3", "keyframe 4"]
    assert "ValueError: keyframe 3" in capsys.readouterr().err


# ---------------------------------------------------- decisions against JAX
@pytest.fixture(scope="module")
def jax_snapshot():
    """(store, recent_points, k) of a JAX sync run on the same world right
    before its first keyframe's mapping pass."""
    world = jmake_world(**WORLD)
    slam = JSLAM(world.rig, JSettings(fps=25.0, extractor=JExtractor(n_features=N_FEATS, n_levels=1)),
                 JMapConfig(**MAP), use_loop_closing=False)
    snaps = {}
    run = slam.mapper.run

    def run_snap(k, do_ba=True, **kw):
        if do_ba:
            snaps.setdefault("kf", (copy.deepcopy(slam.store), list(slam.mapper.recent_points), k))
        return run(k, do_ba=do_ba, **kw)
    slam.mapper.run = run_snap
    for t in range(N_FRAMES):
        slam.track(feats=world.frame_features(t), timestamp=world.timestamps[t])
        if snaps:
            break
    assert snaps, "the run must reach its first keyframe"
    return world, snaps["kf"]


def _arrays(store):
    return {k: v for k, v in vars(store).items() if k.startswith(("kf_", "pt_")) and isinstance(v, np.ndarray)}


def _port_rig(jrig):
    c = jrig.cams
    return convert.rig_from_numpy(*(np.asarray(getattr(c, k)) for k in ("pol", "invpol", "cde", "pp", "wh")),
                                  np.asarray(jrig.Mc_cayley), device="cpu")


# (interrupt before fusion, interrupt before BA) of each pass: three
# deferrals, then a forced BA, then every other combination
SCRIPT = [(True, True), (True, True), (True, True), (True, True), (False, False), (False, True), (True, False),
          (False, True), (True, True)]


def test_run_decisions_match_jax(jax_snapshot):
    world, (store, recent, k) = jax_snapshot
    js = copy.deepcopy(store)
    ts = convert.map_store_from_numpy(dataclasses.asdict(js.cfg), _arrays(js), js.n_kf, js.n_pt_alloc,
                                      js._free_kf, js._free_pt)
    jm, tm = jlm.LocalMapper(js, world.rig), tlm.LocalMapper(ts, _port_rig(world.rig))
    decisions = {}
    for name, m in (("jax", jm), ("port", tm)):
        m.recent_points = list(recent)
        log = []
        m.create_new_points = lambda k, *a, **kw: 0
        m.fuse_neighbors = lambda k, *a, log=log, **kw: log.append("fuse")
        m.local_ba = lambda k, *a, log=log, **kw: log.append("ba")
        m.cull_keyframes = lambda k, *a, log=log, **kw: log.append("cull")
        out = []
        for first, second in SCRIPT:
            answers = iter((first, second))
            log.clear()
            m.run(k, interrupt=lambda: next(answers))
            out.append((tuple(log), m._ba_deferred))
        decisions[name] = out
    assert decisions["port"] == decisions["jax"]
    assert decisions["port"][3] == (("ba", "cull"), 0)       # the forced BA after three deferrals
    for name in ("kf_parent", "pt_valid", "kf_point", "pt_desc"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name), err_msg=name)
    assert tm.recent_points == jm.recent_points


# ------------------------------------------------------------ lock discipline
class RecordingLock:
    def __init__(self):
        self.held = False
        self.entries = 0

    def __enter__(self):
        assert not self.held, "the map lock is not reentrant"
        self.held = True
        self.entries += 1

    def __exit__(self, *a):
        self.held = False


MUTATIONS = ("add_point", "add_observation", "erase_point", "replace_point", "erase_observation", "write_back",
             "update_point_stats_many", "erase_keyframe", "assign_parent")


def _watch(lock, owner, names, held, seen):
    """Wrap owner's methods (or a module's functions) to check the lock's
    state when they run."""
    for name in names:
        fn = getattr(owner, name)

        def wrapped(*a, fn=fn, name=name, **kw):
            assert lock.held == held, f"{name} ran with the lock {'released' if held else 'held'}"
            seen.add(name)
            return fn(*a, **kw)
        setattr(owner, name, wrapped)


def test_mapper_lock_discipline(world, sync_run, monkeypatch):
    """LocalMapper.run with a yield gate (the worker's bounded launches): the
    store's mutations under the lock; triangulation, fusion and the BA
    solve, and every yield, outside it."""
    s = copy.deepcopy(sync_run.store)
    k = int(s.active_kfs()[-1])
    lock = RecordingLock()
    mapper = tlm.LocalMapper(s, world.rig, lock=lock)
    seen = set()
    _watch(lock, s, MUTATIONS, True, seen)
    for name in ("triangulate_pairs", "fuse_match", "bundle_adjust_interruptible"):
        monkeypatch.setattr(tlm, name, getattr(tlm, name))
    _watch(lock, tlm, ("triangulate_pairs", "fuse_match", "bundle_adjust_interruptible"), False, seen)
    yields = []
    mapper.yield_gate = lambda: yields.append(lock.held)
    mapper.run(k)
    assert {"triangulate_pairs", "fuse_match", "bundle_adjust_interruptible", "write_back",
            "update_point_stats_many"} <= seen, seen
    assert yields and not any(yields)
    assert lock.entries >= 5 and not lock.held


def test_correct_loop_lock_discipline(world, sync_run):
    """CorrectLoop (with a small Sim3 correction between the newest and the
    oldest keyframe): its commits under the lock, each recorded in
    locked_phase_ms; the SearchAndFuse projections and _eg_solve outside
    it, while loop_correcting is set."""
    s = copy.deepcopy(sync_run.store)
    kfs = s.active_kfs()
    k, cand = int(kfs[-1]), int(kfs[0])
    lock = RecordingLock()
    lc = tlc.LoopCloser(s, world.rig, lock=lock)
    seen = set()
    _watch(lock, s, MUTATIONS, True, seen)
    _watch(lock, lc, ("_propagate_correction", "_commit_fuse", "_eg_build", "_eg_commit"), True, seen)
    _watch(lock, lc, ("_project_loop_points", "_eg_solve"), False, seen)
    solve = lc._eg_solve
    lc._eg_solve = lambda prob: (lc.loop_correcting and solve(prob)) or pytest.fail("loop_correcting unset")
    yields = []
    lc.yield_gate = lambda: yields.append(lock.held)
    loop_pts = lc._loop_neighborhood_points(cand)
    v7 = np.asarray([0.01, -0.02, 0.005, 0.002, 0.0, -0.001, 0.0], np.float32)
    lc._correct(k, cand, v7, {}, loop_pts)
    assert {"_propagate_correction", "_commit_fuse", "_eg_build", "_eg_commit", "_project_loop_points",
            "_eg_solve"} <= seen, seen
    assert len(lc.locked_phase_ms) == 4 and lock.entries == 4 and not lc.loop_correcting
    assert yields and not any(yields)
    assert s.loop_edges[-1] == (k, cand) and len(lc.correct_spans) == 1


# ------------------------------------------------ the kernel library's locks
def test_library_builds_and_loads_once(monkeypatch):
    """Two threads' first calls into the kernel library: one build, one
    load, the same symbol (the build stubbed: no nvcc here)."""
    lib = cuda_lib.Library()
    builds, loads = [], []

    def slow_build():
        builds.append(threading.current_thread().name)
        time.sleep(0.1)
        return "libfake.so"

    class FakeCDLL:
        def __init__(self, path):
            loads.append(path)
            self.mcslam_best_match = object()
    monkeypatch.setattr(lib, "build", slow_build)
    monkeypatch.setattr(cuda_lib.ctypes, "CDLL", FakeCDLL)
    start = threading.Barrier(2)
    got = []

    def first_call():
        start.wait()
        got.append(lib.symbol("mcslam_best_match"))
    threads = [threading.Thread(target=first_call) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    assert len(builds) == 1 and loads == ["libfake.so"]
    assert len(got) == 2 and got[0] is got[1]


def test_launch_counts_by_thread():
    """Counts from more threads than cores add up, split by thread name
    (a lost update would break the sum; the switch interval is shortened
    to interleave the threads as often as it can)."""
    k = cuda_lib.KernelEntry("none", [])
    n = 2 * (os.cpu_count() or 4)
    barrier = threading.Barrier(n)

    def launch():
        barrier.wait()
        for _ in range(2000):
            k.count()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch, name=f"t{i}") for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert k.launches == 2000 * n and k.by_thread == {f"t{i}": 2000 for i in range(n)}
    assert k.thread_launches() == 0


@pytest.mark.parametrize("in_flight", [0, 1])
def test_motion_model_predicts_each_frame_from_its_own_chain(in_flight):
    """The velocity after frame t carries it to the next frame to begin,
    1 + in_flight frames on. With a frame in flight (the depth-2 loop) it
    comes from frame t - 2, so an error of the other chain (the odd frames
    here, 0.02 off in x) leaves the even chain's prediction exact; without
    one it is the last frame's motion, as it always was."""
    from collections import deque

    from multicol_slam_tpu_torch.utils.geometry import cayley_to_hom, hom_to_cayley

    slam = MultiColSLAM.__new__(MultiColSLAM)
    slam._finished, slam._n_inflight = deque(maxlen=4), in_flight
    slam.last_pose, slam.velocity = np.zeros(6, np.float32), np.eye(4, dtype=np.float32)

    def pose(t):
        return np.array([0.0, 0.0, 0.0, 0.05 * t + (0.02 if t % 2 else 0.0), 0.0, 0.0], np.float32)
    for t in range(5):
        slam._finish_frame(pose(t), t)
    pred = hom_to_cayley(cayley_to_hom(torch.tensor(slam.last_pose)) @ torch.tensor(slam.velocity)).numpy()
    want = pose(4 + 1 + in_flight) if in_flight else 2 * pose(4) - pose(3)
    np.testing.assert_allclose(pred, want, atol=1e-6)


def test_tracker_waits_for_a_worker_that_cut_its_keyframe():
    """The worker counts keyframes whose fusion or BA an interruption cut
    short (a newer keyframe queued); `_wait_for_mapper` then holds the
    tracker until the worker has mapped what it holds, with the worker's
    gate open (no credits, yet each yield returns at once), and closes
    the gate again after."""
    import queue

    slam = MultiColSLAM.__new__(MultiColSLAM)
    slam._kf_queue, slam._frame_idle, slam._budget_cv = queue.Queue(), threading.Event(), threading.Condition()
    slam._budget, slam._tracker_tid, slam._map_stream, slam.loop_closer = 0, threading.get_ident(), None, None
    slam._interrupt_ba, slam._kf_cut, slam._kf_waited, slam._tracker_waiting = False, 0, 0, False
    slam.worker_errors = []
    release, yields, cut_before = threading.Event(), [], []

    class Mapper:
        def run(self, k, interrupt):
            cut_before.append(slam._kf_cut)
            if k == 0:
                release.wait(5.0)       # keyframe 1 is queued meanwhile: 0 is cut
            t0 = time.perf_counter()
            for _ in range(5):
                slam._yield_to_tracker()
            yields.append(time.perf_counter() - t0)
            interrupt()
    slam.mapper = Mapper()
    worker = threading.Thread(target=slam._mapping_worker, daemon=True)
    worker.start()
    slam._kf_queue.put(0)
    slam._kf_queue.put(1)
    release.set()
    slam._kf_queue.join()
    assert cut_before == [0, 1] and slam._kf_cut == 0     # 0 cut, then 1 mapped whole
    slam._kf_cut = 1
    slam._kf_queue.put(2)
    slam._wait_for_mapper()
    assert slam._kf_queue.unfinished_tasks == 0 and slam._kf_waited == 1
    assert yields[-1] < 0.05 and not slam._tracker_waiting and not slam._frame_idle.is_set()
    slam._kf_queue.put(None)
    worker.join(5.0)
    assert not worker.is_alive() and slam.worker_errors == []
