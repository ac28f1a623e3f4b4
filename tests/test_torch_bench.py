"""The port's bench (multicol_slam_tpu_torch/bench.py) against the
repository's bench.py on the CPU.

- `_lafida_rig` is the reference's rig: the intrinsics vector and Mc equal.
- Phase 1's local map, fed the JAX package's features of the bench image,
  equals bench.py:90-121's X, D and n exactly; the fused frame on it (the
  port's track_frame_fused on those features) matches JAX's: stage-2
  inliers equal, pose within 1e-4. The reference's full setting (3 x
  754x480, 400 features x 8 levels): the local map's depths put its points
  at the coarse levels, so fewer levels would match nothing.
- Depth-2 pipelined tracking (`run_pipelined`) against the reference's
  loop (bench.py:236-265, rebuilt here around the JAX package's
  MultiColSLAM) on test_slam_e2e.py's line world (2 cameras of 256x192,
  250 oracle features), sync mapping, 30 frames, the port fed JAX's
  RANSAC draws, and on the same line with a speed that swings between
  0.02 and 0.08 m a frame (where the two packages' depth-2 motion models
  differ by design): states and keyframe frames equal; inliers within 2 % (at
  least 1) and poses within 1e-2, the agreement the two packages' sync
  runs of this world have (exact inliers and 1e-3 poses hold at neither
  depth: float32 rounding flips single robust-gate decisions from frame 4
  on, 311 against 312 inliers, and the poses drift up to 6.8e-3 apart).
- One async depth-2 run: frames finish in order, keyframes are mapped on
  the worker, the tracker's gate is left open and the worker records no
  error.
- The phase-3 summary against hand-computed spans; the phase-2 and phase-3
  key sets equal the reference's (read from bench.py's source) less
  `tunnel_rtt_ms`.
"""
import ast
import dataclasses
import importlib
import os
import sys
from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.io.synthetic import make_world
from multicol_slam_tpu.slam.features import extract_features_jit
from multicol_slam_tpu.slam.map_store import MapConfig as JMapConfig
from multicol_slam_tpu.slam.system import MultiColSLAM as JSLAM
from multicol_slam_tpu.slam.tracking_kernels import LocalPoints as JLocalPoints
from multicol_slam_tpu.slam.tracking_kernels import track_frame_fused as jtrack_frame_fused
from multicol_slam_tpu.utils.config import ExtractorSettings as JExtractor
from multicol_slam_tpu.utils.config import SlamSettings as JSettings
from multicol_slam_tpu_torch import bench, convert
from multicol_slam_tpu_torch.slam import local_mapping as tlm
from multicol_slam_tpu_torch.slam.map_store import MapConfig
from multicol_slam_tpu_torch.slam.system import WORKING, MultiColSLAM
from multicol_slam_tpu_torch.slam.tracking_kernels import track_frame_fused, unpack_fused
from multicol_slam_tpu_torch.utils.config import ExtractorSettings, SlamSettings
from torch_jax_draws import JaxDraws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("uv", "response", "octave", "angle", "rays", "desc", "dmask", "valid")
N_FEATS, N_FRAMES, SEED = 250, 30, 3
# the two packages' depth-2 runs (and their sync runs alike) round apart:
# on this world stage-2 inliers differ by up to 4 (1.9 %) and poses by up to
# 6.8e-3 from frame 4 on, the same at depth 1 (ROADMAP Queue 3, Slice 3)
INLIER_REL, POSE_TOL = 0.02, 1e-2
ASYNC_FRAMES = 60     # the circle world's keyframes 6-9 (frames 34-58) map on the worker
MAP = dict(max_keyframes=64, max_points=4000, n_cams=2, feats_per_cam=N_FEATS, n_levels=1, scale_factor=1.2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_bench():
    """The repository's root bench.py (imported for its functions; its
    main() is never called)."""
    sys.path.insert(0, ROOT)
    try:
        mod = importlib.import_module("bench")
    finally:
        sys.path.remove(ROOT)
        sys.modules.pop("bench", None)
    return mod


def _port_feats(f):
    return convert.frame_features_from_numpy(**{k: np.asarray(getattr(f, k)) for k in FIELDS}, device="cpu")


def test_lafida_rig_is_the_references(ref_bench):
    jrig, jreal = ref_bench._lafida_rig()
    trig, treal = bench._lafida_rig("cpu")
    assert treal == jreal
    np.testing.assert_array_equal(trig.cams.to_vector().numpy(), np.asarray(jrig.cams.to_vector()))
    np.testing.assert_allclose(trig.Mc.numpy(), np.asarray(jrig.Mc), rtol=0, atol=1e-7)


def test_phase1_local_map_and_frame(ref_bench):
    jrig, _ = ref_bench._lafida_rig()
    C = jrig.n_cams
    W, H = (int(x) for x in np.asarray(jrig.cams.wh[0]))
    settings = JExtractor(n_features=400, n_levels=8, scale_factor=1.2, fast_th=20)
    # bench.py:77-121, as the reference runs it
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (C, H, W)).astype(np.float32)
    feats0 = extract_features_jit(jnp.asarray(images), jrig.cams, settings)
    desc, valid, rays = (np.asarray(getattr(feats0, k)) for k in ("desc", "valid", "rays"))
    Mc = np.asarray(jrig.Mc)
    Xs, Ds = [], []
    for c in range(C):
        v = valid[c]
        depth = rng.uniform(3.0, 12.0, v.sum()).astype(np.float32)
        Xc = rays[c][v] * depth[:, None]
        Xs.append((Mc[c, :3, :3] @ Xc.T).T + Mc[c, :3, 3])
        Ds.append(desc[c][v])
    L = bench.LOCAL_MAP
    X, D = np.concatenate(Xs)[:L], np.concatenate(Ds)[:L]
    n = len(X)
    # the port's builder on the same features, its generator at the same draw
    rng_t = np.random.default_rng(0)
    rng_t.uniform(0, 255, (C, H, W))
    Xt, Dt, nt = bench.local_map(valid, rays, desc, Mc, rng_t)
    assert nt == n > 500
    np.testing.assert_array_equal(Xt, X)
    np.testing.assert_array_equal(Dt, D)

    def jpts(cap):
        return JLocalPoints(X=jnp.asarray(np.pad(X, ((0, cap - n), (0, 0)))),
                            desc=jnp.asarray(np.pad(D, ((0, cap - n), (0, 0)))),
                            min_dist=jnp.full((cap,), 0.5), max_dist=jnp.full((cap,), 40.0),
                            valid=jnp.asarray(np.arange(cap) < n))
    pts = jpts(L)
    packed_j = np.asarray(jtrack_frame_fused(jnp.asarray(np.asarray(jrig.Mc_cayley, np.float32)),
                                             jnp.asarray(jrig.cams.to_vector()), jrig.cams, feats0,
                                             jnp.asarray(np.asarray(bench.POSE0, np.float32)), pts, pts,
                                             radius1=15.0, radius2=4.0, th_desc=96.0))
    trig, _ = bench._lafida_rig("cpu")
    tpts = bench.local_points(Xt, Dt, nt, L, "cpu")
    packed_t = track_frame_fused(trig.Mc_cayley, trig.cams.to_vector(), trig.cams, _port_feats(feats0),
                                 torch.tensor(bench.POSE0), tpts, tpts, radius1=15.0, radius2=4.0,
                                 th_desc=96.0).numpy()
    uj, ut = unpack_fused(packed_j), unpack_fused(packed_t)
    assert uj[4] >= 100 and ut[4] == uj[4] and packed_t[14] == packed_j[14]
    np.testing.assert_allclose(ut[2], uj[2], rtol=0, atol=1e-4)


def _reference_pipeline(slam, feats, timestamps, n_frames, depth=2):
    """bench.py:244-264 (unpaced): begin frame t, prefetch t+1, finish the
    oldest once `depth` are in flight, drain."""
    kf_frames = []
    pending = feats[0]
    inflight = deque()
    for t in range(n_frames):
        inflight.append(slam.track_begin(feats=pending, timestamp=timestamps[t]))
        if t + 1 < n_frames:
            pending = feats[t + 1]
        if len(inflight) >= depth:
            m = slam.track_finish(inflight.popleft())
            kf_frames += [m.frame_id] if m.is_keyframe else []
    while inflight:
        m = slam.track_finish(inflight.popleft())
        kf_frames += [m.frame_id] if m.is_keyframe else []
    return kf_frames


@pytest.fixture(scope="module")
def line_world():
    return make_world(n_points=500, n_frames=N_FRAMES, n_cams=2, n_feats=N_FEATS, noise_px=0.2, trajectory="line",
                      seed=1)


def _port_rig(jrig):
    c = jrig.cams
    return convert.rig_from_numpy(*(np.asarray(getattr(c, k)) for k in ("pol", "invpol", "cde", "pp", "wh")),
                                  np.asarray(jrig.Mc_cayley), device="cpu")


def _port_settings():
    return SlamSettings(fps=25.0, extractor=ExtractorSettings(n_features=N_FEATS, n_levels=1))


def _depth2_parity(w, inlier_rel=INLIER_REL, pose_tol=POSE_TOL):
    jfeats = [w.frame_features(t) for t in range(N_FRAMES)]
    js = JSLAM(w.rig, JSettings(fps=25.0, extractor=JExtractor(n_features=N_FEATS, n_levels=1)), JMapConfig(**MAP),
               use_loop_closing=False, seed=SEED)
    jkf = _reference_pipeline(js, jfeats, w.timestamps, N_FRAMES)
    draws = JaxDraws(SEED)
    ts = MultiColSLAM(_port_rig(w.rig), _port_settings(), MapConfig(**MAP), use_loop_closing=False, seed=SEED,
                      device="cpu", init_sampler=draws.init, reloc_sampler=draws.reloc)
    tfeats = [_port_feats(f) for f in jfeats]
    times, n_kf = bench.run_pipelined(ts, lambda t: tfeats[t], w.timestamps, N_FRAMES)
    assert len(times) == N_FRAMES and n_kf == len(jkf) >= 1
    jt, tt = js.trajectory, ts.trajectory
    assert [m.frame_id for m in tt] == list(range(N_FRAMES))
    assert [m.state for m in tt] == [m.state for m in jt]
    assert sum(m.state == WORKING for m in tt) >= N_FRAMES - 5
    assert [m.frame_id for m in tt if m.is_keyframe] == jkf
    nj, nt = np.array([m.n_inliers for m in jt]), np.array([m.n_inliers for m in tt])
    assert (np.abs(nt - nj) <= np.maximum(1, inlier_rel * nj)).all(), (nt - nj).tolist()
    np.testing.assert_allclose(np.stack([m.pose for m in tt]), np.stack([np.asarray(m.pose) for m in jt]),
                               rtol=0, atol=pose_tol)
    return jt, tt


def test_depth2_pipeline_matches_the_references_loop(line_world):
    _depth2_parity(line_world)


def test_depth2_pipeline_matches_the_references_loop_when_velocity_changes(line_world):
    """The same parity where the speed along the line swings between 0.02
    and 0.08 m a frame. The motion models differ here by design: at depth
    2 the port predicts frame t + 1 from frame t - 1 with the velocity over
    t - 3 -> t - 1 (its own chain), the JAX package with the one-frame
    velocity t - 2 -> t - 1 (ROADMAP, accepted differences). On this world
    the port with the JAX package's model ends 1.65 % of inliers and 0.0125
    in pose from it (the packages round apart, as on the line); with its own
    model 2.06 % and the same 0.0125. So the bounds are 2.5 % and 0.015,
    and the port's largest error against the true poses may exceed the
    reference's by 5 % at most (0.0829 against 0.0831 m)."""
    t = np.arange(N_FRAMES)
    poses = np.array(line_world.poses)
    poses[:, 3] = 0.05 * t + 0.1 * np.sin(2.0 * np.pi * t / 20.0)
    jt, tt = _depth2_parity(dataclasses.replace(line_world, poses=poses.astype(np.float32)), inlier_rel=0.025,
                            pose_tol=0.015)
    err = [np.abs(np.stack([np.asarray(m.pose) for m in tr]) - poses).max() for tr in (tt, jt)]
    assert err[0] <= 1.05 * err[1], err


def test_async_depth2_run(line_world):
    """The worker beside two frames in flight: frames finish in the order
    they began, keyframes after the bootstrap's are mapped on the worker,
    the tracker's gate is open at the end and no error was recorded."""
    from multicol_slam_tpu_torch.io.synthetic import make_world as tmake_world

    w = tmake_world(n_points=800, n_frames=ASYNC_FRAMES, n_cams=2, n_feats=N_FEATS, noise_px=0.2,
                    trajectory="circle", seed=1)
    threads = []
    orig = tlm.LocalMapper.run

    def run(self, *a, **k):
        import threading

        threads.append(threading.current_thread().name)
        return orig(self, *a, **k)
    mp = pytest.MonkeyPatch()
    mp.setattr(tlm.LocalMapper, "run", run)
    try:
        slam = MultiColSLAM(w.rig, _port_settings(), MapConfig(**dict(MAP, max_points=8000)), use_loop_closing=False,
                            async_mapping=True, device="cpu")
        feats = [w.frame_features(t, device="cpu") for t in range(ASYNC_FRAMES)]
        _, n_kf = bench.run_pipelined(slam, lambda t: feats[t], w.timestamps, ASYNC_FRAMES)
        slam.wait_mapping_idle()
        slam.shutdown()
    finally:
        mp.undo()
    assert [m.frame_id for m in slam.trajectory] == list(range(ASYNC_FRAMES))
    assert sum(m.state == WORKING for m in slam.trajectory) >= ASYNC_FRAMES - 5 and n_kf >= 4
    assert "mcslam-mapping" in threads, threads
    assert slam._frame_idle.is_set() and slam._n_inflight == 0
    assert slam.worker_errors == []


def test_phase3_summary_spans():
    """Frames overlapping a CorrectLoop span count as during it; the gate is
    two camera periods (7.5 fps: 266.67 ms)."""
    period = 1.0 / 7.5
    stamps = [(0.0, 0.1), (0.2, 0.3), (0.4, 0.9), (1.0, 1.1), (1.2, 1.3)]
    times = [100.0, 100.0, 500.0, 100.0, 120.0]
    spans = [(0.25, 0.45), (1.25, 1.5)]
    out = bench.loop_summary(times, stamps, spans, [3.0, 7.5], 2, 130, period)
    # frames 1 (0.2-0.3) and 2 (0.4-0.9) touch the first span, frame 4 the second
    assert out["loop_frame_during_correction_max_ms"] == 500.0
    assert out["gate_latency_through_correction"] == "FAIL (500 ms > 267)"
    assert out["gate_loop_closed_in_window"] == "PASS"
    assert out["loop_locked_max_ms"] == 7.5 and out["loop_frame_worst_ms"] == 500.0
    assert out["loop_frame_p95_ms"] == pytest.approx(np.percentile(times, 95))
    assert out["loop_paced_fps"] == pytest.approx(7.5)
    none = bench.loop_summary(times[:2], stamps[:2], [], [], 0, 100, period)
    assert none["loop_frame_during_correction_max_ms"] is None
    assert none["gate_latency_through_correction"] == "PASS"
    assert none["gate_loop_closed_in_window"] == "FAIL (0 loops)"
    assert none["loop_locked_max_ms"] == 0.0
    # a span that touches a frame's end only
    edge = bench.loop_summary([90.0], [(2.0, 2.1)], [(2.1, 2.2)], [], 1, 1, period)
    assert edge["loop_frame_during_correction_max_ms"] == 90.0


def _keys(path, function):
    """The keys of the result dict that `function` of the script at `path`
    builds: the `out = {...}` literal and each `out["..."] = ...`."""
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "out" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript) \
                and getattr(node.targets[0].value, "id", None) == "out":
            keys.add(node.targets[0].slice.value)
    return keys


def test_key_sets_are_the_references():
    p2 = bench.pipeline_summary(np.arange(10.0), np.arange(10.0), 3, 100, 0, [], "shape")
    ref = os.path.join(ROOT, "bench.py")
    assert set(p2) == _keys(ref, "_pipeline_latency") - {"tunnel_rtt_ms"}
    assert p2["pipeline_depth"] == 2 and p2["gate_pipeline_p95_le_160ms"] == "PASS"
    p3 = bench.loop_summary([1.0], [(0.0, 1.0)], [], [], 0, 1, 1 / 7.5)
    assert set(p3) == _keys(ref, "_loop_closure_latency")
    # main's own keys, then phases 2 and 3's; the port adds the card
    assert _keys(bench.__file__, "main") == _keys(ref, "main") | {"device"}
