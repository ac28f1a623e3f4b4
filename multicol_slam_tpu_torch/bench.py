"""Benchmark of the port: tracking throughput and whole-pipeline latency at
Lafida load, and a loop closure under real-time pacing (port of the
repository's `bench.py`, which stays the JAX package's).

Phase 1, tracking throughput: 3 fisheye cameras of 754x480, 400 features x
8 levels (Slam_Settings_indoor1.yaml); extraction and the fused two-stage
tracking program (`track_frame_fused`, two K1 launches) a frame against a
local map built from the frame's own features (each ray pushed to a depth
in [3, 12] m, its real descriptor), from a perturbed start pose. 30 frames
back to back, ended by `torch.cuda.synchronize()`; then the synchronous
frame: the median of 10, each ended by the `.cpu()` readback of the packed
result.

Phase 2, whole-pipeline latency at the same shape: a room world rendered
through the Lafida calibration (the repository's Examples/Lafida when it
is there, else an equivalent 754x480 fisheye rig), extraction included,
keyframes by NeedNewKeyFrame, async mapping and loop closing (the CLI's
default), a pretrained vocabulary. Software-pipelined at depth 2: frame t
begins (its fused program dispatched) and frame t-2 finishes in the same
iteration. Paced at the 25 fps camera period (the time of a frame excludes
the sleep), then unpaced; the window is the frames from 30 on.

Phase 3, a loop closure during paced real-time tracking: the drift world of
tests/test_loop_reloc.py (one 85-frame lap and a revisit), oracle
features, 7.5 fps, async mapping; the frames during a CorrectLoop are
counted against the loop closer's `correct_spans`.

    python3 -m multicol_slam_tpu_torch.bench

Prints one JSON line with the reference's keys and "device" (nvidia-smi's
name and power limit), and each phase's wall seconds on standard error. vs_baseline is frames/s over 25. The gates are
fields, never raised, as in the reference. Runs on the card and raises
without one. Differences from the reference: the pipeline's depth is 2 (the
reference sizes it to a measured tunnel round trip, ceil(rtt / 40 ms) + 1,
which is 2 on a local card), so there is no `tunnel_rtt_ms`; numbers are
not rounded; an error on the mapping worker raises.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import deque

import numpy as np
import torch

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from multicol_slam_tpu_torch.eval import LAFIDA_CALIB
from multicol_slam_tpu_torch.io.render import render_frame
from multicol_slam_tpu_torch.io.synthetic import make_synthetic_rig, make_world
from multicol_slam_tpu_torch.models.camera import OmniCamera
from multicol_slam_tpu_torch.models.rig import MultiCamRig
from multicol_slam_tpu_torch.models.vocab import KeyFrameDatabase, build_vocabulary
from multicol_slam_tpu_torch.slam.features import ExtractorTables, FrameFeatures, extract_features
from multicol_slam_tpu_torch.slam.map_store import MapConfig
from multicol_slam_tpu_torch.slam.system import WORKING, MultiColSLAM
from multicol_slam_tpu_torch.slam.tracking_kernels import (
    LocalPoints, track_frame_fused, track_stage, unpack_fused,
)
from multicol_slam_tpu_torch.utils.config import ExtractorSettings, SlamSettings, load_rig

# the 754x480 fisheye rig of the Lafida family (polynomials of the indoor
# set); camera -> body extrinsics: identity rotations, cameras 1 and 2
# offset 0.2 m in x and y
LAFIDA_POL = [-209.2, 0.0, 0.0021, -4.2e-06, 1.77e-08]
LAFIDA_INVPOL = [293.7, 150.0, -10.4, 28.2, 7.1, 0.06, 10.4, 0.17, -5.9, 1.18, 3.1, 0.81]
LAFIDA_MC_CAYLEY = [[0.0] * 6, [0.0, 0.0, 0.0, 0.2, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.2, 0.0]]
LAFIDA_W, LAFIDA_H = 754, 480
# ~0.5 deg rotation + 3 cm translation: the motion-model prediction error
# the pose stages must absorb
POSE0 = [0.002, -0.003, 0.002, 0.02, -0.015, 0.01]
LOCAL_MAP = 4096
TRACK_ITERS, SYNC_FRAMES = 30, 10    # phase 1's back-to-back frames and synchronous frames
PIPELINE_DEPTH = 2
STEADY_FROM = 30          # phase 2's window: past the bootstrap's synchronous keyframes
LOOP_STEADY_FROM = 8      # phase 3's
BASELINE_FPS = 25.0       # the reference is real-time gated at 25 fps on a laptop CPU (BASELINE.md)


def synthetic_lafida_rig(device=DEFAULT_DEVICE, n_cams: int = 3) -> MultiCamRig:
    """The 754x480 Lafida-family fisheye rig on `device`."""
    C, W, H = n_cams, LAFIDA_W, LAFIDA_H
    cams = OmniCamera.from_params([LAFIDA_POL] * C, [LAFIDA_INVPOL] * C, [[1.0, 0.0, 0.0]] * C,
                                  [[W / 2.0, H / 2.0]] * C, [[W, H]] * C, device=device)
    return MultiCamRig.from_cayley(cams, torch.tensor(LAFIDA_MC_CAYLEY[:C], dtype=torch.float32,
                                                      device=cams.pol.device))


def _lafida_rig(device=DEFAULT_DEVICE, n_cams: int = 3):
    """(rig, real): the Lafida helmet rig from its calibration files when
    they are in the repository, else the equivalent synthetic one."""
    if os.path.isdir(LAFIDA_CALIB):
        return load_rig(LAFIDA_CALIB, device=device), True
    return synthetic_lafida_rig(device, n_cams), False


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# phase 1: tracking throughput
# ---------------------------------------------------------------------------

def local_map(valid, rays, desc, Mc, rng, L: int = LOCAL_MAP):
    """A local map from a frame's own features (host numpy): each valid
    keypoint's ray pushed to a depth drawn from rng in [3, 12] m, through
    its camera's extrinsics Mc [C, 4, 4], with its real descriptor. Returns
    (X [n, 3], D [n, B], n), n <= L."""
    Xs, Ds = [], []
    for c in range(valid.shape[0]):
        v = valid[c]
        depth = rng.uniform(3.0, 12.0, v.sum()).astype(np.float32)
        Xc = rays[c][v] * depth[:, None]
        Xs.append((Mc[c, :3, :3] @ Xc.T).T + Mc[c, :3, 3])
        Ds.append(desc[c][v])
    X = np.concatenate(Xs)[:L]
    D = np.concatenate(Ds)[:L]
    return X, D, len(X)


def local_points(X, D, n, L: int, device) -> LocalPoints:
    """The map's LocalPoints block, padded to L slots (valid: the first n)."""
    return LocalPoints(
        X=torch.tensor(np.pad(np.asarray(X, np.float32), ((0, L - n), (0, 0))), device=device),
        desc=torch.tensor(np.pad(D, ((0, L - n), (0, 0))), device=device),
        min_dist=torch.full((L,), 0.5, device=device),
        max_dist=torch.full((L,), 40.0, device=device),
        valid=torch.arange(L, device=device) < n,
    )


def tracking_slice(rig: MultiCamRig, settings: ExtractorSettings, device=DEFAULT_DEVICE):
    """Phase 1's frame: (frame, images) where frame(images) -> the packed
    result of extraction + `track_frame_fused` (radii 15 / 4, th_desc 96)
    against the local map of the images' own features. Images: float32
    from default_rng(0).uniform(0, 255)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    C = rig.n_cams
    W, H = (int(x) for x in rig.cams.wh[0].tolist())
    images = torch.tensor(rng.uniform(0, 255, (C, H, W)).astype(np.float32), device=device)
    tables = ExtractorTables(settings, H, W, device=device)
    mc6, intr = rig.Mc_cayley.to(torch.float32), rig.cams.to_vector()
    f0 = extract_features(images, rig.cams, settings, tables)
    X, D, n = local_map(*(getattr(f0, k).cpu().numpy() for k in ("valid", "rays", "desc")), rig.Mc.cpu().numpy(),
                        rng)
    pts = local_points(X, D, n, LOCAL_MAP, device)      # the one block both stages share
    pose0 = torch.tensor(POSE0, dtype=torch.float32, device=device)

    def frame(images):
        feats = extract_features(images, rig.cams, settings, tables)
        return track_frame_fused(mc6, intr, rig.cams, feats, pose0, pts, pts, radius1=15.0, radius2=4.0,
                                 th_desc=96.0)
    return frame, images


def tracking_phase(rig: MultiCamRig, settings: ExtractorSettings, device=DEFAULT_DEVICE) -> dict:
    """Phase 1: a warm frame (its stage-2 inliers must reach 100), frames/s
    over TRACK_ITERS back-to-back frames ended by a synchronize, and the
    median ms of SYNC_FRAMES synchronous frames (each ended by the packed
    result's readback)."""
    device = resolve_device(device)
    frame, images = tracking_slice(rig, settings, device)
    n_inliers = unpack_fused(frame(images).cpu().numpy())[4]   # packed[14]
    if n_inliers < 100:
        raise AssertionError(f"bench sanity: expected a well-matched frame, got {n_inliers} inliers")
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(TRACK_ITERS):
        frame(images)
    _sync(device)
    fps = TRACK_ITERS / (time.perf_counter() - t0)
    sync_ms = []
    for _ in range(SYNC_FRAMES):
        t0 = time.perf_counter()
        frame(images).cpu()
        sync_ms.append((time.perf_counter() - t0) * 1e3)
    return dict(fps=fps, sync_frame_ms=float(np.median(sync_ms)), n_inliers=n_inliers)


# ---------------------------------------------------------------------------
# phase 2: whole-pipeline latency, software-pipelined
# ---------------------------------------------------------------------------

def run_pipelined(slam: MultiColSLAM, prepare, timestamps, n_frames: int, period=None):
    """The real-time software pipeline of the reference's bench: prefetch
    frame t+1 with prepare(t + 1) after frame t begins, finish the oldest
    frame once PIPELINE_DEPTH are in flight, drain at the end. With `period`
    (seconds) each frame waits for its camera slot first; a frame's time
    excludes that sleep. Returns (ms of each frame's iteration, keyframe
    frames)."""
    times, kf_frames = [], 0
    next_t = time.perf_counter()
    pending = prepare(0)
    inflight = deque()
    for t in range(n_frames):
        if period is not None:
            now = time.perf_counter()
            if now < next_t:
                time.sleep(next_t - now)
            next_t = max(next_t + period, time.perf_counter())
        t0 = time.perf_counter()
        inflight.append(slam.track_begin(feats=pending, timestamp=float(timestamps[t])))
        if t + 1 < n_frames:
            pending = prepare(t + 1)
        if len(inflight) >= PIPELINE_DEPTH:
            kf_frames += int(slam.track_finish(inflight.popleft()).is_keyframe)
        times.append((time.perf_counter() - t0) * 1e3)
    while inflight:
        kf_frames += int(slam.track_finish(inflight.popleft()).is_keyframe)
    return times, kf_frames


def _finish(slam: MultiColSLAM):
    """Drain and stop the mapping worker; (loops closed, CorrectLoop's
    lock-held ms, its spans). Raises when the worker recorded an error."""
    slam.wait_mapping_idle()
    lc = slam.loop_closer
    out = lc.n_loops_closed, list(lc.locked_phase_ms), list(lc.correct_spans)
    slam.shutdown()
    if slam.worker_errors:
        raise RuntimeError(f"the mapping worker failed: {slam.worker_errors[0]!r}")
    return out


def _with_vocabulary(slam: MultiColSLAM, voc) -> MultiColSLAM:
    """A pretrained vocabulary and a fresh database in the loop closer (the
    reference loads small_orb_omni_voc_9_6.yml; training it in the run
    would put its k-means on the worker)."""
    slam.loop_closer.voc = voc
    slam.loop_closer.db = KeyFrameDatabase(voc)
    return slam


def _pipeline_latency(rig: MultiCamRig, ex_settings: ExtractorSettings, n_frames: int = 140,
                      device=DEFAULT_DEVICE) -> dict:
    """Phase 2. `rig` is the rig on the device; the world (host data) is
    rendered through its CPU copy. Walking speed (a 3 m circle at 400
    frames a lap: 0.047 m a frame at 25 fps, the motion the reference's
    keyframe constants are tuned for) through a textured room."""
    device = resolve_device(device)
    host_rig = MultiCamRig.from_cayley(
        OmniCamera(*(getattr(rig.cams, k).cpu() for k in ("pol", "invpol", "cde", "pp", "wh"))), rig.Mc_cayley.cpu())
    real = os.path.isdir(LAFIDA_CALIB)
    world = make_world(n_points=3000, n_frames=n_frames, n_cams=rig.n_cams, n_feats=ex_settings.n_features,
                       noise_px=0.0, trajectory="circle_noyaw", radius=3.0, seed=12, period=400, landmarks="room",
                       max_vis_dist=12.0, rig=host_rig)
    images = [render_frame(world, t) for t in range(n_frames)]      # uint8, rendered before any run
    settings = SlamSettings(fps=25.0, extractor=ex_settings)
    cfg = MapConfig(max_keyframes=64, max_points=20000, n_cams=rig.n_cams, feats_per_cam=ex_settings.n_features,
                    n_levels=ex_settings.n_levels, scale_factor=ex_settings.scale_factor)
    voc = build_vocabulary(world.descs, k=9, depth=3, device=device)

    def run(paced: bool):
        slam = _with_vocabulary(MultiColSLAM(rig, settings, cfg, use_loop_closing=True, async_mapping=True,
                                             device=device), voc)
        times, kf_frames = run_pipelined(slam, lambda t: slam.prepare(images[t]), world.timestamps, n_frames,
                                         period=1.0 / 25.0 if paced else None)
        n_tracked = sum(1 for m in slam.trajectory if m.state == WORKING)
        loops, locked, _ = _finish(slam)
        return np.asarray(times[STEADY_FROM:]), kf_frames, n_tracked, loops, locked

    run(paced=True)          # warm: first launches, the allocator, the worker's shapes
    _prewarm_rare_paths(rig, settings, cfg, device)
    arr_p, kf_p, trk_p, loops_p, locked_p = run(paced=True)
    arr_u, _, _, _, _ = run(paced=False)
    shape = (f"{rig.n_cams}x{LAFIDA_W}x{LAFIDA_H} {'real-calib' if real else 'synth-calib'}, "
             f"{ex_settings.n_features} feats x {ex_settings.n_levels} levels, extraction included")
    return pipeline_summary(arr_p, arr_u, kf_p, trk_p, loops_p, locked_p, shape)


def pipeline_summary(paced, unpaced, kf_frames: int, n_tracked: int, loops: int, locked, shape: str) -> dict:
    """Phase 2's keys: the paced and unpaced runs' windows of frame ms, and
    the paced run's keyframe frames, frames tracked, loops closed and
    CorrectLoop's lock-held ms. The gate is p95 <= 160 ms."""
    paced, unpaced = np.asarray(paced, np.float64), np.asarray(unpaced, np.float64)
    out = {
        "pipeline_p50_ms": float(np.percentile(paced, 50)),
        "pipeline_p95_ms": float(np.percentile(paced, 95)),
        "pipeline_worst_ms": float(paced.max()),
        "pipeline_kf_frames": kf_frames,
        "pipeline_tracked_frames": n_tracked,
        "pipeline_loops_closed": loops,
        # the longest CorrectLoop lock-held phase: the only window in which a
        # tracked frame can stall on the loop closer
        "loop_locked_max_ms": float(max(locked, default=0.0)),
        "pipeline_paced_25fps": True,
        "pipeline_depth": PIPELINE_DEPTH,
        "pipeline_mode": f"software-pipelined depth {PIPELINE_DEPTH}: frame t dispatched, frame t-{PIPELINE_DEPTH}'s "
                         "result consumed per iteration; times are per-frame blocking work excl. pacing sleep; "
                         f"steady-state window from frame {STEADY_FROM}",
        "pipeline_unpaced_p50_ms": float(np.percentile(unpaced, 50)),
        "pipeline_unpaced_p95_ms": float(np.percentile(unpaced, 95)),
        "pipeline_shape": shape,
    }
    out["gate_pipeline_p95_le_160ms"] = ("PASS" if out["pipeline_p95_ms"] <= 160.0
                                         else f"FAIL ({out['pipeline_p95_ms']} ms)")
    return out


# ---------------------------------------------------------------------------
# phase 3: a loop closure under real-time pacing
# ---------------------------------------------------------------------------

def loop_summary(times, stamps, spans, locked, loops: int, n_tracked: int, period: float) -> dict:
    """Phase 3's keys from one run's window: `times` (ms) and `stamps`
    ((start, end) host seconds) of its frames, CorrectLoop's `spans` and
    lock-held ms, the loops closed, the frames tracked and the camera
    period (s). A frame is during a correction when its stamps overlap a
    span; the latency gate is two camera periods."""
    times = np.asarray(times, np.float64)
    during = [ms for ms, (a, b) in zip(times, stamps) if any(a <= s1 and b >= s0 for s0, s1 in spans)]
    out = {
        "loop_loops_closed": loops,
        "loop_tracked_frames": n_tracked,
        "loop_frame_p95_ms": float(np.percentile(times, 95)),
        "loop_frame_worst_ms": float(times.max()),
        # the tracked frames' latency while a CorrectLoop was in progress
        "loop_frame_during_correction_max_ms": float(max(during)) if during else None,
        "loop_locked_max_ms": float(max(locked, default=0.0)),
        "loop_paced_fps": 1.0 / period,
    }
    out["gate_loop_closed_in_window"] = "PASS" if loops >= 1 else "FAIL (0 loops)"
    bound = 2e3 * period
    if during and max(during) > bound:
        out["gate_latency_through_correction"] = f"FAIL ({max(during):.0f} ms > {bound:.0f})"
    else:
        out["gate_latency_through_correction"] = "PASS"
    return out


def _loop_closure_latency(n_frames: int = 135, device=DEFAULT_DEVICE) -> dict:
    """Phase 3: tests/test_loop_reloc.py's drift world (seed 7, an 85-frame
    lap, 1500 landmarks hugging the path), oracle features (this phase
    measures the loop-closing subsystem; phase 2 covers extraction), paced
    at the world's 7.5 fps, async mapping. One warm run, one measured."""
    device = resolve_device(device)
    world = make_world(n_points=1500, n_frames=n_frames, n_cams=3, n_feats=150, noise_px=0.5,
                       trajectory="circle_noyaw", radius=3.0, seed=7, period=85, max_vis_dist=3.0, landmarks="path")
    rig = make_synthetic_rig(3, device=device)          # world.rig, on the device
    settings = SlamSettings(fps=7.5, extractor=ExtractorSettings(n_features=150, n_levels=1))
    cfg = MapConfig(max_keyframes=64, max_points=8000, n_cams=3, feats_per_cam=150, n_levels=1)
    feats = [world.frame_features(t, device=device) for t in range(n_frames)]
    voc = build_vocabulary(world.descs, k=9, depth=3, device=device)
    period = 1.0 / 7.5

    def run():
        slam = _with_vocabulary(MultiColSLAM(rig, settings, cfg, use_loop_closing=True, async_mapping=True,
                                             device=device), voc)
        times, stamps = [], []
        next_t = time.perf_counter()
        for t in range(n_frames):
            now = time.perf_counter()
            if now < next_t:
                time.sleep(next_t - now)
            next_t = max(next_t + period, time.perf_counter())
            t0 = time.perf_counter()
            slam.track(feats=feats[t], timestamp=float(world.timestamps[t]))
            t1 = time.perf_counter()
            times.append((t1 - t0) * 1e3)
            stamps.append((t0, t1))
        n_tracked = sum(1 for m in slam.trajectory if m.state == WORKING)
        loops, locked, spans = _finish(slam)
        w = LOOP_STEADY_FROM
        return loop_summary(times[w:], stamps[w:], spans, locked, loops, n_tracked, period)

    run()                    # warm, the loop-closing paths included
    return run()


def _prewarm_rare_paths(rig: MultiCamRig, settings: SlamSettings, cfg: MapConfig, device=DEFAULT_DEVICE):
    """Run the rare-path configurations once before the measured runs:
    TrackPreviousFrame's wide-window fallback (fused, radii 60 / 40) and
    relocalization's confirming stage (`track_stage`, radius 8), on zero
    features against an empty 4096-slot map. The reference compiles them
    here; in PyTorch this warms their first launches and the caching
    allocator's blocks, so that neither shows up as a worst frame."""
    device = resolve_device(device)
    C, K, B = cfg.n_cams, cfg.feats_per_cam, cfg.desc_bytes
    ex = settings.extractor

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    feats = FrameFeatures(uv=z(C, K, 2), response=z(C, K), octave=z(C, K, dtype=torch.int32), angle=z(C, K),
                          rays=z(C, K, 3), desc=z(C, K, B, dtype=torch.uint8),
                          dmask=torch.full((C, K, B), 255, dtype=torch.uint8, device=device),
                          valid=z(C, K, dtype=torch.bool))
    L = LOCAL_MAP
    lp = LocalPoints(X=z(L, 3), desc=z(L, B, dtype=torch.uint8), min_dist=z(L), max_dist=torch.ones(L, device=device),
                     valid=z(L, dtype=torch.bool), normal=z(L, 3))
    mc6, intr, pose = rig.Mc_cayley.to(torch.float32), rig.cams.to_vector(), z(6)
    common = dict(scale_factor=ex.scale_factor, n_levels=ex.n_levels, th_desc=3.0 * B)
    track_frame_fused(mc6, intr, rig.cams, feats, pose, lp, lp, radius1=60.0, radius2=40.0, **common)
    track_stage(mc6, intr, rig.cams, feats, pose, lp, radius=8.0, **common)
    _sync(device)


def main(argv=None, device=DEFAULT_DEVICE) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv:
        raise SystemExit(f"unknown args {argv}")
    device = resolve_device(device)
    card = card_line() if device.type == "cuda" else "cpu"
    settings = ExtractorSettings(n_features=400, n_levels=8, scale_factor=1.2, fast_th=20)
    rig, _ = _lafida_rig(device)
    C = rig.n_cams
    W, H = (int(x) for x in rig.cams.wh[0].tolist())
    t0 = time.perf_counter()
    p1 = tracking_phase(rig, settings, device)
    t1 = time.perf_counter()
    lat = _pipeline_latency(rig, settings, device=device)
    t2 = time.perf_counter()
    lat.update(_loop_closure_latency(device=device))
    t3 = time.perf_counter()
    print(f"bench: wall seconds, phase 1 {t1 - t0:.1f}, phase 2 {t2 - t1:.1f}, phase 3 {t3 - t2:.1f}",
          file=sys.stderr, flush=True)
    out = {
        "metric": "tracking_frames_per_s_per_chip",
        "value": p1["fps"],
        "unit": f"frames/s ({C}x{W}x{H} fisheye rig, 400 feats x 8 levels, fused 2-stage tracking, "
                f"{p1['n_inliers']} inliers)",
        "vs_baseline": p1["fps"] / BASELINE_FPS,
        "sync_frame_ms": p1["sync_frame_ms"],
    }
    out.update(lat)
    out["device"] = card
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
