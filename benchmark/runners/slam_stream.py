"""A camera stream through the running system, closed loop at depth 2.

Traffic parameters (benchmark/traffic/<name>.json):
  mapping        "async": the CLI's default, keyframes mapped and loops
                 closed on the worker thread; "sync": mapped inline
  warm_frames    the walk's first frames, tracked in set-up (the bootstrap
                 and the first keyframes); through the depth-2 loop when
                 mapping is async, one at a time when it is sync
  localization   true: after the warm frames the system switches to
                 localization mode (no keyframes, mapping or loop closing)
  walk           after the warm frames, "forward" (the default): on and on,
                 laps repeating; "back_and_forth": back over the warm
                 frames to 0 and forward again, over and over
  render_frames  frames of the walk rendered in set-up (the rest are
                 rendered when the stream reaches them)
  settle_frames  frames of the walk run through the loop after the
                 warm frames and before the window
  check_frames   frames the output check compares, one in each equal part
                 of the window, at a time drawn from the seed
  check_local_ba local-BA solves that the output check re-solves, drawn
                 from the seed among those begun from the window's start
                 until the worker is idle after it (mapping cells)
  trace_frames   frames profiled right after the window in a traced run

The loop is a frozen copy of the port bench's depth-2 software pipeline:
an iteration begins frame t (`track_begin`: the fused tracking program's
dispatch), extracts frame t + 1 (`prepare`), and finishes the oldest frame
once two are in flight (`track_finish`: the pose read back). A frame's
latency runs from its begin to its finish. The window starts with the
first iteration after set-up and lasts the run's seconds; frames_per_s
counts the frames whose pose came back inside it.

The local BA of the mapping worker (the program's
`bundle_adjust_interruptible`, as local mapping calls it) is watched for
the output check: the harness swaps in a wrapper that keeps the inputs,
the iterations run and the result of every solve begun from the window's
start until the worker has mapped the window's last keyframe, and puts the
program's own function back when the run ends.
"""
from __future__ import annotations

import gc
import sys
import time
from collections import deque

import numpy as np
import torch

from benchmark import check
from benchmark.reference.geometry import Rig
from benchmark.trace import DeviceTrace, host_range
from benchmark.world import RoomWorld, seed_words

DEPTH = 2
RARE_PATH_MAP = 4096


def walk(traffic: dict, warm: int):
    """Frame indices of the walk: the warm frames 0 .. warm - 1, then on."""
    yield from range(warm)
    if traffic.get("walk", "forward") == "forward":
        t = warm
        while True:
            yield t
            t += 1
    last = warm - 1
    t, step = last, -1
    while True:
        t += step
        if t < 0 or t > last:
            step = -step
            t += 2 * step
        yield t


def prewarm_rare_paths(rig, settings, cfg, device):
    """The rare-path shapes once before the window (a frozen copy of the port
    bench's): TrackPreviousFrame's wide-window fallback and relocalization's
    confirming stage, on zero features against an empty map."""
    from multicol_slam_tpu_torch.slam.features import FrameFeatures
    from multicol_slam_tpu_torch.slam.tracking_kernels import LocalPoints, track_frame_fused, track_stage

    C, K, B = cfg.n_cams, cfg.feats_per_cam, cfg.desc_bytes
    ex = settings.extractor

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    feats = FrameFeatures(uv=z(C, K, 2), response=z(C, K), octave=z(C, K, dtype=torch.int32), angle=z(C, K),
                          rays=z(C, K, 3), desc=z(C, K, B, dtype=torch.uint8),
                          dmask=torch.full((C, K, B), 255, dtype=torch.uint8, device=device),
                          valid=z(C, K, dtype=torch.bool))
    L = RARE_PATH_MAP
    lp = LocalPoints(X=z(L, 3), desc=z(L, B, dtype=torch.uint8), min_dist=z(L), max_dist=torch.ones(L, device=device),
                     valid=z(L, dtype=torch.bool), normal=z(L, 3))
    mc6, intr, pose = rig.Mc_cayley.to(torch.float32), rig.cams.to_vector(), z(6)
    common = dict(scale_factor=ex.scale_factor, n_levels=ex.n_levels, th_desc=3.0 * B)
    track_frame_fused(mc6, intr, rig.cams, feats, pose, lp, lp, radius1=60.0, radius2=40.0, **common)
    track_stage(mc6, intr, rig.cams, feats, pose, lp, radius=8.0, **common)


def build(ctx):
    """(system, world, reference rig) from the configuration."""
    from multicol_slam_tpu_torch.models.camera import OmniCamera
    from multicol_slam_tpu_torch.models.rig import MultiCamRig
    from multicol_slam_tpu_torch.models.vocab import KeyFrameDatabase, build_vocabulary
    from multicol_slam_tpu_torch.slam.map_store import MapConfig
    from multicol_slam_tpu_torch.slam.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils.config import ExtractorSettings, SlamSettings

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    r, s = cfg["rig"], cfg["settings"]
    C, W, H = int(r["n_cams"]), float(r["width"]), float(r["height"])
    cams = OmniCamera.from_params([r["pol"]] * C, [r["invpol"]] * C, [[1.0, 0.0, 0.0]] * C, [[W / 2, H / 2]] * C,
                                  [[W, H]] * C, device=dev)
    rig = MultiCamRig.from_cayley(cams, torch.tensor(r["mc_cayley"][:C], dtype=torch.float32, device=dev))
    ref_rig = Rig(r, dev)
    world = RoomWorld(cfg["world"], ref_rig, ctx.seed, dev, n_render=int(tr.get("render_frames", 0)))
    ex = ExtractorSettings(n_features=int(s["n_features"]), n_levels=int(s["n_levels"]),
                           scale_factor=float(s["scale_factor"]), fast_th=int(s["fast_th"]),
                           desc_size=int(s["desc_size"]))
    settings = SlamSettings(fps=float(s["fps"]), extractor=ex)
    mcfg = MapConfig(max_keyframes=int(cfg["map"]["max_keyframes"]), max_points=int(cfg["map"]["max_points"]),
                     n_cams=C, feats_per_cam=ex.n_features, n_levels=ex.n_levels, scale_factor=ex.scale_factor)
    slam = MultiColSLAM(rig, settings, mcfg, use_loop_closing=bool(cfg["system"]["use_loop_closing"]),
                        async_mapping=tr["mapping"] == "async", seed=seed_words(ctx.seed) % (2 ** 32),
                        device=dev)
    if slam.loop_closer is not None:
        voc = build_vocabulary(world.train_descs.cpu().numpy(), k=int(cfg["vocabulary"]["k"]),
                               depth=int(cfg["vocabulary"]["depth"]), device=dev)
        slam.loop_closer.voc = voc
        slam.loop_closer.db = KeyFrameDatabase(voc)
    prewarm_rare_paths(rig, settings, mcfg, dev)
    return slam, world, ref_rig


class Pipeline:
    """The depth-2 loop with its clocks and the samples the check keeps."""

    def __init__(self, slam, world, sample_fracs=()):
        self.slam, self.world = slam, world
        self.inflight = deque()
        self.pending = None
        self.n = 0                 # frames begun
        self.window = None         # (start, end) perf_counter
        self.open = False          # frames begun now belong to the window
        self.begun = []            # per window frame: [begin_t, finish_t, state]
        self.spans = {"track_begin": [], "prepare": [], "track_finish": []}
        self.record_spans = True
        self.sample_fracs = list(sample_fracs)
        self.samples = []

    def prepare(self, t):
        images = self.world.frame(t)
        t0 = time.perf_counter()
        with host_range("prepare"):
            feats = self.slam.prepare(images)
        if self.record_spans:
            self.spans["prepare"].append((time.perf_counter() - t0) * 1e3)
        return t, images, feats

    def step(self, next_t):
        """One iteration: begin the pending frame, prepare next_t, finish the
        oldest when DEPTH are in flight."""
        slam = self.slam
        t, images, feats = self.pending
        sample = None
        now = time.perf_counter()
        if self.open and self.sample_fracs and now >= self.window[0] + self.sample_fracs[0] * (
                self.window[1] - self.window[0]) and not getattr(slam, "_force_reloc", False):
            self.sample_fracs.pop(0)
            sample = dict(images=images, feats=feats, last_pose=slam.last_pose.copy(),
                          velocity=slam.velocity.copy(), state=slam.state)
        t0 = time.perf_counter()
        with host_range("track_begin"):
            h = slam.track_begin(feats=feats, timestamp=self.n / 25.0)
        t1 = time.perf_counter()
        if self.record_spans:
            self.spans["track_begin"].append((t1 - t0) * 1e3)
        self.n += 1
        rec = None
        if self.open:
            rec = [t0, None, None]
            self.begun.append(rec)
        if sample is not None:
            sample["handle"] = h
            self.samples.append(sample)
        self.inflight.append((h, rec))
        self.pending = self.prepare(next_t)
        if len(self.inflight) >= DEPTH:
            self.finish()

    def finish(self):
        h, rec = self.inflight.popleft()
        t0 = time.perf_counter()
        with host_range("track_finish"):
            m = self.slam.track_finish(h)
        t1 = time.perf_counter()
        if self.record_spans:
            self.spans["track_finish"].append((t1 - t0) * 1e3)
        if rec is not None:
            rec[1], rec[2] = t1, m.state

    def drain(self):
        while self.inflight:
            self.finish()


class LocalBACapture:
    """Stands in for local mapping's `bundle_adjust_interruptible`: calls the
    program's function and, for the solves begun while `open`, keeps their
    inputs, the iterations they ran (counted at each chunk's pre-step, as
    the solve runs a whole chunk after it) and their result."""

    def __init__(self, real):
        self.real = real
        self.open = False
        self.solves = []

    def __call__(self, params, obs, free, max_iters=15, cg_iters=20, interrupt=None, chunk_iters=1,
                 pre_step=None):
        if not self.open:
            return self.real(params, obs, free, max_iters=max_iters, cg_iters=cg_iters, interrupt=interrupt,
                             chunk_iters=chunk_iters, pre_step=pre_step)
        rec = dict(poses=params.poses.clone(), points=params.points.clone(), kf=obs.kf.clone(),
                   pt=obs.pt.clone(), cam=obs.cam.clone(), uv=obs.uv.clone(), inv_sigma2=obs.inv_sigma2.clone(),
                   valid=obs.valid.clone(), free_poses=free.poses.clone(), free_points=free.points.clone(),
                   cg_iters=int(cg_iters), iters=0)

        def counted():
            if pre_step is not None:
                pre_step()
            rec["iters"] += min(max(chunk_iters, 1), max_iters - rec["iters"])
        out, cost = self.real(params, obs, free, max_iters=max_iters, cg_iters=cg_iters, interrupt=interrupt,
                              chunk_iters=chunk_iters, pre_step=counted)
        rec.update(out_poses=out.poses.detach().clone(), out_points=out.points.detach().clone(),
                   out_cost=cost.detach().clone())
        self.solves.append(rec)
        return out, cost


def run(ctx):
    from multicol_slam_tpu_torch.ops import best_match
    from multicol_slam_tpu_torch.slam import local_mapping
    from multicol_slam_tpu_torch.slam.system import WORKING

    capture = LocalBACapture(local_mapping.bundle_adjust_interruptible)
    local_mapping.bundle_adjust_interruptible = capture
    try:
        return _run(ctx, capture, best_match, WORKING)
    finally:
        local_mapping.bundle_adjust_interruptible = capture.real


def _run(ctx, capture, best_match, WORKING):
    from benchmark.run import Outcome, close_window, open_window

    tr, dev = ctx.traffic, ctx.device
    out = Outcome()
    slam, world, ref_rig = build(ctx)
    warm = int(tr["warm_frames"])
    rng = np.random.default_rng(seed_words(ctx.seed) + 1)
    n_check = int(tr["check_frames"])
    pipe = Pipeline(slam, world, [(i + rng.uniform()) / n_check for i in range(n_check)])
    frames = walk(tr, warm)
    if tr["mapping"] == "sync":
        for _ in range(warm):
            slam.track(images=world.frame(next(frames)), timestamp=pipe.n / 25.0)
            pipe.n += 1
    if tr.get("localization"):
        slam.activate_localization_mode()
    pipe.pending = pipe.prepare(next(frames))
    if tr["mapping"] == "async":
        for _ in range(warm):
            pipe.step(next(frames))
    for _ in range(int(tr.get("settle_frames", 0))):
        pipe.step(next(frames))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    for v in pipe.spans.values():
        v.clear()
    start = open_window(out)
    pipe.window, pipe.open, capture.open = (start, start + ctx.seconds), True, True
    out.metrics["setup_s"] = ctx.setup_s(start)
    while time.perf_counter() < pipe.window[1]:
        pipe.step(next(frames))
    pipe.open = False
    close_window(out)
    if ctx.trace:
        # the traced frames follow the window, so that its spans and clocks
        # are the profiler's-free ones
        pipe.record_spans = False
        k1_before = best_match.KERNEL.launches
        with DeviceTrace(True) as dt:
            for _ in range(int(tr["trace_frames"])):
                pipe.step(next(frames))
        out.trace = dt.summary()
        out.counters["k1_launches_traced"] = best_match.KERNEL.launches - k1_before
    pipe.drain()
    end = pipe.window[1]
    lat = [(f - b) * 1e3 for b, f, _ in pipe.begun]
    out.attempted = len(pipe.begun)
    out.failed = sum(1 for _, _, s in pipe.begun if s != WORKING)
    done_in_window = sum(1 for _, f, _ in pipe.begun if f <= end)
    out.metrics["frames_per_s"] = done_in_window / ctx.seconds
    out.metrics["pose_latency_p95_ms"] = float(np.percentile(lat, 95)) if lat else float("nan")
    out.spans = pipe.spans
    slam.wait_mapping_idle()
    capture.open = False
    if slam.worker_errors:
        out.errors.append(f"mapping worker: {slam.worker_errors[0]!r}")
    slam.shutdown()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    samples = [_keep(s, WORKING) for s in pipe.samples]
    n_lba = int(tr.get("check_local_ba", 0))
    solves = capture.solves
    picked = [solves[i] for i in sorted(rng.choice(len(solves), min(n_lba, len(solves)), replace=False))]
    print(f"slam_stream: {out.attempted} frames in the window, {done_in_window} back inside it, "
          f"{len(lat)} latency samples, p95 {out.metrics['pose_latency_p95_ms']:.1f} ms, "
          f"setup {out.metrics['setup_s']:.2f} s, checked frames {[s is not None for s in samples]}, "
          f"local BAs {len(solves)} (iterations {[r['iters'] for r in solves]}), "
          f"host loop {out.host}", file=sys.stderr, flush=True)
    del slam, pipe, world, solves
    capture.solves = []
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out.compared = check.slam_frames([s for s in samples if s is not None], ref_rig, ctx.config["settings"],
                                     control=ctx.control)
    out.compared["failed_share"] = out.failed / max(out.attempted, 1)
    if n_lba:
        out.compared.update(check.local_ba(picked, ref_rig, ctx.config["local_ba"], control=ctx.control))
    return out


def _keep(sample, working):
    """The sampled frame's inputs and outputs as plain tensors, or None when
    its frame did not run the fused tracking program."""
    h = sample.pop("handle")
    if h.packed is None or h.done or sample["state"] != working:
        return None
    f = sample["feats"]
    lp = h.lp2
    return dict(images=sample["images"].clone(),
                feats={k: getattr(f, k) for k in ("uv", "octave", "response", "angle", "desc", "valid")},
                pts=dict(X=lp.X, desc=lp.desc, min_dist=lp.min_dist, max_dist=lp.max_dist, valid=lp.valid,
                         normal=lp.normal),
                last_pose=sample["last_pose"], velocity=sample["velocity"], packed=h.packed.detach().cpu().numpy())
