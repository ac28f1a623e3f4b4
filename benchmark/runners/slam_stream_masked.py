"""A camera stream through the running system with mdBRIEF's learned masks,
closed loop at depth 2: benchmark/runners/slam_stream.py's loop (its
`walk`, `Pipeline` and `LocalBACapture`, by import) on a system built with
dBRIEF descriptors and stability masks, so that every matcher takes the
masked distance, checked against the plain masked references
(benchmark/check_masked.py).

Traffic parameters: slam_stream.py's, less `localization` (no masked
cell localizes).

Differences from slam_stream.py:
- `build` passes the configuration's `use_mdbrief` and `learn_masks` to the
  extractor and refuses a system that does not match with masks; the rare
  paths are warmed with masked local points at the system's threshold;
- the sampled frames keep the features' masks and the local map's;
- under --trace 1 only, once the window has closed (the window itself
  runs with the tracer off, as in the other cells), the program's tracer
  (multicol_slam_tpu_torch/utils/tracing.py) is on for `describe_frames`
  frames, then for the traced frames under the profiler, and until the
  worker is idle after them. The describe frames' `features.describe`
  spans give each frame's descriptor time (summed over the levels of one
  `features.extract` span) in `spans["features.describe"]`, and their
  counters the share of mask bits kept; the traced frames' profile gives
  the device time of the kernels whose innermost program range is
  `features.describe`, a frame's sum, in `spans["features.describe_device"]`
  (benchmark/spans.reduce_by_span). A program without those spans leaves
  both lists empty. The `k1` spans' counters give the launches of the
  tracker and of the worker over the whole traced stretch and how many
  were masked (`counters`, and the run's log line).

Traffic parameter of its own: describe_frames (default 8).

The loop is a frozen copy of slam_stream.py's `_run`.
"""
from __future__ import annotations

import gc
import sys
import threading
import time

import numpy as np
import torch

from benchmark import check, check_masked
from benchmark import spans as bs
from benchmark.reference.geometry import Rig
from benchmark.runners.slam_stream import RARE_PATH_MAP, LocalBACapture, Pipeline, walk
from benchmark.trace import DeviceTrace
from benchmark.world import RoomWorld, seed_words


def prewarm_rare_paths(rig, settings, cfg, th_desc, device):
    """slam_stream.py's rare-path shapes, masked: TrackPreviousFrame's
    wide-window fallback and relocalization's confirming stage, on zero
    features against an empty map whose points carry masks."""
    from multicol_slam_tpu_torch.slam.features import FrameFeatures
    from multicol_slam_tpu_torch.slam.tracking_kernels import LocalPoints, track_frame_fused, track_stage

    C, K, B = cfg.n_cams, cfg.feats_per_cam, cfg.desc_bytes
    ex = settings.extractor

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(*shape):
        return torch.full(shape, 255, dtype=torch.uint8, device=device)
    feats = FrameFeatures(uv=z(C, K, 2), response=z(C, K), octave=z(C, K, dtype=torch.int32), angle=z(C, K),
                          rays=z(C, K, 3), desc=z(C, K, B, dtype=torch.uint8), dmask=full(C, K, B),
                          valid=z(C, K, dtype=torch.bool))
    L = RARE_PATH_MAP
    lp = LocalPoints(X=z(L, 3), desc=z(L, B, dtype=torch.uint8), min_dist=z(L), max_dist=torch.ones(L, device=device),
                     valid=z(L, dtype=torch.bool), normal=z(L, 3), dmask=full(L, B))
    mc6, intr, pose = rig.Mc_cayley.to(torch.float32), rig.cams.to_vector(), z(6)
    common = dict(scale_factor=ex.scale_factor, n_levels=ex.n_levels, th_desc=th_desc, use_masks=True)
    track_frame_fused(mc6, intr, rig.cams, feats, pose, lp, lp, radius1=60.0, radius2=40.0, **common)
    track_stage(mc6, intr, rig.cams, feats, pose, lp, radius=8.0, **common)


def build(ctx):
    """(system, world, reference rig) from the configuration, with mdBRIEF's
    masks."""
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
    ex = ExtractorSettings(use_mdbrief=int(s["use_mdbrief"]), learn_masks=int(s["learn_masks"]),
                           n_features=int(s["n_features"]), n_levels=int(s["n_levels"]),
                           scale_factor=float(s["scale_factor"]), fast_th=int(s["fast_th"]),
                           desc_size=int(s["desc_size"]))
    settings = SlamSettings(fps=float(s["fps"]), extractor=ex)
    mcfg = MapConfig(max_keyframes=int(cfg["map"]["max_keyframes"]), max_points=int(cfg["map"]["max_points"]),
                     n_cams=C, feats_per_cam=ex.n_features, n_levels=ex.n_levels, scale_factor=ex.scale_factor)
    slam = MultiColSLAM(rig, settings, mcfg, use_loop_closing=bool(cfg["system"]["use_loop_closing"]),
                        async_mapping=tr["mapping"] == "async", seed=seed_words(ctx.seed) % (2 ** 32),
                        device=dev)
    if not slam.use_masks:
        raise ValueError(f"the configuration {cfg['name']!r} does not give a system with mdBRIEF's masks")
    if slam.loop_closer is not None:
        voc = build_vocabulary(world.train_descs.cpu().numpy(), k=int(cfg["vocabulary"]["k"]),
                               depth=int(cfg["vocabulary"]["depth"]), device=dev)
        slam.loop_closer.voc = voc
        slam.loop_closer.db = KeyFrameDatabase(voc)
    prewarm_rare_paths(rig, settings, mcfg, slam.th_track, dev)
    return slam, world, ref_rig


def run(ctx):
    from multicol_slam_tpu_torch.ops import best_match
    from multicol_slam_tpu_torch.slam import local_mapping
    from multicol_slam_tpu_torch.slam.system import WORKING
    from multicol_slam_tpu_torch.utils import tracing

    capture = LocalBACapture(local_mapping.bundle_adjust_interruptible)
    local_mapping.bundle_adjust_interruptible = capture
    try:
        return _run(ctx, capture, best_match, WORKING, tracing)
    finally:
        local_mapping.bundle_adjust_interruptible = capture.real
        tracing.disable()
        tracing.clear()


def describe_ms(records) -> list:
    """Per `features.extract` span: the milliseconds of its
    `features.describe` children."""
    per = {r.id: 0.0 for r in records if r.name == "features.extract"}
    for r in records:
        if r.name == "features.describe" and r.parent in per:
            per[r.parent] += r.ms
    return list(per.values())


def describe_device_ms(events) -> list:
    """Per `features.extract` range of a profile (`spans.profile_events`):
    the device milliseconds of the kernels whose innermost program range is
    `features.describe`."""
    kernels, ops, calls, notes = events
    out = []
    for name, a, b, tid in notes:
        if name != "features.extract":
            continue
        inside = [n for n in notes if n[3] == tid and a <= n[1] and n[2] <= b]
        by = bs.reduce_by_span(kernels, ops, calls, inside)["device_by_span"]
        if "features.describe" in by:
            out.append(by["features.describe"]["s"] * 1e3)
    return out


def k1_counts(records, tracker_tid: int) -> dict:
    """The `k1` launches of the tracker's thread and of the others (the
    worker), and how many of each were masked."""
    out = dict.fromkeys(("k1_tracker", "k1_tracker_masked", "k1_worker", "k1_worker_masked"), 0)
    for r in records:
        if r.name == "k1":
            who = "k1_tracker" if r.tid == tracker_tid else "k1_worker"
            out[who] += 1
            out[who + "_masked"] += int(r.counts.get("masked", 0))
    return out


def mask_bits_kept(records) -> float | None:
    """The share of mask bits kept over the valid slots of the
    `features.describe` records (their counters read: a host sync)."""
    kept = n = 0.0
    for r in records:
        if r.name == "features.describe" and r.counts:
            c = r.read_counts()
            kept += c["mask_bits_kept"] * c["keypoints"]
            n += c["keypoints"]
    return kept / n if n else None


def _run(ctx, capture, best_match, WORKING, tracing):
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
        # after the window, so that its spans and clocks are the tracer's-
        # and the profiler's-free ones
        pipe.record_spans = False
        tracing.clear()
        tracing.enable()
        for _ in range(int(tr.get("describe_frames", 8))):
            pipe.step(next(frames))
        described = tracing.records()
        out.spans["features.describe"] = describe_ms(described)
        k1_before = best_match.KERNEL.launches
        with DeviceTrace(True) as dt:
            for _ in range(int(tr["trace_frames"])):
                pipe.step(next(frames))
        out.trace = dt.summary()
        out.counters["k1_launches_traced"] = best_match.KERNEL.launches - k1_before
        out.spans["features.describe_device"] = (describe_device_ms(bs.profile_events(dt.prof))
                                                 if dt.prof is not None else [])
    pipe.drain()
    end = pipe.window[1]
    lat = [(f - b) * 1e3 for b, f, _ in pipe.begun]
    out.attempted = len(pipe.begun)
    out.failed = sum(1 for _, _, s in pipe.begun if s != WORKING)
    done_in_window = sum(1 for _, f, _ in pipe.begun if f <= end)
    out.metrics["frames_per_s"] = done_in_window / ctx.seconds
    out.metrics["pose_latency_p95_ms"] = float(np.percentile(lat, 95)) if lat else float("nan")
    out.spans.update(pipe.spans)
    slam.wait_mapping_idle()
    capture.open = False
    if ctx.trace:
        out.counters.update(k1_counts(tracing.records(), threading.get_native_id()))
        kept = mask_bits_kept(described)
        if kept is not None:
            out.counters["mask_bits_kept"] = kept
        tracing.disable()
        tracing.clear()
        del described
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
    print(f"slam_stream_masked: {out.attempted} frames in the window, {done_in_window} back inside it, "
          f"{len(lat)} latency samples, p95 {out.metrics['pose_latency_p95_ms']:.1f} ms, "
          f"setup {out.metrics['setup_s']:.2f} s, checked frames {[s is not None for s in samples]}, "
          f"local BAs {len(solves)} (iterations {[r['iters'] for r in solves]}), "
          f"counters {out.counters}, host loop {out.host}", file=sys.stderr, flush=True)
    del slam, pipe, world, solves
    capture.solves = []
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out.compared = check_masked.slam_frames([s for s in samples if s is not None], ref_rig, ctx.config["settings"],
                                            control=ctx.control)
    out.compared["failed_share"] = out.failed / max(out.attempted, 1)
    if n_lba:
        out.compared.update(check.local_ba(picked, ref_rig, ctx.config["local_ba"], control=ctx.control))
    return out


def _keep(sample, working):
    """The sampled frame's inputs and outputs as plain tensors, masks
    included, or None when its frame did not run the fused tracking
    program."""
    h = sample.pop("handle")
    if h.packed is None or h.done or sample["state"] != working:
        return None
    f = sample["feats"]
    lp = h.lp2
    return dict(images=sample["images"].clone(),
                feats={k: getattr(f, k) for k in ("uv", "octave", "response", "angle", "desc", "dmask", "valid")},
                pts=dict(X=lp.X, desc=lp.desc, dmask=lp.dmask, min_dist=lp.min_dist, max_dist=lp.max_dist,
                         valid=lp.valid, normal=lp.normal),
                last_pose=sample["last_pose"], velocity=sample["velocity"], packed=h.packed.detach().cpu().numpy())
