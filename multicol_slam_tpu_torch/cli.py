"""Lafida runner CLI, argument-compatible with the reference binary (port of
`multicol_slam_tpu/cli.py`).

Usage (mult_col_slam_lafida.cpp:63-164):
    python3 -m multicol_slam_tpu_torch.cli <path_to_vocabulary> <path_to_settings>
                                           <path_to_calibrations> <path_to_sequence>
                                           [--sync-mapping | --async-mapping] [--metrics PATH]
                                           [--save-map PATH] [--load-map PATH] [--localization]
                                           [--viz DIR [--viz-every N]] [--profile DIR]

Reads `<sequence>/images_and_timestamps.txt` (one line a frame: `timestamp
img0 img1 img2`, :167-198), tracks every frame in [traj.StartFrame,
traj.EndFrame) with a one-frame prefetch, prints the frame times at the end
(:150-158), and writes `MKFTrajectoryLAFIDA.txt` in the working directory in
the Lafida TUM format (cSystem.cpp:260-290). Local mapping and loop closing
run on a worker thread unless --sync-mapping is given. `--metrics PATH`
writes the per-frame metrics as JSON lines with a summary line. The exit
code is 2 when the mapping worker failed on a keyframe (it prints the
traceback and goes on, as the reference does).

  --save-map PATH    the map as a checkpoint at the end (io/checkpoint.py)
  --load-map PATH    resume from a checkpoint: the first frame relocalizes
                     into the loaded map, which is never auto-reset
  --localization     track against the map without changing it (no
                     keyframes, mapping or loop closing)
  --viz DIR          every N-th frame (--viz-every, default 25) the frame's
                     keypoints and the map as PNGs in DIR (io/viz.py; .npz
                     dumps where matplotlib is not installed)
  --profile DIR      a torch.profiler trace of the tracking loop (CPU, and
                     CUDA on the card) as DIR/trace.json; the program's
                     tracer is on meanwhile, so the trace shows its
                     mcs.* ranges (utils/tracing.py) beside the kernels,
                     and its spans and counters of every thread (the
                     worker's too) go to DIR/spans.json

The command line runs on the card; `main([...], device="cpu")` runs the
same on the CPU.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import List, Tuple

import numpy as np

import torch

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE
from multicol_slam_tpu_torch.io.checkpoint import load_map
from multicol_slam_tpu_torch.io.viz import Visualizer
from multicol_slam_tpu_torch.models.vocab import KeyFrameDatabase, load_dbow2_yaml
from multicol_slam_tpu_torch.slam.system import MultiColSLAM
from multicol_slam_tpu_torch.utils import tracing
from multicol_slam_tpu_torch.utils.config import load_rig, load_slam_settings

GRAY = np.asarray([0.299, 0.587, 0.114])   # Camera.RGB's conversion


def load_image_list(path2imgs: str, start: int, end: int) -> Tuple[List[float], List[List[str]]]:
    """The timestamps and the three image paths of lines [start, end) of
    images_and_timestamps.txt (1-based; end <= 0: to the end). A line with
    fewer than four fields ends the list."""
    fn = os.path.join(path2imgs, "images_and_timestamps.txt")
    stamps: List[float] = []
    files: List[List[str]] = []
    with open(fn) as f:
        for cnt, line in enumerate(f, start=1):
            if cnt < start or (end > 0 and cnt >= end):
                continue
            parts = line.split()
            if len(parts) < 4:
                break
            stamps.append(float(parts[0]))
            files.append([os.path.join(path2imgs, p) for p in parts[1:4]])
    return stamps, files


def _read_netpbm(path: str) -> np.ndarray:
    """A binary PGM (P5) as [H, W] or PPM (P6) as [H, W, 3], uint8 (uint16
    when its maximum value exceeds 255)."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:   # magic, width, height, maximum value; '#' comments between
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    pos += 1   # the single whitespace byte before the raster
    channels = 3 if magic == b"P6" else 1
    dtype = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    shape = (h, w, 3) if channels == 3 else (h, w)
    img = np.frombuffer(data, dtype, count=h * w * channels, offset=pos).reshape(shape)
    return img.astype(dtype.newbyteorder("=")) if dtype.itemsize > 1 else img.copy()


def load_gray(path: str) -> np.ndarray:
    """One camera's image as a 2-D array: binary PGM and PPM read with numpy,
    other formats through imageio or pillow when installed. Colour becomes
    gray as Camera.RGB's conversion does."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic in (b"P5", b"P6"):
        img = _read_netpbm(path)
    else:
        try:
            import imageio.v3 as iio

            img = iio.imread(path)
        except ImportError:
            try:
                from PIL import Image
            except ImportError:
                raise RuntimeError(f"{path}: not a binary PGM/PPM, and neither imageio nor pillow is "
                                   "installed to read it") from None
            img = np.asarray(Image.open(path))
    if img.ndim == 3:
        img = (img @ GRAY).astype(np.uint8)
    return img


def main(argv=None, device=DEFAULT_DEVICE) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    metrics_path = None
    viz_dir = None
    viz_every = 25
    save_map_path = None
    load_map_path = None
    profile_dir = None
    localization_only = False
    async_mapping = True   # mapping and loop closing on a worker thread, the reference's layout
    pos = []
    it = iter(argv)
    for a in it:
        if a == "--metrics":
            metrics_path = next(it)
        elif a == "--viz":
            viz_dir = next(it)
        elif a == "--viz-every":
            viz_every = int(next(it))
        elif a == "--save-map":
            save_map_path = next(it)
        elif a == "--load-map":
            load_map_path = next(it)
        elif a == "--profile":
            profile_dir = next(it)
        elif a == "--localization":
            localization_only = True
        elif a == "--sync-mapping":
            async_mapping = False
        elif a == "--async-mapping":
            async_mapping = True
        else:
            pos.append(a)
    if len(pos) != 4:
        print(__doc__)
        return 1
    voc_path, settings_path, calib_dir, seq_dir = pos
    settings = load_slam_settings(settings_path)
    rig = load_rig(calib_dir, device=device)
    voc = None
    if os.path.isfile(voc_path):
        try:
            voc = load_dbow2_yaml(voc_path)
            print(f"loaded vocabulary: {voc.n_words} words (k={voc.k}, L={voc.depth})")
        except Exception as e:  # noqa: BLE001 - the loop closer trains its own instead
            print(f"vocabulary load failed ({e}); loop closer will self-train")
    slam = MultiColSLAM(rig, settings, async_mapping=async_mapping, device=device)
    try:
        if load_map_path is not None:
            slam.resume(load_map(load_map_path))
            print(f"resumed map: {int(slam.store.kf_valid.sum())} keyframes, "
                  f"{int(slam.store.pt_valid.sum())} points")
        if localization_only:
            slam.activate_localization_mode()
        if voc is not None and slam.loop_closer is not None:
            # an empty database: a resumed map's keyframes are not in it
            slam.loop_closer.voc = voc
            slam.loop_closer.db = KeyFrameDatabase(voc)
        viz = Visualizer(viz_dir, every=viz_every) if viz_dir is not None else None
        stamps, files = load_image_list(seq_dir, settings.traj_start_frame, settings.traj_end_frame)
        print(f"tracking {len(stamps)} frames ...")
        profiling = contextlib.nullcontext()
        if profile_dir is not None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if slam.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiling = torch.profiler.profile(activities=activities)
            tracing.enable()
        times = []
        with profiling as prof:
            # one-frame prefetch: the next frame's load and extraction are
            # dispatched before this frame's result is read back
            images = np.stack([load_gray(p) for p in files[0]]) if files else None
            pending = slam.prepare(images) if files else None
            for i, t in enumerate(stamps):
                feats_cur, images_cur = pending, images
                t0 = time.perf_counter()
                h = slam.track_begin(feats=feats_cur, timestamp=t)
                if i + 1 < len(files):
                    images = np.stack([load_gray(p) for p in files[i + 1]])
                    pending = slam.prepare(images)
                m = slam.track_finish(h)
                times.append(time.perf_counter() - t0)
                if viz is not None:
                    viz.update(slam, images_cur, m)
                if i % 50 == 0:
                    print(f"frame {i}: state={m.state} inliers={m.n_inliers} {times[-1] * 1e3:.1f} ms")
        slam.wait_mapping_idle()
        if profile_dir is not None:
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            if slam.device.type == "cuda":
                torch.cuda.synchronize(slam.device)
            with open(os.path.join(profile_dir, "spans.json"), "w") as f:
                json.dump([r.as_dict() for r in tracing.records()], f)
            print(f"profiler trace written to {profile_dir}")
    finally:
        if profile_dir is not None:
            tracing.disable()
            tracing.clear()
        slam.shutdown()
    times_arr = np.asarray(times) * 1e3
    print(f"p95 tracking time:    {np.percentile(times_arr, 95):.2f} ms | worst: {times_arr.max():.2f} ms")
    out = "MKFTrajectoryLAFIDA.txt"
    slam.save_trajectory(out)
    if metrics_path is not None:
        slam.save_metrics(metrics_path)
    if save_map_path is not None:
        slam.save_checkpoint(save_map_path)
    print(f"median tracking time: {np.median(times_arr):.2f} ms")
    print(f"mean tracking time:   {np.mean(times_arr):.2f} ms")
    print(f"trajectory written to {out}")
    if slam.worker_errors:
        print(f"the mapping worker failed on {len(slam.worker_errors)} keyframes (tracebacks above)")
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
