#!/usr/bin/env python3
"""Drive the PyTorch port's per-frame tracking step once on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. device: the card's name and power limit; TF32 off; the best-match
     kernel built from `multicol_slam_tpu_torch/csrc/best_match.cu`.
  2. kernel: the kernel against its plain PyTorch version on the card, at
     the tracking shape (3 cameras, 400 queries, 4096 targets, 32-byte
     descriptors), plain and masked, shared and per-camera targets, ragged
     sizes, one camera, ties and an all-disabled case. All four outputs
     must be exactly equal.
  3. slice: one frame of the tracking step at full Lafida width (3 cameras
     of 754x480, 400 features, 8 levels, local map of 4096 points):
     extract_features -> track_frame_fused. Checks the inlier count, that
     the kernel ran twice, and that the plain matcher gives the same answer.
  4. timing: 30 frames after warm-up, and the kernel against its plain
     version at the tracking shape.
Then one JSON line of kernels, and last {"ok": true, "device": {...}}.
Any failure raises and exits non-zero. Needs one card; no CPU fallback.
"""
import json
import subprocess
import sys
import time

import numpy as np

C, H, W = 3, 480, 754
Q, T, B = 400, 4096, 32
N_FRAMES = 30
KERNEL_REPS = 50
# 754x480 fisheye rig of the Lafida family (polynomials of the indoor set)
POL = [-209.2, 0.0, 0.0021, -4.2e-06, 1.77e-08]
INVPOL = [293.7, 150.0, -10.4, 28.2, 7.1, 0.06, 10.4, 0.17, -5.9, 1.18, 3.1, 0.81]
# camera -> body extrinsics: identity rotations, cameras 1 and 2 offset 0.2 m in x / y
MC_CAYLEY = [[0.0] * 6, [0.0, 0.0, 0.0, 0.2, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.2, 0.0]]
# ~0.5 deg rotation + 3 cm translation: a motion-model prediction error
POSE0 = [0.002, -0.003, 0.002, 0.02, -0.015, 0.01]


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def match_problem(rng, C, Q, T, shared, masked, frac_t=0.8, ties=False, B=B):
    """Random inputs of the best-match kernel on a 754x480 image."""
    if ties:  # few distinct descriptors and integer positions: many equal distances
        pool = rng.integers(0, 256, (4, B), dtype=np.uint8)
        dq = pool[rng.integers(0, 4, (C, Q))]
        dt = pool[rng.integers(0, 4, (T,) if shared else (C, T))]
    else:
        dq = rng.integers(0, 256, (C, Q, B), dtype=np.uint8)
        dt = rng.integers(0, 256, (T, B) if shared else (C, T, B), dtype=np.uint8)
    args = dict(
        desc_q=dq,
        uv_q=np.stack([rng.uniform(0, W, (C, Q)), rng.uniform(0, H, (C, Q))], -1),
        oct_q=rng.integers(0, 8, (C, Q)).astype(np.int32),
        desc_t=dt,
        uv_t=np.stack([rng.uniform(0, W, (C, T)), rng.uniform(0, H, (C, T))], -1),
        rad_t=np.where(rng.uniform(size=(C, T)) < frac_t, rng.uniform(15, 60, (C, T)), -1.0),
        lvl_t=rng.integers(0, 8, (C, T)),
        rad_q=np.where(rng.uniform(size=(C, Q)) < 0.9, 1e9, -1.0),
    )
    if ties:
        args["uv_q"] = np.round(args["uv_q"] / 8) * 8
        args["uv_t"] = np.round(args["uv_t"] / 8) * 8
    if masked:
        args["mask_q"] = rng.integers(0, 256, dq.shape, dtype=np.uint8)
        args["mask_t"] = rng.integers(0, 256, dt.shape, dtype=np.uint8)
    return args


def to_device(args, dev):
    import torch

    out = {}
    for k, v in args.items():
        v = np.asarray(v)
        if v.dtype == np.float64:
            v = v.astype(np.float32)
        out[k] = torch.tensor(v, device=dev)
    return out


def phase_kernel(dev):
    """Kernel == plain on every case, exactly. Returns the largest |error|."""
    import torch
    from multicol_slam_tpu_torch.ops.best_match import (
        masked_best_match_cams, masked_best_match_cams_plain,
    )

    rng = np.random.default_rng(1)
    cases = {
        "slice shared desc_t": match_problem(rng, C, Q, T, True, False),
        "slice shared masked": match_problem(rng, C, Q, T, True, True),
        "slice per-camera desc_t": match_problem(rng, C, Q, T, False, False),
        "slice per-camera masked": match_problem(rng, C, Q, T, False, True),
        "ragged Q=37 T=1001": match_problem(rng, C, 37, 1001, True, False),
        "ragged masked Q=37 T=1001": match_problem(rng, C, 37, 1001, False, True),
        "one camera": match_problem(rng, 1, Q, T, False, False),
        "ties": match_problem(rng, C, Q, T, True, False, ties=True),
        "all disabled": match_problem(rng, C, Q, T, True, False, frac_t=0.0),
        "16-byte descriptors": match_problem(rng, C, Q, T, True, True, B=16),
        "64-byte descriptors": match_problem(rng, C, Q, T, False, False, B=64),
    }
    worst = 0.0
    for name, args in cases.items():
        a = to_device(args, dev)
        got = masked_best_match_cams(**a, level_tol=1.0)
        ref = masked_best_match_cams_plain(**a, level_tol=1.0)
        torch.cuda.synchronize()
        for label, x, y in zip(("best", "second", "idx", "col_best"), got, ref):
            if not torch.equal(x, y):
                bad = int((x != y).sum())
                raise AssertionError(f"kernel != plain on '{name}': {label} differs in {bad} entries")
            worst = max(worst, float((x.double() - y.double()).abs().max()))
        n_match = int((got[2] >= 0).sum())
        if (n_match == 0) != (name == "all disabled"):
            raise AssertionError(f"'{name}': {n_match} queries matched")
        log(f"kernel: '{name}' exactly equal (tolerance 0) on best/second/idx/col_best "
            f"({n_match} queries matched)")
    return worst


def build_slice(dev):
    """Rig, extractor tables, images and the local map of the tracking step."""
    import torch
    from multicol_slam_tpu_torch.models.camera import OmniCamera
    from multicol_slam_tpu_torch.models.rig import MultiCamRig
    from multicol_slam_tpu_torch.slam.features import ExtractorTables, extract_features
    from multicol_slam_tpu_torch.slam.tracking_kernels import LocalPoints
    from multicol_slam_tpu_torch.utils.config import ExtractorSettings

    settings = ExtractorSettings(n_features=400, n_levels=8, scale_factor=1.2, fast_th=20)
    cams = OmniCamera.from_params([POL] * C, [INVPOL] * C, [[1.0, 0.0, 0.0]] * C,
                                  [[W / 2.0, H / 2.0]] * C, [[W, H]] * C, device=dev)
    rig = MultiCamRig.from_cayley(cams, torch.tensor(MC_CAYLEY, dtype=torch.float32, device=dev))
    tables = ExtractorTables(settings, H, W, device=dev)
    rng = np.random.default_rng(0)
    images = torch.tensor(rng.integers(0, 256, (C, H, W), dtype=np.uint8), device=dev)
    # local map: each valid keypoint's ray pushed to a depth in [3, 12] m
    # through its camera's extrinsics, with its real descriptor
    f0 = extract_features(images, rig.cams, settings, tables)
    valid, rays, desc = (getattr(f0, k).cpu().numpy() for k in ("valid", "rays", "desc"))
    Mc = rig.Mc.cpu().numpy()
    Xs, Ds = [], []
    for c in range(C):
        v = valid[c]
        depth = rng.uniform(3.0, 12.0, v.sum()).astype(np.float32)
        Xc = rays[c][v] * depth[:, None]
        Xs.append((Mc[c, :3, :3] @ Xc.T).T + Mc[c, :3, 3])
        Ds.append(desc[c][v])
    L = 4096
    X = np.concatenate(Xs)[:L].astype(np.float32)
    D = np.concatenate(Ds)[:L]
    n = len(X)
    pts = LocalPoints(
        X=torch.tensor(np.pad(X, ((0, L - n), (0, 0))), device=dev),
        desc=torch.tensor(np.pad(D, ((0, L - n), (0, 0))), device=dev),
        min_dist=torch.full((L,), 0.5, device=dev),
        max_dist=torch.full((L,), 40.0, device=dev),
        valid=torch.arange(L, device=dev) < n,
    )
    pose0 = torch.tensor(POSE0, dtype=torch.float32, device=dev)
    return settings, rig, tables, images, pts, pose0, n


def phase_slice(dev, state):
    import torch
    from multicol_slam_tpu_torch.ops.best_match import KERNEL, masked_best_match_cams_plain
    from multicol_slam_tpu_torch.slam.features import extract_features
    from multicol_slam_tpu_torch.slam.tracking_kernels import track_frame_fused, unpack_fused

    settings, rig, tables, images, pts, pose0, n_pts = state
    mc6, intr = rig.Mc_cayley, rig.cams.to_vector()

    def frame(match_fn=None):
        feats = extract_features(images, rig.cams, settings, tables)
        extra = {} if match_fn is None else {"match_fn": match_fn}
        return feats, track_frame_fused(mc6, intr, rig.cams, feats, pose0, pts, pts,
                                        radius1=15.0, radius2=4.0, th_desc=96.0, **extra)

    KERNEL.launches = 0
    feats, packed = frame()
    torch.cuda.synchronize()
    launches = KERNEL.launches
    p = packed.cpu().numpy()
    pose1, n1, pose2, n_match2, n_inl2, assign2, inl2 = unpack_fused(p)
    K = feats.uv.shape[1]
    if p.shape != (7 + 8 + 2 * C * K,) or not np.isfinite(p).all():
        raise AssertionError(f"packed output malformed: shape {p.shape}, finite {np.isfinite(p).all()}")
    log(f"slice: {C}x{W}x{H}, {int(feats.valid.sum())} valid features of {C}x{K}, "
        f"local map {n_pts} of 4096 points")
    log(f"slice: stage 1 inliers {n1}, stage 2 matches {n_match2} inliers {n_inl2}, "
        f"pose2 {np.array2string(pose2, precision=6)}")
    if n_inl2 < 100:
        raise AssertionError(f"stage-2 inliers {n_inl2} < 100")
    if launches != 2:
        raise AssertionError(f"best-match kernel launched {launches} times in one frame, expected 2")
    _, packed_plain = frame(masked_best_match_cams_plain)
    q = unpack_fused(packed_plain.cpu().numpy())
    if not (np.array_equal(q[5], assign2) and np.array_equal(q[6], inl2) and q[4] == n_inl2):
        raise AssertionError("plain matcher gives another assignment or inlier set")
    dpose = float(np.abs(q[2] - pose2).max())
    if dpose > 1e-5:
        raise AssertionError(f"plain matcher pose differs by {dpose}")
    log(f"slice: kernel launches in one frame = {launches}; plain matcher: same assignment "
        f"and inliers, pose within {dpose:.2e}")
    return launches, frame


def time_cuda(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(dev, state, frame, card):
    import torch
    from multicol_slam_tpu_torch.ops.best_match import (
        masked_best_match_cams, masked_best_match_cams_plain,
    )
    from multicol_slam_tpu_torch.slam.features import extract_features
    from multicol_slam_tpu_torch.slam.tracking_kernels import track_frame_fused

    settings, rig, tables, images, pts, pose0, _ = state
    mc6, intr = rig.Mc_cayley, rig.cams.to_vector()
    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(N_FRAMES)]
    t0 = time.perf_counter()
    for e0, e1, e2 in ev:
        e0.record()
        feats = extract_features(images, rig.cams, settings, tables)
        e1.record()
        track_frame_fused(mc6, intr, rig.cams, feats, pose0, pts, pts,
                          radius1=15.0, radius2=4.0, th_desc=96.0)
        e2.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ext_ms = float(np.mean([a.elapsed_time(b) for a, b, _ in ev]))
    trk_ms = float(np.mean([b.elapsed_time(c) for _, b, c in ev]))
    log(f"timing: {N_FRAMES} frames in {wall:.4f} s = {N_FRAMES / wall:.3f} frames/s; "
        f"extraction {ext_ms:.3f} ms, tracking {trk_ms:.3f} ms per frame (CUDA events) [{card}]")
    plain_trk = time_cuda(lambda: frame(masked_best_match_cams_plain), 5)
    log(f"timing: one frame with the plain matcher {plain_trk:.3f} ms (CUDA events) [{card}]")
    a = to_device(match_problem(np.random.default_rng(2), C, Q, T, True, False), dev)
    kern = lambda: masked_best_match_cams(**a)
    plain = lambda: masked_best_match_cams_plain(**a)
    time_cuda(kern, 5), time_cuda(plain, 5)
    ms = [time_cuda(f, KERNEL_REPS) for f in (plain, kern, kern, plain)]
    plain_ms, kern_ms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
    log(f"timing: best-match at C={C} Q={Q} T={T} B={B}: kernel {kern_ms * 1e3:.2f} us, "
        f"plain {plain_ms * 1e3:.2f} us (runs plain/kernel/kernel/plain: "
        f"{', '.join(f'{x * 1e3:.2f}' for x in ms)} us) [{card}]")
    return kern_ms, plain_ms


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from multicol_slam_tpu_torch.ops.best_match import KERNEL

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name}; nvidia-smi: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = KERNEL.build()
    log(f"device: built {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"device: ptxas {line.strip()}")

    max_err = phase_kernel(dev)
    state = build_slice(dev)
    launches, frame = phase_slice(dev, state)
    kern_ms, plain_ms = phase_timing(dev, state, frame, card)

    log(json.dumps({"kernels": [{
        "name": "masked_best_match_cams",
        "route": "cuda",
        "source": "multicol_slam_tpu_torch/csrc/best_match.cu",
        "replaces": "multicol_slam_tpu/ops/pallas_match.py:200",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }]}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
