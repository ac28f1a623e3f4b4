"""Synthetic fisheye images of a synthetic world (port of `_patch_window`
and `render_frame` of `multicol_slam_tpu/io/render.py`).

Each landmark visible at the frame's ground-truth pose is stamped as a small
deterministic texture patch, so FAST finds it and its BRIEF descriptor is
distinctive. Rendering is a host-side fixture: numpy, with the projection
through the port's camera model on the CPU (device="cpu", passed
explicitly), whatever device the world's rig is on.
"""
from __future__ import annotations

import numpy as np
import torch

from multicol_slam_tpu_torch.io.synthetic import SyntheticWorld
from multicol_slam_tpu_torch.models.camera import OmniCamera, cam_world_to_img, in_mirror_mask
from multicol_slam_tpu_torch.utils.geometry import cayley_to_hom

PATCH = 29  # stamped texture patch size (odd)


def _patch_window() -> np.ndarray:
    """Radial cosine falloff, so patch edges fade into the background and do
    not ring every landmark with identical boundary corners."""
    r = np.hypot(*np.meshgrid(*[np.arange(PATCH) - PATCH // 2] * 2, indexing="ij"))
    return 0.5 * (1.0 + np.cos(np.clip(r / (PATCH / 2.0), 0, 1) * np.pi))


def _textures(n_pts: int, rng: np.random.Generator) -> np.ndarray:
    """[n_pts, PATCH, PATCH] uint8 landmark textures: one bright blob over
    low-contrast windowed noise, plus a constellation of four satellite
    blobs whose layout is the landmark's descriptor signature and keeps its
    intensity-centroid angle stable."""
    win = _patch_window()
    noise = rng.integers(-12, 13, size=(n_pts, PATCH, PATCH)).astype(np.float64)
    yy, xx = np.meshgrid(*[np.arange(PATCH) - PATCH // 2] * 2, indexing="ij")
    r2 = (yy * yy + xx * xx)[None]
    blob_amp = rng.uniform(100.0, 210.0, size=(n_pts, 1, 1))
    blob = blob_amp * np.exp(-r2 / (2.0 * 1.8 ** 2))
    sat = np.zeros_like(blob)
    for _ in range(4):
        theta = rng.uniform(0, 2 * np.pi, size=n_pts)
        sat_r = rng.uniform(3.5, 9.0, size=n_pts)
        sy, sx = sat_r * np.sin(theta), sat_r * np.cos(theta)
        sat_amp = blob_amp[:, 0, 0] * rng.uniform(0.3, 0.7, size=n_pts)
        sat += sat_amp[:, None, None] * np.exp(
            -((yy[None] - sy[:, None, None]) ** 2 + (xx[None] - sx[:, None, None]) ** 2)
            / (2.0 * 1.7 ** 2))
    raw = 60.0 + noise + blob + sat
    return np.clip(20 + (raw - 20) * win[None], 0, 255).astype(np.uint8)


def render_frame(world: SyntheticWorld, t: int, rng_seed: int = 1234) -> np.ndarray:
    """[C, H, W] uint8 images of the world at ground-truth pose t."""
    rig = world.rig
    cams = OmniCamera(*(getattr(rig.cams, k).detach().cpu() for k in ("pol", "invpol", "cde", "pp", "wh")))
    Mc = rig.Mc.detach().cpu().numpy()
    C = Mc.shape[0]
    W, H = (int(x) for x in cams.wh[0].numpy())
    textures = _textures(len(world.points), np.random.default_rng(rng_seed))
    Mt = cayley_to_hom(torch.tensor(world.poses[t], dtype=torch.float32, device="cpu")).numpy()
    out = np.full((C, H, W), 20, np.uint8)  # dark background
    half = PATCH // 2
    for c in range(C):
        Tinv = np.linalg.inv(Mt @ Mc[c])
        Xc = world.points @ Tinv[:3, :3].T + Tinv[:3, 3]
        uv = cam_world_to_img(cams, c, torch.tensor(Xc, dtype=torch.float32, device="cpu"))
        ok = Xc[:, 2] > 0
        ok &= in_mirror_mask(cams, c, uv).numpy()
        # honor the world's visibility budget
        ok &= np.linalg.norm(Xc, axis=-1) < min(25.0, world.max_vis_dist)
        uv = uv.numpy()
        for i in np.nonzero(ok)[0]:
            u, v = int(round(uv[i, 0])), int(round(uv[i, 1]))
            if half <= u < W - half and half <= v < H - half:
                out[c, v - half : v + half + 1, u - half : u + half + 1] = textures[i]
    if world.noise_px > 0:
        # per-frame sensor noise, seeded by t
        nrng = np.random.default_rng(rng_seed + 7919 * (t + 1))
        out = np.clip(out.astype(np.int16)
                      + nrng.normal(0.0, 12.0 * world.noise_px, out.shape).astype(np.int16),
                      0, 255).astype(np.uint8)
    return out
