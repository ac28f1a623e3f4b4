"""Synthetic fisheye images of a synthetic world, and the Lafida-layout
dataset written from them (port of `multicol_slam_tpu/io/render.py`).

Each landmark visible at the frame's ground-truth pose is stamped as a small
deterministic texture patch, so FAST finds it and its BRIEF descriptor is
distinctive. Rendering is a host-side fixture: numpy, with the projection
through the port's camera model on the CPU (device="cpu", passed
explicitly), whatever device the world's rig is on. `write_dataset` writes
the images as PGM with images_and_timestamps.txt and the three YAML
schemas, so the CLI runs on it as it would on Lafida; its files are
byte-identical to the reference's for the same world.
"""
from __future__ import annotations

import os
from typing import Optional

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


def _write_pgm(path: str, img: np.ndarray) -> None:
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img.astype(np.uint8).tobytes())


def write_dataset(world: SyntheticWorld, out_dir: str, n_frames: Optional[int] = None) -> str:
    """Write a Lafida-layout dataset: the rendered PGM images,
    images_and_timestamps.txt and the three YAML schemas. Returns the
    sequence directory (== the calibration directory)."""
    os.makedirs(out_dir, exist_ok=True)
    C = world.rig.n_cams
    lines = []
    for t in range(n_frames or len(world.poses)):
        imgs = render_frame(world, t)
        names = []
        for c in range(C):
            name = f"cam{c}_{t:05d}.pgm"
            _write_pgm(os.path.join(out_dir, name), imgs[c])
            names.append(name)
        lines.append(f"{world.timestamps[t]:.6f} " + " ".join(names[:3]))
    with open(os.path.join(out_dir, "images_and_timestamps.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    write_calibration_yamls(world, out_dir)
    return out_dir


def write_calibration_yamls(world: SyntheticWorld, out_dir: str) -> None:
    """The reference's three YAML schemas for the world's rig, floats as
    %.12g of their float32 values."""
    rig = world.rig
    C = rig.n_cams
    mc = rig.Mc_cayley.detach().cpu().numpy()
    cams = {k: getattr(rig.cams, k).detach().cpu().numpy() for k in ("pol", "invpol", "cde", "pp", "wh")}
    with open(os.path.join(out_dir, "MultiCamSys_Calibration.yaml"), "w") as f:
        f.write("%YAML:1.0\n\n")
        f.write(f"CameraSystem.nrCams: {C}\n")
        for c in range(C):
            for j in range(6):
                f.write(f"CameraSystem.cam{c + 1}_{j + 1}: {float(mc[c, j]):.12g}\n")
    for c in range(C):
        pol, invpol, cde, pp, wh = (cams[k][c] for k in ("pol", "invpol", "cde", "pp", "wh"))
        n_pol = max(int(np.max(np.nonzero(pol)[0], initial=0)) + 1, 2)
        n_inv = max(int(np.max(np.nonzero(invpol)[0], initial=0)) + 1, 2)
        with open(os.path.join(out_dir, f"InteriorOrientationFisheye{c}.yaml"), "w") as f:
            f.write("%YAML:1.0\n\n")
            f.write(f"Camera.Iw: {int(wh[0])}\nCamera.Ih: {int(wh[1])}\n")
            f.write(f"Camera.nrpol: {n_pol}\nCamera.nrinvpol: {n_inv}\n")
            for i in range(n_pol):
                f.write(f"Camera.a{i}: {float(pol[i]):.12g}\n")
            for i in range(n_inv):
                f.write(f"Camera.pol{i}: {float(invpol[i]):.12g}\n")
            f.write(f"Camera.c: {float(cde[0]):.12g}\nCamera.d: {float(cde[1]):.12g}\n"
                    f"Camera.e: {float(cde[2]):.12g}\n")
            f.write(f"Camera.u0: {float(pp[0]):.12g}\nCamera.v0: {float(pp[1]):.12g}\n")
            f.write("Camera.mirrorMask: 1\n")
    with open(os.path.join(out_dir, "Slam_Settings_synthetic.yaml"), "w") as f:
        f.write("%YAML:1.0\n\n")
        f.write("Camera.fps: 25.0\nCamera.RGB: 0\n")
        f.write("extractor.usemdBRIEF: 0\nextractor.masks: 0\nextractor.useAgast: 0\n")
        f.write("extractor.fastAgastType: 2\nextractor.descSize: 32\n")
        f.write(f"extractor.nFeatures: {world.n_feats}\n")
        f.write("extractor.scaleFactor: 1.2\nextractor.nLevels: 2\nextractor.fastTh: 20\n")
        f.write("extractor.nScoreType: 0\nUseMotionModel: 1\n")
        f.write(f"traj.StartFrame: 1\ntraj.EndFrame: {len(world.poses) + 1}\n")
