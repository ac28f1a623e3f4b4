"""Synthetic multi-camera world: a known trajectory and 3-D landmarks with
binary descriptors, and the oracle features of each frame (port of
`multicol_slam_tpu/io/synthetic.py`).

Everything here is numpy on the host except the rig, which is the port's
`MultiCamRig`. `make_world` is a host-side fixture: the rig it builds lies
on the CPU (device="cpu", passed explicitly). For the same arguments the
arrays equal the reference's exactly: the same generator draws in the same
order. `synthesize_features` projects on the host and returns the frame's
`FrameFeatures` on `device`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from multicol_slam_tpu_torch.models.camera import (
    OmniCamera, cam_img_to_world, cam_world_to_img, fit_inverse_poly, in_mirror_mask,
)
from multicol_slam_tpu_torch.models.rig import MultiCamRig
from multicol_slam_tpu_torch.slam.features import FrameFeatures
from multicol_slam_tpu_torch.utils.geometry import cayley_to_hom


def make_synthetic_rig(n_cams: int = 3, w: int = 256, h: int = 192, device=DEFAULT_DEVICE) -> MultiCamRig:
    """Mild-fisheye rig with cameras offset and rotated from the body frame,
    on `device`. The inverse polynomial is fit from the forward one, so
    projection and unprojection round-trip."""
    device = resolve_device(device)
    # z(rho) = 60 - rho^2/60: horizon (theta=0) at rho=60 px, FOV ~145 deg
    pol = [-60.0, 0.0, 1.0 / 60.0, 0.0, 0.0]
    invpol = fit_inverse_poly(pol, rho_max=0.95 * (h / 2.0 + 22.0))
    cams = OmniCamera.from_params(
        [pol] * n_cams,
        [list(invpol)] * n_cams,
        [[1.0, 0.0, 0.0]] * n_cams,
        [[w / 2.0, h / 2.0]] * n_cams,
        [[w, h]] * n_cams,
        device=device,
    )
    mc = np.zeros((n_cams, 6), np.float32)
    for c in range(n_cams):
        ang = 2.0 * np.pi * c / max(n_cams, 1)
        mc[c, :3] = [0.0, 0.15 * np.sin(ang), 0.1 * np.cos(ang)]  # mild rotations
        mc[c, 3:] = [0.15 * np.cos(ang), 0.15 * np.sin(ang), 0.0]
    return MultiCamRig.from_cayley(cams, torch.from_numpy(mc).to(device))


@dataclasses.dataclass
class SyntheticWorld:
    rig: MultiCamRig
    points: np.ndarray          # [P, 3]
    descs: np.ndarray           # [P, B]
    poses: np.ndarray           # [T, 6] ground-truth body poses (M_t cayley)
    timestamps: np.ndarray      # [T]
    n_feats: int
    noise_px: float
    seed: int
    # landmarks farther than this from the camera are not observed
    max_vis_dist: float = 25.0

    def frame_features(self, t: int, device=DEFAULT_DEVICE) -> FrameFeatures:
        return synthesize_features(
            self.rig, self.points, self.descs, self.poses[t], self.n_feats,
            noise_px=self.noise_px, seed=self.seed * 100003 + t,
            max_vis_dist=self.max_vis_dist, device=device,
        )


def make_world(
    n_points: int = 800,
    n_frames: int = 60,
    n_cams: int = 3,
    n_feats: int = 200,
    noise_px: float = 0.3,
    trajectory: str = "circle",
    radius: float = 4.0,
    seed: int = 0,
    period: Optional[int] = None,
    max_vis_dist: float = 25.0,
    landmarks: str = "ring",
    rig: Optional[MultiCamRig] = None,
) -> SyntheticWorld:
    """`period`: frames per lap of a circular trajectory (default n_frames,
    one lap). `rig`: use this rig instead of the mild-fisheye synthetic one
    (e.g. a 754x480 Lafida-shaped rig), which is built on the CPU
    (device="cpu": the world is host data). `landmarks`: 'ring', 'room' (walls
    and a ceiling, for rigs with an upward-looking camera), 'corridor',
    'pathroom' or 'path'. `trajectory`: 'circle', 'circle_noyaw', 'line' or
    'outback'."""
    rng = np.random.default_rng(seed)
    if rig is None:
        rig = make_synthetic_rig(n_cams, device="cpu")
    ang = rng.uniform(0, 2 * np.pi, n_points)
    if landmarks == "room":
        # indoor room around the trajectory: cylindrical wall band plus a
        # ceiling disk — every camera of an arbitrarily-oriented helmet rig
        # (incl. straight-up) sees texture from everywhere on the path
        n_wall = (2 * n_points) // 3
        rr = radius + rng.uniform(1.5, 4.0, n_wall)
        zw = rng.uniform(-1.0, 2.5, n_wall)
        wall = np.stack(
            [-radius + rr * np.cos(ang[:n_wall]), rr * np.sin(ang[:n_wall]), zw], -1
        )
        n_ceil = n_points - n_wall
        rc = np.sqrt(rng.uniform(0.0, 1.0, n_ceil)) * (radius + 4.0)
        ac = ang[n_wall:]
        zc = rng.uniform(2.5, 4.0, n_ceil)
        ceil = np.stack([-radius + rc * np.cos(ac), rc * np.sin(ac), zc], -1)
        points = np.concatenate([wall, ceil]).astype(np.float32)
    elif landmarks == "corridor":
        # landmarks lining a straight corridor along +x (matches the 'line' /
        # 'outback' trajectories): with a short max_vis_dist the feature set
        # turns over constantly — the long-run map-GROWTH profile (the
        # reference's unbounded map, culling as the only control,
        # cLocalMapping.cpp:520-597)
        Lx = 0.05 * n_frames * (0.5 if trajectory == "outback" else 1.0)
        x = rng.uniform(-2.0, Lx + 2.0, n_points)
        side = rng.choice([-1.0, 1.0], n_points)
        y = side * rng.uniform(1.0, 2.5, n_points)
        z = rng.uniform(-1.0, 2.0, n_points)
        points = np.stack([x, y, z], -1).astype(np.float32)
    elif landmarks == "pathroom":
        # 'path' drift profile (landmarks hugging the circular path, so with
        # a short max_vis_dist places leave view and reappear) but with a
        # ceiling strip above the path: an arbitrarily-oriented helmet rig
        # (the real Lafida cam2 looks along body +z) sees texture everywhere
        n_wall = (3 * n_points) // 4
        rr = radius + rng.uniform(1.0, 3.0, n_wall)
        zw = rng.uniform(-1.0, 2.0, n_wall)
        wall = np.stack(
            [-radius + rr * np.cos(ang[:n_wall]), rr * np.sin(ang[:n_wall]), zw], -1
        )
        n_ceil = n_points - n_wall
        rc = radius + rng.uniform(-1.5, 1.5, n_ceil)
        ac = ang[n_wall:]
        zc = rng.uniform(2.2, 3.2, n_ceil)
        ceil = np.stack([-radius + rc * np.cos(ac), rc * np.sin(ac), zc], -1)
        points = np.concatenate([wall, ceil]).astype(np.float32)
    elif landmarks == "path":
        # landmarks hugging the circular PATH (center (-radius, 0)): combined
        # with a short max_vis_dist, each frame sees only a local arc — places
        # leave view and reappear, the precondition for loop-closure tests
        rr = radius + rng.uniform(1.0, 3.0, n_points)
        z = rng.uniform(-1.0, 1.0, n_points)
        points = np.stack(
            [-radius + rr * np.cos(ang), rr * np.sin(ang), z], -1
        ).astype(np.float32)
    else:
        # landmarks in a ring around the origin (visible from everywhere)
        rad = rng.uniform(radius + 2.0, radius + 8.0, n_points)
        z = rng.uniform(-3.0, 3.0, n_points)
        points = np.stack([rad * np.cos(ang), rad * np.sin(ang), z], -1).astype(np.float32)
    descs = rng.integers(0, 256, size=(n_points, 32), dtype=np.uint8)
    poses = np.zeros((n_frames, 6), np.float32)
    per = period or n_frames
    for t in range(n_frames):
        if trajectory == "circle":
            th = 2.0 * np.pi * t / per
            poses[t, 3] = radius * np.cos(th) - radius
            poses[t, 4] = radius * np.sin(th)
            poses[t, 2] = np.tan(th / 2.0) if abs(th) < 3.0 else 0.0  # cayley yaw ~ tan(theta/2)
        elif trajectory == "circle_noyaw":
            # translate around the circle with fixed body orientation — no
            # Cayley singularity at theta=pi, ideal for multi-lap loop tests
            th = 2.0 * np.pi * t / per
            poses[t, 3] = radius * np.cos(th) - radius
            poses[t, 4] = radius * np.sin(th)
        elif trajectory == "line":
            poses[t, 3] = 0.05 * t
            poses[t, 0] = 0.001 * t
        elif trajectory == "outback":
            # out along +x for half the frames, then back over the same
            # corridor (no rotation): the return leg revisits every earlier
            # place with accumulated drift — loop closures fire over a LARGE
            # keyframe graph (the in-vivo essential-graph-at-scale scenario)
            half = n_frames // 2
            u = t if t < half else (2 * half - t)
            poses[t, 3] = 0.05 * u
        else:
            raise ValueError(trajectory)
    timestamps = np.arange(n_frames) / 25.0
    return SyntheticWorld(
        rig, points, descs, poses, timestamps, n_feats, noise_px, seed,
        max_vis_dist,
    )


def synthesize_features(
    rig: MultiCamRig,
    points: np.ndarray,
    descs: np.ndarray,
    pose6: np.ndarray,
    n_feats: int,
    noise_px: float = 0.3,
    desc_flip_bits: int = 2,
    seed: int = 0,
    max_vis_dist: float = 25.0,
    device=DEFAULT_DEVICE,
) -> FrameFeatures:
    """Project the landmarks into every camera at the body pose and emit a
    padded FrameFeatures of noisy pixels and lightly corrupted descriptors
    (the same generator draws, in the same order, as the reference)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    cams = OmniCamera(*(getattr(rig.cams, k).cpu() for k in ("pol", "invpol", "cde", "pp", "wh")))
    Mc = rig.Mc.cpu().numpy()
    C = Mc.shape[0]
    B = descs.shape[1]
    Mt = cayley_to_hom(torch.tensor(np.asarray(pose6, np.float32))).numpy()
    uv_list, ray_list, desc_list, valid_list = [], [], [], []
    for c in range(C):
        Tinv = np.linalg.inv(Mt @ Mc[c])
        Xc = points @ Tinv[:3, :3].T + Tinv[:3, 3]
        uv_t = cam_world_to_img(cams, c, torch.tensor(Xc, dtype=torch.float32))
        uv = uv_t.numpy()
        ok = Xc[:, 2] > 0
        ok &= in_mirror_mask(cams, c, uv_t).numpy()
        ok &= np.linalg.norm(Xc, axis=-1) < max_vis_dist
        idx = np.nonzero(ok)[0]
        rng.shuffle(idx)
        idx = idx[:n_feats]
        n = len(idx)
        uv_sel = uv[idx] + rng.normal(0, noise_px, (n, 2))
        d_sel = descs[idx].copy()
        # flip a couple of random bits per descriptor (matching noise)
        for _ in range(desc_flip_bits):
            byte = rng.integers(0, B, n)
            bit = rng.integers(0, 8, n).astype(np.uint8)
            d_sel[np.arange(n), byte] ^= (1 << bit).astype(np.uint8)
        pad = n_feats - n
        uv_p = np.pad(uv_sel, ((0, pad), (0, 0))).astype(np.float32)
        uv_list.append(uv_p)
        ray_list.append(cam_img_to_world(cams, c, torch.from_numpy(uv_p)).numpy())
        desc_list.append(np.pad(d_sel, ((0, pad), (0, 0))))
        valid_list.append(np.pad(np.ones(n, bool), (0, pad)))
    K = n_feats

    def put(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)
    return FrameFeatures(
        uv=put(np.stack(uv_list), np.float32),
        response=torch.ones((C, K), dtype=torch.float32, device=device),
        octave=torch.zeros((C, K), dtype=torch.int32, device=device),
        angle=torch.zeros((C, K), dtype=torch.float32, device=device),
        rays=put(np.stack(ray_list), np.float32),
        desc=put(np.stack(desc_list), np.uint8),
        dmask=torch.full((C, K, B), 255, dtype=torch.uint8, device=device),
        valid=put(np.stack(valid_list), bool),
    )
