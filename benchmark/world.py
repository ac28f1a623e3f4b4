"""The benchmark's synthetic room and its fisheye images, made from the seed.

A frozen copy of the room world that the port's bench tracks (3000
landmarks on a wall band and a ceiling around a 3 m circle, walked at 400
frames a lap with a fixed body orientation, so the lap closes on itself),
with two changes that keep set-up short: the landmark textures are drawn
once per world, and the images are stamped on the device in a few large
calls instead of one landmark at a time on the host. A frame is rendered
when the stream asks for it, as a camera delivers one; a traffic mix that
walks a short stretch over and over renders that stretch once in set-up.

Landmark positions come from numpy's generator on the seed, in the order of
the port's `make_world`; textures and the vocabulary's training
descriptors from a torch generator on the device. A landmark overlapping
another is drawn over it when its index is higher, as a loop in index order
would draw it; the scatter keeps that order exactly (no write races).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.geometry import Rig, hom, hom_inv, in_mirror, project

PATCH = 29
BACKGROUND = 20


def seed_words(seed: int) -> int:
    """The run's seed as a non-negative integer numpy and torch accept."""
    return int(seed) % (2 ** 63)


class RoomWorld:
    """Landmarks [P, 3] float32 (host), body poses [T, 6] of one lap (host),
    and the images [n_render, C, H, W] uint8 of the lap's first `n_render`
    frames, rendered in set-up on the device."""

    def __init__(self, spec: dict, rig: Rig, seed: int, device, n_render: int = 0):
        s = seed_words(seed)
        rng = np.random.default_rng(s)
        n, r = int(spec["n_points"]), float(spec["radius"])
        ang = rng.uniform(0, 2 * np.pi, n)
        n_wall = (2 * n) // 3
        rr = r + rng.uniform(1.5, 4.0, n_wall)
        zw = rng.uniform(-1.0, 2.5, n_wall)
        wall = np.stack([-r + rr * np.cos(ang[:n_wall]), rr * np.sin(ang[:n_wall]), zw], -1)
        n_ceil = n - n_wall
        rc = np.sqrt(rng.uniform(0.0, 1.0, n_ceil)) * (r + 4.0)
        zc = rng.uniform(2.5, 4.0, n_ceil)
        ceil = np.stack([-r + rc * np.cos(ang[n_wall:]), rc * np.sin(ang[n_wall:]), zc], -1)
        self.points = np.concatenate([wall, ceil]).astype(np.float32)
        self.period = int(spec["period"])
        th = 2.0 * np.pi * np.arange(self.period) / self.period
        self.poses = np.zeros((self.period, 6), np.float32)
        self.poses[:, 3] = r * np.cos(th) - r
        self.poses[:, 4] = r * np.sin(th)
        self.max_vis = min(25.0, float(spec["max_vis_dist"]))
        self.rig = rig
        self.device = torch.device(device)
        gen = torch.Generator(device=self.device).manual_seed(s)
        self.textures = textures(n, gen, self.device)
        self.train_descs = torch.randint(0, 256, (n, 32), generator=gen, device=self.device,
                                         dtype=torch.int32).to(torch.uint8)
        self.images = [self.render(t) for t in range(min(n_render, self.period))]

    def render(self, t: int) -> torch.Tensor:
        """[C, H, W] uint8 image of the rig at pose t."""
        rig, dev = self.rig, self.device
        C, H, W = rig.n_cams, rig.height, rig.width
        half = PATCH // 2
        X = torch.as_tensor(self.points, device=dev)
        Mt = hom(torch.as_tensor(self.poses[t], device=dev))
        key = torch.full((C * H * W,), -1, dtype=torch.int32, device=dev)
        d = torch.arange(-half, half + 1, device=dev)
        for c in range(C):
            Tinv = hom_inv(Mt @ rig.Mc[c])
            Xc = X @ Tinv[:3, :3].T + Tinv[:3, 3]
            uv = project(rig.invpol[c], rig.cde[c], rig.pp[c], Xc)
            ok = (Xc[:, 2] > 0) & in_mirror(rig.pp[c], rig.wh[c], uv)
            ok &= torch.linalg.vector_norm(Xc, dim=-1) < self.max_vis
            u, v = torch.round(uv[:, 0]).long(), torch.round(uv[:, 1]).long()
            ok &= (u >= half) & (u < W - half) & (v >= half) & (v < H - half)
            ids = torch.nonzero(ok)[:, 0]
            rows = v[ids, None, None] + d[None, :, None]
            cols = u[ids, None, None] + d[None, None, :]
            flat = (c * H * W + rows * W + cols).reshape(-1)
            val = (ids[:, None, None].to(torch.int32) * 256 + self.textures[ids].to(torch.int32)).reshape(-1)
            key.scatter_reduce_(0, flat, val, reduce="amax")
        img = torch.where(key >= 0, key % 256, torch.full_like(key, BACKGROUND))
        return img.to(torch.uint8).reshape(C, H, W)

    def frame(self, t: int) -> torch.Tensor:
        """[C, H, W] uint8 images of the t-th frame of the walk, on the
        device, laps repeating: rendered in set-up, or now."""
        t %= self.period
        return self.images[t] if t < len(self.images) else self.render(t)


def textures(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """[n, PATCH, PATCH] uint8: a bright blob over windowed low-contrast noise
    and four satellite blobs whose layout makes each landmark's descriptor
    distinctive and its intensity-centroid angle stable."""
    f32 = torch.float32
    d = torch.arange(PATCH, device=device, dtype=f32) - PATCH // 2
    yy, xx = torch.meshgrid(d, d, indexing="ij")
    r = torch.sqrt(yy * yy + xx * xx)
    win = 0.5 * (1.0 + torch.cos(torch.clamp(r / (PATCH / 2.0), 0, 1) * math.pi))

    def uni(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device, dtype=f32)
    noise = torch.randint(-12, 13, (n, PATCH, PATCH), generator=gen, device=device).to(f32)
    amp = uni(100.0, 210.0, (n, 1, 1))
    out = 60.0 + noise + amp * torch.exp(-(yy * yy + xx * xx)[None] / (2.0 * 1.8 ** 2))
    for _ in range(4):
        th, sr = uni(0, 2 * math.pi, (n, 1, 1)), uni(3.5, 9.0, (n, 1, 1))
        sy, sx = sr * torch.sin(th), sr * torch.cos(th)
        out = out + amp * uni(0.3, 0.7, (n, 1, 1)) * torch.exp(
            -((yy[None] - sy) ** 2 + (xx[None] - sx) ** 2) / (2.0 * 1.7 ** 2))
    return torch.clamp(20.0 + (out - 20.0) * win[None], 0, 255).to(torch.uint8)
