"""The large-map MultiCol BA problem, drawn on the device from the seed.

A frozen copy of the port's `make_large_ba_problem` draw (a corridor of
keyframes 0.08 m apart observing a cloud of points at 4-10 m through a
3-camera rig, observations biased to the points near each keyframe, rows
that project outside the image or within 0.5 m invalid, 0.5 px of pixel
noise, every pose but the first perturbed by 0.01 and every point by
0.05), with its rows sorted stably by point id as the port's BA bench
sorts them. Drawn with a torch generator on the device in a few large
calls; the numbers differ from the numpy draw of the same seed, the
distribution does not.

Returns plain tensors, which the runner hands to the program and the
reference alike.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from benchmark.reference.geometry import Rig, hom, hom_inv, project
from benchmark.world import seed_words


class Problem(NamedTuple):
    poses: torch.Tensor      # [K, 6] perturbed start
    points: torch.Tensor     # [P, 3] perturbed start
    mc: torch.Tensor         # [C, 6]
    intr: torch.Tensor       # [C, 22] c, d, e, u0, v0, pol[5], invpol[12]
    kf: torch.Tensor         # [O] int64
    pt: torch.Tensor         # [O] int64, sorted
    cam: torch.Tensor        # [O] int64
    uv: torch.Tensor         # [O, 2]
    valid: torch.Tensor      # [O] bool
    free_poses: torch.Tensor  # [K] bool
    inv_sigma2: Optional[torch.Tensor] = None  # [O] each row's weight; None: 1


def intrinsics(rig: Rig) -> torch.Tensor:
    return torch.cat([rig.cde, rig.pp, rig.pol, rig.invpol], -1)


def draw(spec: dict, rig: Rig, seed: int, device) -> Problem:
    p = spec["problem"]
    K, P, O = int(p["n_kfs"]), int(p["n_points"]), int(p["n_obs"])
    C = rig.n_cams
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed_words(seed))
    f32 = torch.float32

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev, dtype=f32)

    def normal(sd, *shape):
        return sd * torch.randn(shape, generator=gen, device=dev, dtype=f32)
    span = 0.08 * K
    poses = torch.zeros((K, 6), device=dev, dtype=f32)
    poses[:, 3] = torch.linspace(0.0, span, K, device=dev)
    poses[:, 1] = 0.02 * torch.sin(torch.linspace(0, 4 * math.pi, K, device=dev))
    points = torch.stack([uni(-1.0, span + 1.0, P), normal(1.5, P), uni(4.0, 10.0, P)], -1)
    kf = torch.randint(0, K, (O,), generator=gen, device=dev)
    near = ((poses[kf, 3] + normal(2.5, O)) / (span + 2.0) * P).long().clamp(0, P - 1)
    pt = torch.argsort(points[:, 0], stable=True)[near]
    cam = torch.randint(0, C, (O,), generator=gen, device=dev)
    M = hom(poses)[kf] @ rig.Mc[cam]
    Minv = hom_inv(M)
    Xc = (Minv[:, :3, :3] @ points[pt][:, :, None])[..., 0] + Minv[:, :3, 3]
    uv = project(rig.invpol[cam], rig.cde[cam], rig.pp[cam], Xc)
    valid = (Xc[:, 2] > 0.5) & (uv[:, 0] > 5) & (uv[:, 0] < rig.width - 6) & (uv[:, 1] > 5) \
        & (uv[:, 1] < rig.height - 6)
    uv = uv + normal(float(p["noise_px"]), O, 2)
    pose_d = normal(float(p["pose_noise"]), K, 6)
    pose_d[0] = 0.0
    point_d = normal(float(p["point_noise"]), P, 3)
    order = torch.argsort(pt, stable=True)
    free = torch.ones(K, dtype=torch.bool, device=dev)
    free[0] = False
    return Problem(poses + pose_d, points + point_d, rig.mc6.clone(), intrinsics(rig).to(dev),
                   kf[order], pt[order], cam[order], uv[order].contiguous(), valid[order], free)
