"""Batched Scaramuzza omnidirectional camera model (port of
`multicol_slam_tpu/models/camera.py`).

Projection:   norm = |xy|; theta = atan2(-z, norm); rho = invP(theta);
              (uu, vv) = xy / norm * rho; u = c uu + d vv + u0; v = e uu + vv + v0
Unprojection: xy = inv([[c, d], [e, 1]]) (uv - pp); z = -P(|xy|); normalize.

Polynomials are zero-padded to fixed degrees so a rig's cameras stack into
[C, ...] buffers.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from multicol_slam_tpu_torch.utils.geometry import horner

MAX_POL = 8
MAX_INVPOL = 16

# Mirror-mask radial offsets per pyramid level (cam_model_omni.cpp:195).
MIRROR_OFFSETS = (22.0, 10.0, 5.0, 1.0)


class OmniCamera(nn.Module):
    """Scaramuzza model parameters as buffers, each with a leading camera axis:
    pol [C, MAX_POL], invpol [C, MAX_INVPOL], cde [C, 3], pp [C, 2], wh [C, 2]."""

    def __init__(self, pol, invpol, cde, pp, wh):
        super().__init__()
        self.register_buffer("pol", pol)
        self.register_buffer("invpol", invpol)
        self.register_buffer("cde", cde)
        self.register_buffer("pp", pp)
        self.register_buffer("wh", wh)

    @property
    def n_cams(self) -> int:
        return self.pol.shape[0]

    @classmethod
    def from_params(cls, pol_list, invpol_list, cde_list, pp_list, wh_list,
                    device=DEFAULT_DEVICE, dtype=torch.float32):
        """Build from per-camera lists of coefficients (shorter polynomials
        are zero-padded), on the card unless `device` says otherwise."""
        device = resolve_device(device)
        C = len(pol_list)
        pol = torch.zeros((C, MAX_POL), dtype=torch.float64)
        invpol = torch.zeros((C, MAX_INVPOL), dtype=torch.float64)
        for i in range(C):
            pol[i, : len(pol_list[i])] = torch.as_tensor(pol_list[i], dtype=torch.float64)
            invpol[i, : len(invpol_list[i])] = torch.as_tensor(invpol_list[i], dtype=torch.float64)

        def arr(x):
            return torch.as_tensor(x, dtype=torch.float64).to(device=device, dtype=dtype)

        return cls(arr(pol), arr(invpol), arr(cde_list), arr(pp_list), arr(wh_list))

    def to_vector(self, n_pol: int = 5, n_invpol: int = 12) -> torch.Tensor:
        """Packed intrinsics [C, 3 + 2 + n_pol + n_invpol]: c, d, e, u0, v0, pol, invpol."""
        return torch.cat(
            [self.cde, self.pp, self.pol[:, :n_pol], self.invpol[:, :n_invpol]], dim=-1
        )

    def tile(self, n: int) -> "OmniCamera":
        """The rig's cameras repeated n times along the camera axis:
        camera j * C + c is camera c (the reference's tree_map(jnp.tile))."""
        return OmniCamera(*(getattr(self, k).repeat(n, 1) for k in ("pol", "invpol", "cde", "pp", "wh")))

    @classmethod
    def from_vector(cls, vec: torch.Tensor, wh: torch.Tensor, n_pol: int = 5, n_invpol: int = 12):
        pol = vec.new_zeros(vec.shape[:-1] + (MAX_POL,))
        pol[..., :n_pol] = vec[..., 5 : 5 + n_pol]
        invpol = vec.new_zeros(vec.shape[:-1] + (MAX_INVPOL,))
        invpol[..., :n_invpol] = vec[..., 5 + n_pol : 5 + n_pol + n_invpol]
        return cls(pol, invpol, vec[..., 0:3].clone(), vec[..., 3:5].clone(), wh)


def world_to_img(invpol, cde, pp, X: torch.Tensor) -> torch.Tensor:
    """Camera-frame points X [..., 3] -> pixels [..., 2] (parameters broadcast)."""
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    norm = torch.clamp_min(torch.sqrt(x * x + y * y), 1e-14)
    theta = torch.atan2(-z, norm)
    rho = horner(invpol, theta)
    uu = x / norm * rho
    vv = y / norm * rho
    c, d, e = cde[..., 0], cde[..., 1], cde[..., 2]
    u = uu * c + vv * d + pp[..., 0]
    v = uu * e + vv + pp[..., 1]
    return torch.stack([u, v], dim=-1)


def img_to_world(pol, cde, pp, uv: torch.Tensor) -> torch.Tensor:
    """Pixels uv [..., 2] -> unit rays in the camera frame [..., 3]."""
    c, d, e = cde[..., 0], cde[..., 1], cde[..., 2]
    inv_affine = c - d * e
    u_t = uv[..., 0] - pp[..., 0]
    v_t = uv[..., 1] - pp[..., 1]
    x = (u_t - d * v_t) / inv_affine
    y = (-e * u_t + c * v_t) / inv_affine
    rho = torch.sqrt(x * x + y * y)
    z = -horner(pol, rho)
    n = torch.sqrt(x * x + y * y + z * z)
    return torch.stack([x / n, y / n, z / n], dim=-1)


def cam_world_to_img(cam: OmniCamera, cam_idx, X: torch.Tensor) -> torch.Tensor:
    """Project with a per-point camera index: cam_idx [...] int (or an int),
    X [..., 3] -> uv [..., 2]."""
    return world_to_img(cam.invpol[cam_idx], cam.cde[cam_idx], cam.pp[cam_idx], X)


def cam_img_to_world(cam: OmniCamera, cam_idx, uv: torch.Tensor) -> torch.Tensor:
    """Unproject with a per-point camera index: uv [..., 2] -> unit rays [..., 3]."""
    return img_to_world(cam.pol[cam_idx], cam.cde[cam_idx], cam.pp[cam_idx], uv)


def rig_world_to_img(cam: OmniCamera, X: torch.Tensor) -> torch.Tensor:
    """Project per-camera batches: X [C, ..., 3] -> uv [C, ..., 2]."""
    shape = (cam.n_cams,) + (1,) * (X.dim() - 2)
    return world_to_img(cam.invpol.reshape(shape + (MAX_INVPOL,)), cam.cde.reshape(shape + (3,)),
                        cam.pp.reshape(shape + (2,)), X)


def rig_img_to_world(cam: OmniCamera, uv: torch.Tensor) -> torch.Tensor:
    """Unproject per-camera batches: uv [C, ..., 2] -> rays [C, ..., 3]."""
    shape = (cam.n_cams,) + (1,) * (uv.dim() - 2)
    return img_to_world(cam.pol.reshape(shape + (MAX_POL,)), cam.cde.reshape(shape + (3,)),
                        cam.pp.reshape(shape + (2,)), uv)


def in_mirror_mask(cam: OmniCamera, cam_idx, uv: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Analytic mirror-mask test: inside the image and inside the circle of
    radius (v0 + 22) * scale around the scaled principal point. `scale` is the
    pyramid scale of the level uv lives in (1.0 for projection queries)."""
    pp = cam.pp[cam_idx]
    wh = cam.wh[cam_idx]
    u0_l = pp[..., 0] * scale
    v0_l = pp[..., 1] * scale
    w_l = torch.round(wh[..., 0] * scale)
    h_l = torch.round(wh[..., 1] * scale)
    u, v = uv[..., 0], uv[..., 1]
    inside = (u > 0) & (u < w_l - 1) & (v > 0) & (v < h_l - 1)
    du, dv = u - u0_l, v - v0_l
    rad = (pp[..., 1] + MIRROR_OFFSETS[0]) * scale
    return inside & (du * du + dv * dv < rad * rad)


def mirror_mask_grid(cam: OmniCamera, h: int, w: int, scale: float = 1.0) -> torch.Tensor:
    """Dense mirror-mask raster [C, h, w] bool for all cameras at one pyramid
    level; the same test as `in_mirror_mask` on every pixel."""
    dev = cam.pp.device
    u0 = cam.pp[:, 0, None, None] * scale
    v0 = cam.pp[:, 1, None, None] * scale
    w_l = torch.round(cam.wh[:, 0, None, None] * scale)
    h_l = torch.round(cam.wh[:, 1, None, None] * scale)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    inside = (xx > 0) & (xx < w_l - 1) & (yy > 0) & (yy < h_l - 1)
    du, dv = xx - u0, yy - v0
    rad = (cam.pp[:, 1, None, None] + MIRROR_OFFSETS[0]) * scale
    return inside & (du * du + dv * dv < rad * rad)


def mirror_mask_raster(cam: OmniCamera, cam_idx: int, n_levels: int):
    """Boolean mirror masks of one camera, one [h, w] numpy array a pyramid
    level (CreateMirrorMask, cam_model_omni.cpp:183-222: halved sizes and
    principal point, offsets 22 / 10 / 5 / 1). Host-side."""
    w, h = (int(x) for x in cam.wh[cam_idx].cpu().numpy())
    u0, v0 = (float(x) for x in cam.pp[cam_idx].cpu().numpy())
    masks = []
    for lvl in range(n_levels):
        if lvl > 0:
            w, h = (w + 1) // 2, (h + 1) // 2
            u0, v0 = np.ceil(u0 / 2.0), np.ceil(v0 / 2.0)
        jj, ii = np.meshgrid(np.arange(w), np.arange(h))
        masks.append(np.sqrt((ii - v0) ** 2 + (jj - u0) ** 2) < (v0 + MIRROR_OFFSETS[min(lvl, 3)]))
    return masks


def fit_inverse_poly(pol, rho_max: float, deg: int = 12) -> np.ndarray:
    """Fit the inverse polynomial rho(theta) from a forward polynomial z(rho)
    so the pair round-trips, with theta = atan2(-z, rho) and
    z = -horner(pol, rho). Returns MAX_INVPOL-padded float64 coefficients,
    lowest order first (numpy, on the host)."""
    pol = np.asarray(pol, np.float64)
    rho = np.linspace(1e-6, rho_max, 512)
    z = -np.polyval(pol[::-1], rho)
    theta = np.arctan2(-z, rho)
    order = np.argsort(theta)
    coeffs = np.polyfit(theta[order], rho[order], deg)[::-1]
    out = np.zeros(MAX_INVPOL, np.float64)
    out[: deg + 1] = coeffs
    return out
