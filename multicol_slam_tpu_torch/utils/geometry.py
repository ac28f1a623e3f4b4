"""Batched SE(3)/Cayley geometry (port of `multicol_slam_tpu/utils/geometry.py`).

Rotations are Cayley 3-vectors, rigid transforms 6-vectors
``[c1 c2 c3 tx ty tz]``, homogeneous 4x4 matrices map body -> world (M_t) and
camera -> body (M_c). Every function is batched over leading axes.
"""
from __future__ import annotations

import torch


def cayley_to_rot(c: torch.Tensor) -> torch.Tensor:
    """Cayley 3-vector -> 3x3 rotation, batched over leading dims."""
    c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2]
    c1s, c2s, c3s = c1 * c1, c2 * c2, c3 * c3
    scale = 1.0 + c1s + c2s + c3s
    R = torch.stack(
        [
            torch.stack([1.0 + c1s - c2s - c3s, 2.0 * (c1 * c2 - c3), 2.0 * (c1 * c3 + c2)], -1),
            torch.stack([2.0 * (c1 * c2 + c3), 1.0 - c1s + c2s - c3s, 2.0 * (c2 * c3 - c1)], -1),
            torch.stack([2.0 * (c1 * c3 - c2), 2.0 * (c2 * c3 + c1), 1.0 - c1s - c2s + c3s], -1),
        ],
        dim=-2,
    )
    return R / scale[..., None, None]


def _bottom_row(batch, like: torch.Tensor) -> torch.Tensor:
    """[..., 1, 4] rows (0, 0, 0, 1), made on the device (no host upload)."""
    row = torch.zeros((*batch, 1, 4), dtype=like.dtype, device=like.device)
    row[..., 3] = 1.0
    return row


def cayley_to_hom(c6: torch.Tensor) -> torch.Tensor:
    """[c1 c2 c3 tx ty tz] -> 4x4 homogeneous transform."""
    R = cayley_to_rot(c6[..., :3])
    top = torch.cat([R, c6[..., 3:6, None]], dim=-1)
    return torch.cat([top, _bottom_row(c6.shape[:-1], c6)], dim=-2)


def hom_inverse(M: torch.Tensor) -> torch.Tensor:
    """SE(3) inverse: [R t; 0 1]^-1 = [R^T -R^T t; 0 1]."""
    Rt = M[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, M[..., :3, 3])
    top = torch.cat([Rt, ti[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(M.shape[:-2], M)], dim=-2)


def transform_points(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 transform(s) to 3-D point(s): R X + t. Broadcasts."""
    return torch.einsum("...ij,...j->...i", M[..., :3, :3], X) + M[..., :3, 3]


def horner(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_i coeffs[..., i] * x^i by Horner's rule; x broadcasts against
    coeffs[..., 0]."""
    D = coeffs.shape[-1]
    res = torch.zeros_like(x) + coeffs[..., D - 1]
    for i in range(D - 2, -1, -1):
        res = res * x + coeffs[..., i]
    return res


def horner_deriv(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d/dx of `horner(coeffs, x)`."""
    D = coeffs.shape[-1]
    res = torch.zeros_like(x) + (D - 1) * coeffs[..., D - 1]
    for i in range(D - 2, 0, -1):
        res = res * x + i * coeffs[..., i]
    return res
