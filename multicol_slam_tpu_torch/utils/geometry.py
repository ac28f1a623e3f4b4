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


def rot_to_cayley(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation -> Cayley 3-vector: C = (R - I)(R + I)^-1, c = (-C12, C02, -C01)."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    # C = (R - I) inv(R + I) == solve((R + I)^T, (R - I)^T)^T
    C = torch.linalg.solve((R + eye).transpose(-1, -2), (R - eye).transpose(-1, -2)).transpose(-1, -2)
    return torch.stack([-C[..., 1, 2], C[..., 0, 2], -C[..., 0, 1]], dim=-1)


def cayley_to_hom(c6: torch.Tensor) -> torch.Tensor:
    """[c1 c2 c3 tx ty tz] -> 4x4 homogeneous transform."""
    R = cayley_to_rot(c6[..., :3])
    top = torch.cat([R, c6[..., 3:6, None]], dim=-1)
    return torch.cat([top, _bottom_row(c6.shape[:-1], c6)], dim=-2)


def hom_to_cayley(M: torch.Tensor) -> torch.Tensor:
    """4x4 -> [c1 c2 c3 tx ty tz]."""
    return torch.cat([rot_to_cayley(M[..., :3, :3]), M[..., :3, 3]], dim=-1)


def hom_inverse(M: torch.Tensor) -> torch.Tensor:
    """SE(3) inverse: [R t; 0 1]^-1 = [R^T -R^T t; 0 1]."""
    Rt = M[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, M[..., :3, 3])
    top = torch.cat([Rt, ti[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(M.shape[:-2], M)], dim=-2)


def transform_points(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 transform(s) to 3-D point(s): R X + t. Broadcasts."""
    return torch.einsum("...ij,...j->...i", M[..., :3, :3], X) + M[..., :3, 3]


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> skew-symmetric 3x3 (batched)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], dim=-2)


def essential_from_relative(M21: torch.Tensor) -> torch.Tensor:
    """Essential matrix E = [t]_x R of a relative transform M21 (cam2 <- cam1,
    as the reference's ComputeE builds it, misc.cpp:72-86)."""
    return torch.matmul(skew(M21[..., :3, 3]), M21[..., :3, :3])


def ray_epipolar_distance(ray1: torch.Tensor, E12: torch.Tensor, ray2: torch.Tensor) -> torch.Tensor:
    """Epipolar distance between unit rays through E (misc.cpp:54-70):
    |r2^T E r1| over the norm of both epipolar lines. Batched, broadcasts."""
    Er1 = torch.einsum("...ij,...j->...i", E12, ray1)
    Etr2 = torch.einsum("...ji,...j->...i", E12, ray2)
    num = torch.abs(torch.sum(ray2 * Er1, dim=-1))
    n1 = torch.sum(Er1[..., :2] ** 2, dim=-1)
    n2 = torch.sum(Etr2[..., :2] ** 2, dim=-1)
    return num / torch.sqrt(n1 + n2 + 1e-18)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion [qx qy qz qw] (Shepperd: of the four
    candidate constructions, the one with the largest leading term)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1),
    ], dim=-2)                                                   # rows: [w, x, y, z]
    diag = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                        1.0 - m00 - m11 + m22], -1)
    best = torch.argmax(diag, dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def triangulate_midpoint(o1, d1, o2, d2):
    """Midpoint triangulation of two rays (origin o, unit direction d):
    solve the 2x2 system for the ray depths, average the two closest points.
    Batched over leading dims. Returns (X [..., 3], lam1 [...], lam2 [...])."""
    b = o2 - o1
    d1d2 = torch.sum(d1 * d2, dim=-1)
    bd1 = torch.sum(b * d1, dim=-1)
    bd2 = torch.sum(b * d2, dim=-1)
    denom = 1.0 - d1d2 * d1d2
    denom = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
    lam1 = (bd1 - bd2 * d1d2) / denom
    lam2 = (bd1 * d1d2 - bd2) / denom
    p1 = o1 + lam1[..., None] * d1
    p2 = o2 + lam2[..., None] * d2
    return 0.5 * (p1 + p2), lam1, lam2


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
