"""Batched SE(3)/Sim(3)/Cayley geometry (port of `multicol_slam_tpu/utils/geometry.py`).

Rotations are Cayley 3-vectors, rigid transforms 6-vectors
``[c1 c2 c3 tx ty tz]``, homogeneous 4x4 matrices map body -> world (M_t) and
camera -> body (M_c); a Sim(3) is (R, t, s) acting as x -> s R x + t, with
its log/exp on v7 = [omega, upsilon, sigma]. Every function is batched over
leading axes.
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


def hom_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for stacks of 4x4 transforms."""
    return torch.matmul(A, B)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [qx qy qz qw] -> rotation matrix (a zero quaternion gives I)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / torch.where(n > 0, n, torch.ones_like(n)), torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
                        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
                        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1)], dim=-2)


# ---------------------------------------------------------------------------
# Sim(3), stored as (R [..., 3, 3], t [..., 3], s [...]), acting as x -> s R x + t
# ---------------------------------------------------------------------------

def sim3_apply(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return s[..., None] * torch.einsum("...ij,...j->...i", R, X) + t


def sim3_inverse(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor):
    """The inverse of x -> s R x + t: x -> (1/s) R^T x - (1/s) R^T t."""
    Rt = R.transpose(-1, -2)
    si = torch.reciprocal(s)   # (1.0 / s of a 0-dim tensor turns float64 under vmap(jacfwd))
    return Rt, -si[..., None] * torch.einsum("...ij,...j->...i", Rt, t), si


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(a o b)(x) = a(b(x)) = sa Ra (sb Rb x + tb) + ta."""
    return (torch.matmul(Ra, Rb), sa[..., None] * torch.einsum("...ij,...j->...i", Ra, tb) + ta, sa * sb)


# Sim(3) log / exp (g2o's sim3 types of OptimizeEssentialGraph / OptimizeSim3,
# cOptimizerLoopStuff.cpp). The guards are branch-free (torch.where): both
# sides are computed and the small-angle side is taken below 1e-6, so the
# maps stay differentiable by torch.func.jacfwd at and near the identity.
_SMALL = 1e-6
# W = int_0^1 exp(sigma u) R(u theta) du by 16-point Gauss-Legendre on [0, 1]
_GL_NODES = (0.005299532504175031, 0.0277124884633837, 0.06718439880608412, 0.12229779582249845,
             0.19106187779867811, 0.2709916111713863, 0.35919822461037054, 0.4524937450811813,
             0.5475062549188188, 0.6408017753896295, 0.7290083888286137, 0.8089381222013219,
             0.8777022041775016, 0.9328156011939159, 0.9722875115366163, 0.994700467495825)
_GL_WEIGHTS = (0.013576229705877047, 0.03112676196932395, 0.04757925584124639, 0.06231448562776694,
               0.07479799440828837, 0.08457825969750127, 0.09130170752246179, 0.0947253052275343,
               0.0947253052275343, 0.09130170752246179, 0.08457825969750127, 0.07479799440828837,
               0.06231448562776694, 0.04757925584124639, 0.03112676196932395, 0.013576229705877047)


def _safe_angle(theta: torch.Tensor) -> torch.Tensor:
    """theta where it is >= 1e-6, else 1 (the divisor of the generic side)."""
    return torch.where(theta < _SMALL, torch.ones_like(theta), theta)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Axis-angle 3-vector -> rotation matrix (Rodrigues), batched."""
    theta = torch.linalg.vector_norm(omega, dim=-1)
    small = theta < _SMALL
    th = _safe_angle(theta)
    K = skew(omega / th[..., None])
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    R_full = eye + torch.sin(th)[..., None, None] * K + (1.0 - torch.cos(th))[..., None, None] * (K @ K)
    return torch.where(small[..., None, None], eye + skew(omega), R_full)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle 3-vector, batched, safe near 0 and pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    sin_t = torch.sin(theta)
    # generic: omega = theta / (2 sin) vee; small angle: vee / 2
    small = torch.abs(sin_t) < _SMALL
    scale = torch.where(small, torch.full_like(theta, 0.5),
                        theta / (2.0 * torch.where(small, torch.ones_like(sin_t), sin_t)))
    omega_generic = scale[..., None] * vee
    # near pi: the axis from the diagonal, its signs from the off-diagonals
    d = torch.clamp_min((torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1) + 1.0) * 0.5, 1e-12)
    sx = torch.sign(torch.where(torch.abs(vee[..., 0]) > 1e-9, vee[..., 0], torch.ones_like(vee[..., 0])))
    sy = torch.sign(R[..., 0, 1] + R[..., 1, 0]) * sx
    sz = torch.sign(R[..., 0, 2] + R[..., 2, 0]) * sx
    axis = torch.sqrt(d) * torch.stack([sx, sy, sz], -1)
    axis = axis / torch.clamp_min(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), 1e-12)
    return torch.where((theta > 3.0)[..., None], theta[..., None] * axis, omega_generic)


def _sim3_W(omega: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W = int_0^1 exp(sigma u) R(u omega) du [..., 3, 3], the matrix that maps
    upsilon to t, by the 16-point quadrature (exact to float precision for
    these analytic integrands; no series branches)."""
    theta = torch.linalg.vector_norm(omega, dim=-1)
    small = (theta < _SMALL)[..., None, None, None]
    th = _safe_angle(theta)
    K = skew(omega / th[..., None])[..., None, :, :]
    u = torch.tensor(_GL_NODES, dtype=omega.dtype, device=omega.device)
    w = torch.tensor(_GL_WEIGHTS, dtype=omega.dtype, device=omega.device)
    thu = th[..., None] * u                                            # [..., 16]
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    Ru = eye + torch.sin(thu)[..., None, None] * K + (1.0 - torch.cos(thu))[..., None, None] * (K @ K)
    Ru = torch.where(small, eye + u[:, None, None] * skew(omega)[..., None, :, :], Ru)
    return torch.sum((w * torch.exp(sigma[..., None] * u))[..., None, None] * Ru, dim=-3)


def sim3_exp(v7: torch.Tensor):
    """Sim3 exp: v7 = [omega (3), upsilon (3), sigma (1)] -> (R, t, s) acting
    as x -> s R x + t (Strasdat's Sim3; W by quadrature)."""
    omega, upsilon, sigma = v7[..., 0:3], v7[..., 3:6], v7[..., 6]
    t = torch.einsum("...ij,...j->...i", _sim3_W(omega, sigma), upsilon)
    return so3_exp(omega), t, torch.exp(sigma)


def sim3_log(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The inverse of sim3_exp: (R, t, s) -> v7; upsilon = W^-1 t."""
    omega = so3_log(R)
    sigma = torch.log(s)
    upsilon = torch.linalg.solve(_sim3_W(omega, sigma), t[..., None])[..., 0]
    return torch.cat([omega, upsilon, sigma[..., None]], dim=-1)
