"""Bundle-adjustment problem as flat observation tables (port of
`multicol_slam_tpu/optim/problem.py`).

Parameters: poses [K, 6] (M_t Cayley, body -> world), points [P, 3], mc
[C, 6] (M_c Cayley), intr [C, 22] (`OmniCamera.to_vector` layout). One
observation row per (keyframe, point, camera) measurement. The reference's
per-row `vmap` is a leading batch dimension here, and every Jacobian block
is written in closed form instead of reverse-mode autodiff (eager autodiff
would multiply the ops of every LM iteration).
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch
import torch.nn.functional as F

from multicol_slam_tpu_torch.models.camera import MAX_INVPOL, world_to_img
from multicol_slam_tpu_torch.utils.geometry import (
    cayley_to_hom, cayley_to_rot, hom_inverse, horner, horner_deriv, transform_points,
)

INTR_DIM = 22
_N_POL = 5
_N_INVPOL = 12


class Observations(NamedTuple):
    kf: torch.Tensor          # [O] keyframe index
    pt: torch.Tensor          # [O] point index
    cam: torch.Tensor         # [O] camera index
    uv: torch.Tensor          # [O, 2] f32 measured pixel
    inv_sigma2: torch.Tensor  # [O] f32 information (1 / sigma^2 of the octave)
    valid: torch.Tensor       # [O] bool


class FreeMask(NamedTuple):
    """Which variable groups a solve moves (g2o's setFixed). mc / intr: a
    bool for every camera, or a [C] bool tensor."""

    poses: torch.Tensor   # [K] bool
    points: torch.Tensor  # [P] bool
    mc: Union[bool, torch.Tensor] = False
    intr: Union[bool, torch.Tensor] = False


class BAParams(NamedTuple):
    poses: torch.Tensor   # [K, 6]
    points: torch.Tensor  # [P, 3]
    mc: torch.Tensor      # [C, 6]
    intr: torch.Tensor    # [C, INTR_DIM]


def _invpol(intr_vec: torch.Tensor) -> torch.Tensor:
    return F.pad(intr_vec[..., 5 + _N_POL:], (0, MAX_INVPOL - _N_INVPOL))


def intr_project(intr_vec: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points with the packed intrinsics vector."""
    return world_to_img(_invpol(intr_vec), intr_vec[..., 0:3], intr_vec[..., 3:5], Xc)


def project_obs(pose6, mc6, intr_vec, X):
    """uv = pi_intr((cayley2hom(pose) @ cayley2hom(mc))^-1 X), batched over
    leading dims. Returns (uv [..., 2], z_cam [...])."""
    M = torch.matmul(cayley_to_hom(pose6), cayley_to_hom(mc6))
    Xc = transform_points(hom_inverse(M), X)
    return intr_project(intr_vec, Xc), Xc[..., 2]


def residual_one(pose6, mc6, intr_vec, X, uv_meas):
    """r = measured - predicted. Returns (r [..., 2], z_cam [...])."""
    uv, z = project_obs(pose6, mc6, intr_vec, X)
    return uv_meas - uv, z


def _gather(params: BAParams, obs: Observations):
    return (params.poses[obs.kf], params.mc[obs.cam], params.intr[obs.cam], params.points[obs.pt])


def residuals_only(params: BAParams, obs: Observations):
    p6, m6, iv, X = _gather(params, obs)
    return residual_one(p6, m6, iv, X, obs.uv)


def _cayley_rot_jac(c: torch.Tensor) -> torch.Tensor:
    """dR/dc_k for the Cayley rotation: [..., 3 (k), 3, 3]."""
    c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2]
    two = torch.full_like(c1, 2.0)
    mtwo = -two
    dA = torch.stack([
        torch.stack([torch.stack([2 * c1, 2 * c2, 2 * c3], -1),
                     torch.stack([2 * c2, -2 * c1, mtwo], -1),
                     torch.stack([2 * c3, two, -2 * c1], -1)], -2),
        torch.stack([torch.stack([-2 * c2, 2 * c1, two], -1),
                     torch.stack([2 * c1, 2 * c2, 2 * c3], -1),
                     torch.stack([mtwo, 2 * c3, -2 * c2], -1)], -2),
        torch.stack([torch.stack([-2 * c3, mtwo, 2 * c1], -1),
                     torch.stack([two, -2 * c3, 2 * c2], -1),
                     torch.stack([2 * c1, 2 * c2, 2 * c3], -1)], -2),
    ], -3)
    s = (1.0 + c1 * c1 + c2 * c2 + c3 * c3)[..., None, None, None]
    R = cayley_to_rot(c)[..., None, :, :]
    return (dA - 2.0 * c[..., :, None, None] * R) / s


def _project_jac(intr_vec: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """d intr_project / d Xc: [..., 2, 3]."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    n = torch.clamp_min(torch.sqrt(x * x + y * y), 1e-14)
    theta = torch.atan2(-z, n)
    invpol = _invpol(intr_vec)
    rho = horner(invpol, theta)
    drho = horner_deriv(invpol, theta)
    q = n * n + z * z
    dth = torch.stack([z * x / (n * q), z * y / (n * q), -n / q], -1)          # [..., 3]
    n3 = n * n * n
    zero = torch.zeros_like(x)
    dux = torch.stack([y * y / n3, -x * y / n3, zero], -1)
    duy = torch.stack([-x * y / n3, x * x / n3, zero], -1)
    duu = rho[..., None] * dux + (x / n * drho)[..., None] * dth
    dvv = rho[..., None] * duy + (y / n * drho)[..., None] * dth
    c, d, e = intr_vec[..., 0:1], intr_vec[..., 1:2], intr_vec[..., 2:3]
    return torch.stack([c * duu + d * dvv, e * duu + dvv], -2)


def _jacobians(p6, m6, iv, X, with_points: bool, with_mc: bool, with_intr: bool):
    """Closed-form blocks of dr/dparam for r = uv_meas - pi(intr, Xc), with
    Xc = Rc^T (R^T (X - t) - tc): pose [O, 2, 6], then point [O, 2, 3], mc
    [O, 2, 6] and intr [O, 2, 22] where asked (None otherwise).

    dXc/dc_k = Rc^T (dR/dc_k)^T (X - t), dXc/dt = -Rc^T R^T, dXc/dX = Rc^T R^T,
    dXc/dcc_k = (dRc/dcc_k)^T (R^T (X - t) - tc), dXc/dtc = -Rc^T; the
    intrinsics enter only the projection: u = c uu + d vv + u0,
    v = e uu + vv + v0, (uu, vv) = xy / |xy| * sum_i a_i theta^i."""
    R = cayley_to_rot(p6[..., :3])
    Mc = cayley_to_hom(m6)
    Rc_t = Mc[..., :3, :3].transpose(-1, -2)
    Xc = transform_points(hom_inverse(torch.matmul(cayley_to_hom(p6), Mc)), X)
    D = X - p6[..., 3:]
    dR = _cayley_rot_jac(p6[..., :3])                                      # [O, 3k, 3, 3]
    dXc_dc = torch.einsum("oij,okmj,om->oik", Rc_t, dR, D)                 # Rc^T dR_k^T D
    dXc_dt = -torch.matmul(Rc_t, R.transpose(-1, -2))
    dP = _project_jac(iv, Xc)                                              # [O, 2, 3]
    Jp = -torch.matmul(dP, torch.cat([dXc_dc, dXc_dt], -1))
    Jx = Jm = Ji = None
    if with_points:
        Jx = torch.matmul(dP, dXc_dt)                                      # -dP (-Rc^T R^T)
    if with_mc:
        Y = torch.einsum("oji,oj->oi", R, D) - m6[..., 3:]                 # R^T (X - t) - tc
        dRc = _cayley_rot_jac(m6[..., :3])
        dXc_dcc = torch.einsum("okmi,om->oik", dRc, Y)                     # dRc_k^T Y
        Jm = -torch.matmul(dP, torch.cat([dXc_dcc, -Rc_t], -1))
    if with_intr:
        x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        n = torch.clamp_min(torch.sqrt(x * x + y * y), 1e-14)
        theta = torch.atan2(-z, n)
        rho = horner(_invpol(iv), theta)
        ux, uy = x / n, y / n
        uu, vv = ux * rho, uy * rho
        c, d, e = iv[..., 0], iv[..., 1], iv[..., 2]
        zero, one = torch.zeros_like(x), torch.ones_like(x)
        powers = theta[..., None] ** torch.arange(_N_INVPOL, dtype=theta.dtype, device=theta.device)
        du_da = (c * ux + d * uy)[..., None] * powers
        dv_da = (e * ux + uy)[..., None] * powers
        pol0 = torch.zeros(x.shape + (_N_POL,), dtype=x.dtype, device=x.device)
        du = torch.cat([torch.stack([uu, vv, zero, one, zero], -1), pol0, du_da], -1)
        dv = torch.cat([torch.stack([zero, zero, uu, zero, one], -1), pol0, dv_da], -1)
        Ji = -torch.stack([du, dv], -2)
    return Jp, Jx, Jm, Ji


def residuals_and_jacobians(params: BAParams, obs: Observations,
                            with_mc: bool = True, with_intr: bool = True):
    """r [O, 2], z [O] and the Jacobian blocks, observation-major: Jpose
    [O, 2, 6], Jpt [O, 2, 3], Jmc [O, 2, 6], Jintr [O, 2, INTR_DIM]; Jmc /
    Jintr are None when with_mc / with_intr is False (the standard BA modes
    keep the rig fixed)."""
    p6, m6, iv, X = _gather(params, obs)
    r, z = residual_one(p6, m6, iv, X, obs.uv)
    Jp, Jx, Jm, Ji = _jacobians(p6, m6, iv, X, True, with_mc, with_intr)
    return r, z, Jp, Jx, Jm, Ji


def pose_residuals_and_jac(params: BAParams, obs: Observations):
    """r [O, 2], z [O] and the pose Jacobian dr/dpose [O, 2, 6] only (the
    pose-only solve of tracking)."""
    p6, m6, iv, X = _gather(params, obs)
    r, z = residual_one(p6, m6, iv, X, obs.uv)
    return r, z, _jacobians(p6, m6, iv, X, False, False, False)[0]


def huber_weights(r: torch.Tensor, z: torch.Tensor, obs: Observations, delta: float):
    """IRLS weights inv_sigma2 * min(1, delta / e), e the sigma-normalized
    residual norm; zero for invalid rows and points behind the camera.
    Returns (w [O], chi2 [O])."""
    e2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    e = torch.sqrt(e2 + 1e-18)
    w_huber = torch.clamp_max(delta / e, 1.0)
    ok = obs.valid & (z > 0)
    zero = torch.zeros_like(e2)
    return torch.where(ok, obs.inv_sigma2 * w_huber, zero), torch.where(ok, e2, zero)


def robust_cost(r, z, obs: Observations, delta: float) -> torch.Tensor:
    """Total Huber cost."""
    e2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    e = torch.sqrt(e2 + 1e-18)
    rho = torch.where(e <= delta, e2, 2.0 * delta * e - delta * delta)
    ok = obs.valid & (z > 0)
    return torch.sum(torch.where(ok, rho, torch.zeros_like(rho)))
