"""Plain Levenberg-Marquardt bundle adjustment of keyframe poses and points,
written from the description of MultiCol-SLAM's BA as the port states it:

residual r = measured pixel - projection of the point through the body pose
and the camera's fixed extrinsics and intrinsics; the robust cost sums
e^2 (e <= delta) or 2 delta e - delta^2 over valid rows in front of the
camera, e the sigma-normalized residual norm (e^2 = |r|^2 s, s the row's
inverse variance of its pyramid level, 1 where the problem gives none);
each iteration reweights the rows by s times Huber (IRLS), solves the damped normal equations (H + lambda
diag(H_blocks)) delta = -J^T W r for the free poses and points by a fixed
number of preconditioned conjugate-gradient steps (block-Jacobi: each
pose's 6x6 and each point's 3x3 block, damped alike, plus 1e-6 I), and
keeps the step when it lowers the cost (lambda x 0.5, else x 4, within
[1e-9, 1e6]); it stops once a kept step gains less than gain_eps of the
cost.

Plain torch in the precision of its inputs; the Jacobians come from
forward automatic differentiation of one row, sums over rows from
index_add_.
"""
from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from benchmark.reference.geometry import hom, hom_inv, project


def _row(pose6, X, mc6, intr):
    """The projection of one row; batch axes of one keep every intermediate
    a tensor of rank >= 1 under forward differentiation."""
    Minv = hom_inv(hom(pose6[None]) @ hom(mc6[None]))
    Xc = (Minv[:, :3, :3] @ X[None, :, None])[..., 0] + Minv[:, :3, 3]
    return project(intr[None, 10:22], intr[None, 0:3], intr[None, 3:5], Xc)[0], Xc[0, 2]


_proj = vmap(_row)
_jac = vmap(jacfwd(lambda *a: _row(*a)[0], argnums=(0, 1)))


def residuals(poses, points, mc, intr, kf, pt, cam, uv):
    pred, z = _proj(poses[kf], points[pt], mc[cam], intr[cam])
    return uv - pred, z


def robust_cost(r, z, valid, delta, inv_sigma2=None):
    e2 = (r * r).sum(-1) * (1.0 if inv_sigma2 is None else inv_sigma2)
    e = torch.sqrt(e2 + 1e-18)
    rho = torch.where(e <= delta, e2, 2.0 * delta * e - delta * delta)
    return torch.where(valid & (z > 0), rho, torch.zeros_like(rho)).sum()


def _segsum(rows, ids, n):
    out = torch.zeros((n,) + rows.shape[1:], dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, ids, rows)


def _damp(B, lam):
    return lam * torch.clamp_min(torch.diagonal(B, dim1=-2, dim2=-1), 1e-8)


def solve(prob, lm: dict, dtype=torch.float32):
    """(poses, points, cost) after the LM loop on `prob` (benchmark.baproblem.Problem)."""
    poses, points = prob.poses.to(dtype), prob.points.to(dtype)
    mc, intr = prob.mc.to(dtype), prob.intr.to(dtype)
    kf, pt, cam, uv, valid = prob.kf, prob.pt, prob.cam, prob.uv.to(dtype), prob.valid
    K, P = poses.shape[0], points.shape[0]
    fp = prob.free_poses.to(dtype)[:, None]
    s = torch.ones_like(uv[:, 0]) if prob.inv_sigma2 is None else prob.inv_sigma2.to(dtype)
    delta = float(lm["huber_delta"])
    lam = float(lm["init_lambda"])
    r, z = residuals(poses, points, mc, intr, kf, pt, cam, uv)
    cost = robust_cost(r, z, valid, delta, s)
    for _ in range(int(lm["max_iters"])):
        r, z = residuals(poses, points, mc, intr, kf, pt, cam, uv)
        Jp, Jx = _jac(poses[kf], points[pt], mc[cam], intr[cam])
        Jp, Jx = -Jp, -Jx                                   # d r / d parameters
        e = torch.sqrt((r * r).sum(-1) * s + 1e-18)
        w = torch.where(valid & (z > 0), s * torch.clamp_max(delta / e, 1.0), torch.zeros_like(e))
        wr = -(w[:, None] * r)
        g_pose = _segsum(torch.einsum("oij,oi->oj", Jp, wr), kf, K) * fp
        g_pt = _segsum(torch.einsum("oij,oi->oj", Jx, wr), pt, P)
        U = _segsum(torch.einsum("oia,o,oib->oab", Jp, w, Jp), kf, K)
        V = _segsum(torch.einsum("oia,o,oib->oab", Jx, w, Jx), pt, P)
        dU, dV = _damp(U, lam), _damp(V, lam)
        eye6, eye3 = torch.eye(6, dtype=dtype, device=U.device), torch.eye(3, dtype=dtype, device=U.device)
        # the block inverses in float32 at least (no lower-precision inverse exists)
        Ui = torch.linalg.inv((U + dU[..., None] * eye6 + 1e-6 * eye6).float()).to(dtype)
        Vi = torch.linalg.inv((V + dV[..., None] * eye3 + 1e-6 * eye3).float()).to(dtype)

        def hvp(vp, vx):
            vp = vp * fp
            jv = torch.einsum("oij,oj->oi", Jp, vp[kf]) + torch.einsum("oij,oj->oi", Jx, vx[pt])
            wjv = w[:, None] * jv
            hp = _segsum(torch.einsum("oij,oi->oj", Jp, wjv), kf, K) + dU * vp
            hx = _segsum(torch.einsum("oij,oi->oj", Jx, wjv), pt, P) + dV * vx
            return hp * fp, hx

        def precond(gp, gx):
            return torch.einsum("kab,kb->ka", Ui, gp) * fp, torch.einsum("kab,kb->ka", Vi, gx)

        xp, xx = torch.zeros_like(g_pose), torch.zeros_like(g_pt)
        rp, rx = g_pose, g_pt
        zp, zx = precond(rp, rx)
        pp_, px = zp, zx
        rz = (rp * zp).sum() + (rx * zx).sum()
        for _ in range(int(lm["cg_iters"])):
            hp, hx = hvp(pp_, px)
            alpha = rz / torch.clamp_min((pp_ * hp).sum() + (px * hx).sum(), 1e-20)
            xp, xx = xp + alpha * pp_, xx + alpha * px
            rp, rx = rp - alpha * hp, rx - alpha * hx
            zp, zx = precond(rp, rx)
            rz_new = (rp * zp).sum() + (rx * zx).sum()
            beta = rz_new / torch.clamp_min(rz, 1e-20)
            pp_, px = zp + beta * pp_, zx + beta * px
            rz = rz_new
        xp = torch.where(torch.isfinite(xp), xp, torch.zeros_like(xp)) * fp
        xx = torch.where(torch.isfinite(xx), xx, torch.zeros_like(xx))
        new_poses, new_points = poses + xp, points + xx
        r, z = residuals(new_poses, new_points, mc, intr, kf, pt, cam, uv)
        new_cost = robust_cost(r, z, valid, delta, s)
        if bool(new_cost < cost):
            gain = float((cost - new_cost) / torch.clamp_min(torch.abs(cost), 1e-12))
            poses, points, cost = new_poses, new_points, new_cost
            lam = min(max(lam * float(lm["lambda_down"]), 1e-9), 1e6)
            if gain < float(lm["gain_eps"]):
                break
        else:
            lam = min(max(lam * float(lm["lambda_up"]), 1e-9), 1e6)
    return poses, points, cost
