"""Pose-only damped Gauss-Newton (port of `pose_only_solve` in
`multicol_slam_tpu/optim/lm.py`; the full LM / PCG solver waits).

The reference stops its `lax.while_loop` early once a step converges. Here
the loop always runs `n_iters` iterations and freezes the state with
`torch.where` once converged: the same result, with no host sync per
iteration.
"""
from __future__ import annotations

from typing import Tuple

import torch

from multicol_slam_tpu_torch.optim.problem import (
    BAParams, Observations, huber_weights, pose_residuals_and_jac, residuals_only, robust_cost,
)


def pose_only_solve(
    params: BAParams,
    obs: Observations,
    n_iters: int = 10,
    huber_delta: float = 2.69,
    lam: float = 1e-3,
) -> Tuple[BAParams, torch.Tensor]:
    """Optimize the body pose with everything else fixed (one pose, K = 1:
    the tracking case). Returns (params with the updated pose, chi2 [O] of
    the final residuals, inf for rows that are invalid or behind the camera)."""
    if params.poses.shape[0] != 1:
        raise ValueError("pose_only_solve is ported for a single pose (K = 1) only")
    dev = params.poses.device
    eye = torch.eye(6, dtype=params.poses.dtype, device=dev)

    def cost_of(p):
        r, z = residuals_only(p, obs)
        return robust_cost(r, z, obs, huber_delta)

    p = params
    lam_i = torch.full((), lam, dtype=torch.float32, device=dev)
    cost = cost_of(p)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(n_iters):
        r, z, Jp = pose_residuals_and_jac(p, obs)
        w, _ = huber_weights(r, z, obs, huber_delta)
        g = torch.einsum("oij,oi->j", Jp, -(w[:, None] * r))[None]
        H = torch.einsum("oia,o,oib->ab", Jp, w, Jp)[None]
        diag = torch.clamp_min(torch.diagonal(H, dim1=-2, dim2=-1), 1e-8)
        Hd = H + (lam_i * diag)[..., None] * eye + 1e-8 * eye
        delta = torch.linalg.solve_ex(Hd, g[..., None]).result[..., 0]
        delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
        cand = p._replace(poses=p.poses + delta)
        new_cost = cost_of(cand)
        accept = torch.isfinite(new_cost) & (new_cost <= cost) & ~done
        p = p._replace(poses=torch.where(accept, cand.poses, p.poses))
        lam_i = torch.where(done, lam_i, torch.clamp(
            torch.where(accept, lam_i * 0.5, lam_i * 10.0), 1e-6, 1e4))
        cost = torch.where(accept, new_cost, cost)
        done = done | (accept & (torch.max(torch.abs(delta)) < 1e-6))
    r, z = residuals_only(p, obs)
    e2 = torch.sum(r * r, -1) * obs.inv_sigma2
    chi2 = torch.where(obs.valid & (z > 0), e2, torch.full_like(e2, float("inf")))
    return p, chi2
