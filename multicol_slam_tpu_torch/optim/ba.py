"""BA entry points (port of `multicol_slam_tpu/optim/ba.py`: the pose-only,
local, global, structure-only and self-calibrating modes; the Sim3 and
essential-graph solvers of loop closing wait).

Every mode is the same (params, observations, free mask) structure solved
by optim/lm.py; the mode chooses only the masks and the robust-kernel
constants."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from multicol_slam_tpu_torch.optim.lm import (
    LMConfig, lm_solve, lm_solve_interruptible, pose_only_solve,
)
from multicol_slam_tpu_torch.optim.problem import BAParams, FreeMask, Observations, residuals_only

CHI2_BA = 5.991                      # Huber sqrt(5.991) in BA
POSE_HUBER = 1.345 * 2.0             # cOptimizer.cpp:344 (huberMultiplier = 2)
CHI2_POSE = POSE_HUBER * POSE_HUBER  # outlier demotion threshold


def pose_optimization(params: BAParams, obs: Observations):
    """Two rounds of pose-only optimization with chi2 outlier demotion between
    them. Returns (poses [K, 6], inlier mask [O], n_inliers)."""
    p1, chi2 = pose_only_solve(params, obs, n_iters=10, huber_delta=POSE_HUBER)
    inl = obs.valid & (chi2 < CHI2_POSE)
    p2, chi2b = pose_only_solve(p1, obs._replace(valid=inl), n_iters=10, huber_delta=POSE_HUBER)
    inl2 = obs.valid & (chi2b < CHI2_POSE)
    return p2.poses, inl2, inl2.sum()


def _config(max_iters: int, cg_iters: int) -> LMConfig:
    return LMConfig(max_iters=max_iters, cg_iters=cg_iters, huber_delta=float(np.sqrt(CHI2_BA)))


def bundle_adjust(
    params: BAParams,
    obs: Observations,
    free: FreeMask,
    max_iters: int = 15,
    cg_iters: int = 20,
) -> Tuple[BAParams, torch.Tensor]:
    """Generic BA: global (every pose free but the anchors), local, structure-
    only (poses fixed) or self-calibrating (mc / intr free), all encoded by
    `free`; Huber sqrt(5.991)."""
    return lm_solve(params, obs, free, _config(max_iters, cg_iters))


def bundle_adjust_interruptible(
    params: BAParams,
    obs: Observations,
    free: FreeMask,
    max_iters: int = 15,
    cg_iters: int = 20,
    interrupt=None,
    chunk_iters: int = 1,
) -> Tuple[BAParams, torch.Tensor]:
    """Local BA driven `chunk_iters` LM iterations at a time, abortable
    between chunks (InterruptBA, cLocalMapping.cpp:515)."""
    return lm_solve_interruptible(params, obs, free, _config(max_iters, cg_iters), interrupt,
                                  chunk_iters=chunk_iters)


def prune_observations(params: BAParams, obs: Observations, chi2_th: float = CHI2_BA) -> torch.Tensor:
    """Post-BA outlier pruning (LocalBundleAdjustment's chi2 erase pass,
    cOptimizer.cpp:798-860). Returns the updated valid mask."""
    r, z = residuals_only(params, obs)
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    return obs.valid & (chi2 <= chi2_th) & (z > 0)
