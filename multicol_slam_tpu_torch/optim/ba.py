"""BA entry points (port of `pose_optimization` in
`multicol_slam_tpu/optim/ba.py`; the other modes wait)."""
from __future__ import annotations

from multicol_slam_tpu_torch.optim.lm import pose_only_solve
from multicol_slam_tpu_torch.optim.problem import BAParams, Observations

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
