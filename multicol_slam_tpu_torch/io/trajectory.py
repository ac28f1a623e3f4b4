"""Trajectory output and ATE evaluation (port of
`multicol_slam_tpu/io/trajectory.py`).

The output matches the reference's SaveMKFTrajectoryLAFIDA
(cSystem.cpp:260-290): one line per tracked frame, `timestamp tx ty tz qx qy
qz qw` of the body pose M_t (body -> world), TUM / Lafida style.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from multicol_slam_tpu_torch.slam.map_store import cayley_to_hom_np, hom_to_cayley_np
from multicol_slam_tpu_torch.utils.geometry import cayley_to_hom, rot_to_quat

WORKING = 3  # slam/system.py's tracking state of a tracked frame


def pose_to_tum_line(timestamp: float, pose6: np.ndarray) -> str:
    M = cayley_to_hom(torch.tensor(np.asarray(pose6, np.float32)))
    q = rot_to_quat(M[:3, :3]).numpy()
    t = M[:3, 3].numpy()
    return (f"{timestamp:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
            f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}")


def save_lafida_trajectory(path: str, metrics: Sequence, store=None) -> None:
    """metrics: FrameMetrics (slam/system.py). Only frames tracked in the
    WORKING state are written. With `store` (the final MapStore), each
    frame's pose is its reference keyframe's FINAL pose composed with the
    relative pose recorded at track time, as the reference writes its
    trajectory at shutdown from keyframe poses; frames whose keyframe was
    culled (or whose slot was recycled) keep their track-time pose."""
    with open(path, "w") as f:
        for m in metrics:
            if m.state != WORKING:
                continue
            pose = m.pose
            if (store is not None and m.rel_pose is not None
                    and 0 <= m.ref_kf < len(store.kf_valid)
                    and store.kf_valid[m.ref_kf]
                    and int(store.kf_frame_id[m.ref_kf]) == m.ref_kf_frame):
                pose = hom_to_cayley_np(cayley_to_hom_np(store.kf_pose[m.ref_kf])
                                        @ cayley_to_hom_np(m.rel_pose))
            f.write(pose_to_tum_line(m.timestamp, pose) + "\n")


def load_tum_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (timestamps [N], positions [N, 3])."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    return data[:, 0], data[:, 1:4]


def ate_rmse(t_est: np.ndarray, p_est: np.ndarray, t_gt: np.ndarray, p_gt: np.ndarray,
             align: bool = True, with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after nearest-timestamp association and
    (optionally) a Sim3 / SE3 Umeyama alignment."""
    if len(t_est) == 0 or len(t_gt) == 0:
        return float("inf")
    idx = np.searchsorted(t_gt, t_est)
    idx = np.clip(idx, 1, len(t_gt) - 1)
    choose_left = np.abs(t_est - t_gt[idx - 1]) < np.abs(t_est - t_gt[idx])
    idx = idx - choose_left.astype(int)
    tol = 2.0 * np.median(np.diff(t_gt)) if len(t_gt) > 1 else np.inf
    ok = np.abs(t_gt[idx] - t_est) <= tol
    if ok.sum() < 3:
        return float("inf")
    A = p_est[ok]
    B = p_gt[idx[ok]]
    if align:
        A = umeyama_align(A, B, with_scale=with_scale)
    return float(np.sqrt(np.mean(np.sum((A - B) ** 2, axis=-1))))


def umeyama_align(A: np.ndarray, B: np.ndarray, with_scale: bool = True) -> np.ndarray:
    """Align A onto B with the closed-form similarity (Umeyama 1991)."""
    muA, muB = A.mean(0), B.mean(0)
    Ac, Bc = A - muA, B - muB
    cov = Bc.T @ Ac / len(A)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / max((Ac ** 2).sum() / len(A), 1e-12) if with_scale else 1.0
    t = muB - s * R @ muA
    return (s * (R @ A.T)).T + t
