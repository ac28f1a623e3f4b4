"""Per-frame tracking: project -> match -> pose-optimize, and the window
match of the map bootstrap (port of `multicol_slam_tpu/slam/tracking_kernels.py`).

Each stage projects the local map into every camera, gates it (in front,
inside the mirror, scale band, viewing angle), takes every feature's best
map point inside its window and level band with the best-match kernel
(`ops/best_match.py`), settles duplicate claims, and runs two rounds of
robust pose-only Gauss-Newton (on the card, one launch of the pose kernel,
`optim/ba.pose_optimization`). `track_frame_fused` runs the motion-model
stage and the local-map stage and packs the result into one tensor, with
no host sync on the way. `match_window_frames` matches two frames camera by
camera with two launches of the same kernel (forward and swapped, for the
mutual check).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from multicol_slam_tpu_torch.models.camera import OmniCamera, in_mirror_mask
from multicol_slam_tpu_torch.ops.best_match import BIG, masked_best_match_cams
from multicol_slam_tpu_torch.ops.matching import rotation_consistency
from multicol_slam_tpu_torch.optim.ba import pose_optimization_iters
from multicol_slam_tpu_torch.optim.problem import BAParams, Observations, intr_project
from multicol_slam_tpu_torch.slam.features import FrameFeatures
from multicol_slam_tpu_torch.utils import tracing
from multicol_slam_tpu_torch.utils.geometry import cayley_to_hom, hom_inverse, transform_points


class LocalPoints(NamedTuple):
    """Padded candidate map-point block for one tracking stage."""

    X: torch.Tensor         # [L, 3]
    desc: torch.Tensor      # [L, B] uint8
    min_dist: torch.Tensor  # [L]
    max_dist: torch.Tensor  # [L]
    valid: torch.Tensor     # [L] bool
    normal: Optional[torch.Tensor] = None  # [L, 3] mean viewing direction; zero rows pass
    dmask: Optional[torch.Tensor] = None   # [L, B] mdBRIEF stability masks


class TrackStageOut(NamedTuple):
    pose: torch.Tensor       # [6] optimized body pose
    assign: torch.Tensor     # [C*K] local point index or -1
    inlier: torch.Tensor     # [C*K] bool
    n_matches: torch.Tensor  # scalar
    n_inliers: torch.Tensor  # scalar
    packed: torch.Tensor     # [8 + 2*C*K] f32: pose, n_matches, n_inliers, assign, inlier

    def fetch(self):
        """One-readback host view: (pose f32[6], n_matches, n_inliers,
        assign i32[C*K], inlier bool[C*K])."""
        p = self.packed.cpu().numpy()
        ck = (len(p) - 8) // 2
        return p[:6], int(p[6]), int(p[7]), p[8:8 + ck].astype(np.int32), p[8 + ck:8 + 2 * ck] > 0.5


def project_rig(mc6, intr, pose6, X):
    """World points X [L, 3] -> uv [C, L, 2] and z [C, L] in every camera."""
    Mt = cayley_to_hom(pose6)
    MtMc_inv = hom_inverse(torch.einsum("ij,cjk->cik", Mt, cayley_to_hom(mc6)))
    Xc = transform_points(MtMc_inv[:, None], X[None, :, :])
    uv = intr_project(intr[:, None, :], Xc)
    return uv, Xc[..., 2]


def _resolve_claims(best_pt, best_d, ok, L):
    """A feature keeps its claim on point p iff no other feature of the same
    camera claims p at a smaller distance (one match per (camera, point)).
    best_pt / best_d / ok [C, K] -> keep [C, K]."""
    C = best_pt.shape[0]
    claimed = torch.where(ok, best_d, torch.full_like(best_d, BIG))
    claimed_min = torch.full((C, L), BIG, dtype=best_d.dtype, device=best_d.device)
    claimed_min = claimed_min.scatter_reduce(1, best_pt, claimed, reduce="amin")
    return ok & (best_d <= torch.gather(claimed_min, 1, best_pt))


def project_and_match(
    mc6: torch.Tensor,
    intr: torch.Tensor,
    cams: OmniCamera,
    feats: FrameFeatures,
    pose0: torch.Tensor,
    pts: LocalPoints,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    radius: float = 15.0,
    th_desc: float = 96.0,
    level_tol: int = 1,
    use_masks: bool = False,
    match_fn: Callable = masked_best_match_cams,
):
    """Projection-guided matching of candidate points against frame features.
    Returns (assign [C*K] local point index or -1, dist [C*K], keep [C*K]).
    `match_fn` is the best-match kernel's wrapper, or its plain version to
    compare against. use_masks needs a x0.5-scaled th_desc."""
    C, K, B = feats.desc.shape
    L = pts.X.shape[0]
    uv_p, z = project_rig(mc6, intr, pose0, pts.X)
    cam_ids = torch.arange(C, device=pts.X.device)[:, None]
    in_img = in_mirror_mask(cams, cam_ids, uv_p)
    Mt = cayley_to_hom(pose0)
    centers = torch.einsum("ij,cjk->cik", Mt, cayley_to_hom(mc6))[:, :3, 3]
    view = pts.X[None] - centers[:, None]
    dist = torch.linalg.vector_norm(view, dim=-1)
    band = (dist >= pts.min_dist[None] * 0.8) & (dist <= pts.max_dist[None] * 1.2)
    ratio = torch.clamp_min(dist / torch.clamp_min(pts.min_dist[None], 1e-6), 1.0)
    pred_level = torch.clamp(
        torch.round(torch.log(ratio) / math.log(scale_factor)).to(torch.int32), 0, n_levels - 1)
    cand = pts.valid[None] & (z > 0) & in_img & band
    if pts.normal is not None:
        ncos = torch.sum(view * pts.normal[None], dim=-1) / torch.clamp_min(dist, 1e-9)
        have_n = torch.linalg.vector_norm(pts.normal, dim=-1) > 1e-6
        cand = cand & (~have_n[None] | (ncos > 0.5))
    # the search window grows with the level the point is predicted at
    # (SearchByProjection, cORBmatcher.cpp:93-97)
    rad = radius * torch.pow(scale_factor, pred_level.to(torch.float32))
    rad_t = torch.where(cand, rad, torch.full_like(rad, -1.0))
    rad_q = torch.where(feats.valid, torch.full(feats.valid.shape, BIG, device=rad.device),
                        torch.full(feats.valid.shape, -1.0, device=rad.device))
    masked = use_masks and pts.dmask is not None
    best_d, _, idx, _ = match_fn(
        feats.desc, feats.uv, feats.octave, pts.desc, uv_p.contiguous(), rad_t,
        pred_level.to(torch.float32), rad_q=rad_q,
        mask_q=feats.dmask if masked else None,
        mask_t=pts.dmask if masked else None,
        level_tol=float(level_tol),
    )
    best_pt = torch.clamp_min(idx, 0).to(torch.int64)
    ok = (idx >= 0) & (best_d <= th_desc)
    keep = _resolve_claims(best_pt, best_d, ok, L).reshape(C * K)
    assign = torch.where(keep, best_pt.reshape(C * K), torch.full_like(best_pt.reshape(C * K), -1))
    return assign, best_d.reshape(C * K), keep


def track_stage(
    mc6, intr, cams, feats: FrameFeatures, pose0, pts: LocalPoints,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    radius: float = 15.0,
    th_desc: float = 96.0,
    level_tol: int = 1,
    use_masks: bool = False,
    match_fn: Callable = masked_best_match_cams,
) -> TrackStageOut:
    """One matching + pose-optimization stage."""
    C, K, B = feats.desc.shape
    dev = pose0.device
    with tracing.span("track.match"):
        assign, _, keep = project_and_match(
            mc6, intr, cams, feats, pose0, pts, scale_factor, n_levels, radius, th_desc,
            level_tol, use_masks, match_fn,
        )
    n_matches = keep.sum()
    obs = Observations(
        kf=torch.zeros(C * K, dtype=torch.int64, device=dev),
        pt=torch.clamp_min(assign, 0),
        cam=torch.arange(C, device=dev).repeat_interleave(K),
        uv=feats.uv.reshape(C * K, 2),
        inv_sigma2=(1.0 / torch.pow(scale_factor, 2.0 * feats.octave.to(torch.float32))).reshape(C * K),
        valid=keep,
    )
    with tracing.span("track.pose") as sp:
        params = BAParams(pose0[None].contiguous(), pts.X.contiguous(), mc6.contiguous(), intr.contiguous())
        poses_out, inl, n_inl, iters = pose_optimization_iters(params, obs)
        if sp is not None:
            # rows, the valid ones and (on the card) both rounds' iterations;
            # device values are read when the counters are
            sp.count(rows=keep.shape[0], valid_rows=lambda: keep.sum())
            if iters is not None:
                sp.count(iters=lambda: iters.sum())
    packed = torch.cat([
        poses_out[0],
        torch.stack([n_matches, n_inl]).to(torch.float32),
        assign.to(torch.float32),
        inl.to(torch.float32),
    ])
    return TrackStageOut(poses_out[0], assign, inl, n_matches, n_inl, packed)


def track_frame_fused(
    mc6, intr, cams, feats: FrameFeatures, pose_pred,
    pts1: LocalPoints,
    pts2: LocalPoints,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    radius1: float = 15.0,
    radius2: float = 4.0,
    th_desc: float = 96.0,
    level_tol: int = 1,
    min_pose_inliers: int = 6,
    use_masks: bool = False,
    match_fn: Callable = masked_best_match_cams,
) -> torch.Tensor:
    """Motion-model stage on pts1, then the local-map stage on pts2 from stage
    1's pose when it found enough inliers (else from the prediction).
    Returns packed f32 [7 + 8 + 2*C*K]: stage-1 pose (6) and n_inliers (1),
    then stage 2's `TrackStageOut.packed`."""
    with tracing.span("track.fused"):
        o1 = track_stage(mc6, intr, cams, feats, pose_pred, pts1, scale_factor, n_levels,
                         radius1, th_desc, level_tol, use_masks, match_fn)
        pose1 = torch.where(o1.n_inliers >= min_pose_inliers, o1.pose, pose_pred)
        o2 = track_stage(mc6, intr, cams, feats, pose1, pts2, scale_factor, n_levels,
                         radius2, th_desc, level_tol, use_masks, match_fn)
        return torch.cat([o1.pose, o1.n_inliers[None].to(torch.float32), o2.packed])


def unpack_fused(packed_np: np.ndarray):
    """Host side of track_frame_fused: (pose1, n1, pose2, n_match2, n_inl2,
    assign2, inlier2)."""
    pose1 = packed_np[:6]
    n1 = int(packed_np[6])
    p = packed_np[7:]
    ck = (len(p) - 8) // 2
    return (
        pose1, n1, p[:6], int(p[6]), int(p[7]),
        p[8:8 + ck].astype(np.int32), p[8 + ck:8 + 2 * ck] > 0.5,
    )


def match_window_frames(
    feats_q: FrameFeatures,
    feats_t: FrameFeatures,
    radius: float = 100.0,
    th_desc: float = 64.0,
    ratio: float = 0.9,
    check_rotation: bool = False,
    use_masks: bool = False,
    match_fn: Callable = masked_best_match_cams,
):
    """Same-camera window matching between two frames (WindowSearch /
    SearchForInitialization, cORBmatcher.cpp:326/:579): per-camera Hamming
    inside a square window of `radius` px, Lowe ratio, mutual consistency
    through the swapped call (targets as queries), and optionally the
    rotation-histogram filter and the mdBRIEF masked distance (use_masks;
    pass a x0.5-scaled th_desc). `match_fn` is the best-match kernel's
    wrapper, or its plain version to compare against.

    Returns (match_idx [C, K] target index or -1, dist [C, K])."""
    C, K, _ = feats_q.desc.shape
    dev = feats_q.desc.device
    zeros = torch.zeros((C, K), dtype=torch.float32, device=dev)
    rad_t = torch.where(feats_t.valid, torch.full_like(zeros, float(radius)), torch.full_like(zeros, -1.0))
    rad_q = torch.where(feats_q.valid, torch.full_like(zeros, BIG), torch.full_like(zeros, -1.0))
    best, second, idx, _ = match_fn(
        feats_q.desc, feats_q.uv, zeros, feats_t.desc, feats_t.uv, rad_t, zeros, rad_q=rad_q,
        mask_q=feats_q.dmask if use_masks else None,
        mask_t=feats_t.dmask if use_masks else None, level_tol=1e9)
    _, _, i_tq, _ = match_fn(
        feats_t.desc, feats_t.uv, zeros, feats_q.desc, feats_q.uv, rad_q, zeros, rad_q=rad_t,
        mask_q=feats_t.dmask if use_masks else None,
        mask_t=feats_q.dmask if use_masks else None, level_tol=1e9)
    idx0 = torch.clamp_min(idx, 0).long()
    ok = (idx >= 0) & (best <= th_desc) & (best < ratio * second)
    q_ids = torch.arange(K, dtype=i_tq.dtype, device=dev)[None, :]
    ok = ok & (torch.gather(i_tq, 1, idx0) == q_ids)
    if check_rotation:
        dangle = (feats_q.angle - torch.gather(feats_t.angle, 1, idx0)).reshape(C * K)
        ok = rotation_consistency(dangle, ok.reshape(C * K)).reshape(C, K)
    return torch.where(ok, idx, torch.full_like(idx, -1)), best
