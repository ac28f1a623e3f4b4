"""Two-view map bootstrap (port of `multicol_slam_tpu/slam/initializer.py`).

  1. per-camera window matching between the reference and the current frame
     (`match_window_frames`: window 100 px, ratio 0.9, rotation check,
     >= 100 matches in all), two launches of the best-match kernel;
  2. per-camera batched essential RANSAC on the matched rays;
  3. the leading camera is the one with the most inliers;
  4. gates on the host: the pure-rotation (parallax) test, triangulation of
     the inliers with cheirality, baseline / depth, and CheckRT's 4 px
     reprojection in both views;
  5. body pose 2 from the leading camera's relative pose,
     Mt2 = Mc[l] inv([R | t]) Mc[l]^-1, at median depth 1;
  6. `calibrate_metric_scale`: the metric scale from the rig's fixed
     extrinsics, by dense scoring of 96 coarse and 64 fine scales.

Matching, RANSAC, triangulation, projections and scale scoring run on the
features' device; the gates (percentiles, Kabsch SVD, medians) run once per
attempt on the host in numpy, as in the reference. The steps after a
successful attempt (the two keyframes and their points written to the map,
cross-camera fusion, global BA) are the system's `_try_initialize`
(slam/system.py).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multicol_slam_tpu_torch.models.camera import cam_world_to_img, in_mirror_mask
from multicol_slam_tpu_torch.models.rig import MultiCamRig
from multicol_slam_tpu_torch.ops.best_match import masked_best_match_cams
from multicol_slam_tpu_torch.ops.matching import hamming_matrix
from multicol_slam_tpu_torch.ops.ransac import ransac_essential, sample_indices
from multicol_slam_tpu_torch.optim.problem import intr_project
from multicol_slam_tpu_torch.slam.features import FrameFeatures
from multicol_slam_tpu_torch.slam.tracking_kernels import match_window_frames
from multicol_slam_tpu_torch.utils.geometry import triangulate_midpoint

MIN_MATCHES = 100            # cTracking.cpp:417
MIN_BASELINE_NORM = 0.06     # cMultiInitializer.cpp:183 translation gate
REPROJ_TH = 4.0              # CheckRT reprojection gate (:200-307)
MIN_MEDIAN_DISPARITY = 0.015  # rad; rotation-compensated parallax floor
SCALE_CHUNK = 16             # scales scored at once by calibrate_metric_scale
DEBUG_INIT = False           # set True to print why `bootstrap` rejects a pair


def _why(reason: str):
    """Print a gate's rejection when DEBUG_INIT is set."""
    if DEBUG_INIT:
        print(f"[bootstrap] reject: {reason}")


class InitResult(NamedTuple):
    ok: bool
    leading_cam: int
    Mt2: np.ndarray             # [4, 4] second body pose (the first is identity)
    points_cam: np.ndarray      # [M, 3] triangulated points in leading cam1 frame
    feat1: np.ndarray           # [M] flat feature index in frame 1
    feat2: np.ndarray           # [M] flat feature index in frame 2
    n_matches: int


def bootstrap(
    rig: MultiCamRig,
    feats1: FrameFeatures,
    feats2: FrameFeatures,
    sampler: Optional[Callable[[int, int], torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    window: float = 100.0,
    n_hyp: int = 256,
    err_th: float = 1e-4,
    use_masks: bool = False,
    match_fn: Callable = masked_best_match_cams,
):
    """Attempt two-view initialization between frames 1 (reference) and 2.

    `sampler(cam, n_data) -> LongTensor [n_hyp, 8]` gives each camera's
    RANSAC hypotheses; by default they are drawn from `generator` (a
    torch.Generator on the features' device, seeded 0 when not given).
    `match_fn` is the best-match kernel's wrapper or its plain version.

    Returns (InitResult | None, n_matches). The caller keeps the same
    reference frame while n_matches stays high, so baseline accumulates."""
    dev = feats1.desc.device
    C, K = feats1.valid.shape
    if sampler is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)   # the same draws on every device
        sampler = lambda cam, n: sample_indices(n_hyp, 8, n, generator)  # noqa: E731
    # masked TH_LOW when mdBRIEF masks are active
    th = (1.0 if use_masks else 2.0) * feats1.desc.shape[-1]
    match_idx_t, _ = match_window_frames(feats1, feats2, radius=window, th_desc=float(th), ratio=0.9,
                                         check_rotation=True, use_masks=use_masks, match_fn=match_fn)
    match_idx = match_idx_t.cpu().numpy()
    n_total = int((match_idx >= 0).sum())
    if n_total < MIN_MATCHES:
        _why(f"matches {n_total} < {MIN_MATCHES}")
        return None, n_total
    best = None
    for c in range(C):
        sel = np.nonzero(match_idx[c] >= 0)[0]
        if len(sel) < 30:
            continue
        sel_t = torch.from_numpy(sel).to(dev)
        r1 = feats1.rays[c][sel_t]
        r2 = feats2.rays[c][match_idx_t[c][sel_t].long()]
        res = ransac_essential(r1, r2, torch.ones(len(sel), dtype=torch.bool, device=dev),
                               err_th=err_th, idx=sampler(c, len(sel)))
        n_inl = int(res.n_inliers)
        if best is None or n_inl > best[1]:
            best = (c, n_inl, res, sel)
    if best is None:
        _why("no camera with >=30 matches")
        return None, n_total
    c, n_inl, res, sel = best
    if n_inl < 0.5 * len(sel) or n_inl < 30:
        _why(f"essential inliers {n_inl}/{len(sel)}")
        return None, n_total
    R = res.R.cpu().numpy().astype(np.float64)
    t = res.t.cpu().numpy().astype(np.float64)
    inl = res.inliers.cpu().numpy()
    r1 = feats1.rays[c].cpu().numpy()[sel]
    r2 = feats2.rays[c].cpu().numpy()[match_idx[c][sel]]
    # degeneracy: the best pure rotation (Kabsch) must leave a top-quartile
    # residual above the parallax floor, or the pair has no usable baseline
    U, _, Vt = np.linalg.svd(r1.T @ r2)
    R0 = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt   # r1 ~ R0 r2
    cosd = np.clip(np.sum(r1 * (r2 @ R0.T), axis=-1), -1.0, 1.0)
    p75 = float(np.percentile(np.arccos(cosd), 75))
    if p75 < MIN_MEDIAN_DISPARITY:
        _why(f"p75 disparity {p75:.4f} < {MIN_MEDIAN_DISPARITY}")
        return None, n_total
    # triangulate the inliers in the cam1 frame (o1 = 0; cam2 centre = -R^T t)
    o2 = np.broadcast_to(-(R.T @ t), r1.shape)
    f32 = dict(dtype=torch.float32, device=dev)
    r1_d = torch.tensor(r1, **f32)
    X_d, lam1, lam2 = triangulate_midpoint(torch.zeros_like(r1_d), r1_d, torch.tensor(o2, **f32),
                                           torch.tensor(r2 @ R, **f32))
    X = X_d.cpu().numpy().astype(np.float64)
    good = inl & (lam1 > 0).cpu().numpy() & (lam2 > 0).cpu().numpy()
    # parallax gate: baseline / median depth (the reference's norm > 0.06 gate)
    med_depth = np.median(np.linalg.norm(X[good], axis=-1)) if good.any() else 0.0
    if med_depth <= 0 or np.linalg.norm(t) / med_depth < 0.02:
        _why(f"baseline/depth {np.linalg.norm(t) / max(med_depth, 1e-9):.4f} < 0.02")
        return None, n_total
    # CheckRT: reprojection in both views
    uv1p = cam_world_to_img(rig.cams, c, torch.tensor(X, **f32)).cpu().numpy()
    uv2p = cam_world_to_img(rig.cams, c, torch.tensor(X @ R.T + t, **f32)).cpu().numpy()
    uv1 = feats1.uv[c].cpu().numpy()[sel]
    uv2 = feats2.uv[c].cpu().numpy()[match_idx[c][sel]]
    good &= np.linalg.norm(uv1p - uv1, axis=-1) < REPROJ_TH
    good &= np.linalg.norm(uv2p - uv2, axis=-1) < REPROJ_TH
    if good.sum() < 30:
        _why(f"CheckRT survivors {int(good.sum())} < 30")
        return None, n_total
    # monocular gauge: median depth -> 1
    med = np.median(np.linalg.norm(X[good], axis=-1))
    if med <= 0:
        return None, n_total
    scale = 1.0 / med
    return InitResult(
        ok=True,
        leading_cam=c,
        Mt2=_mt2_of_scale(rig, c, R, t, scale),
        points_cam=X[good] * scale,
        feat1=c * K + sel[good],
        feat2=c * K + match_idx[c][sel][good],
        n_matches=int(good.sum()),
    ), n_total


def points_to_world(rig: MultiCamRig, leading_cam: int, points_cam: np.ndarray) -> np.ndarray:
    """Leading-cam1 frame -> world (body 1 = identity): X_w = Mc[l] X_c."""
    Mc = rig.Mc[leading_cam].cpu().numpy().astype(np.float64)
    return points_cam @ Mc[:3, :3].T + Mc[:3, 3]


def _mt2_of_scale(rig: MultiCamRig, leading_cam: int, R: np.ndarray, t: np.ndarray, s: float):
    """Body pose 2 for the leading camera's relative pose (R, s t):
    Mt2 = Mc[l] inv([R | s t]) Mc[l]^-1."""
    Mc = rig.Mc[leading_cam].cpu().numpy().astype(np.float64)
    T21 = np.eye(4)
    T21[:3, :3] = R
    T21[:3, 3] = s * t
    return Mc @ np.linalg.inv(T21) @ np.linalg.inv(Mc)


def _scale_scores(scales, Xc, pdesc, Tcw_R, tcw_metric, tcw_scaled, Mc_l_R, Mc_l_t, intr, cams,
                  feat_uv, feat_desc, feat_valid, skip_cam: int, radius: float = 5.0,
                  th_desc: float = 64.0) -> torch.Tensor:
    """Inlier count per scale hypothesis, scales [S] -> [S] int64.

    A point at scale s is an inlier in frame f, camera c (not the leading
    one, whose observations do not move with s) when it projects within
    `radius` px of a valid feature whose descriptor is within `th_desc`.
    The descriptor gate [F, C, M, K] is scale-invariant and computed once,
    exactly, from the Hamming matrix. The window test [s, F, C, M, K] is
    dense, in chunks of SCALE_CHUNK scales: counts are integers, so chunking
    changes no result and bounds the memory (~0.3 GB a chunk at M = 1000,
    K = 800, C = 3, F = 2)."""
    C = intr.shape[0]
    ham_ok = (hamming_matrix(pdesc, feat_desc) <= th_desc) & feat_valid[:, :, None, :]   # [F, C, M, K]
    cam_ids = torch.arange(C, device=Xc.device)
    not_leading = (cam_ids != skip_cam)[None, None, :, None]
    out = []
    for s in torch.split(scales, SCALE_CHUNK):
        sb = s[:, None, None]
        Xw = (sb * Xc[None]) @ Mc_l_R.T + Mc_l_t                              # [s, M, 3]
        Xcam = (torch.einsum("fcij,smj->sfcmi", Tcw_R, Xw)
                + tcw_metric[None, :, :, None, :]
                + s[:, None, None, None, None] * tcw_scaled[None, :, :, None, :])   # [s, F, C, M, 3]
        uv_p = intr_project(intr[None, None, :, None, :], Xcam)                # [s, F, C, M, 2]
        vis = (Xcam[..., 2] > 0) & in_mirror_mask(cams, cam_ids[None, None, :, None], uv_p)
        du = torch.abs(uv_p[..., None, 0] - feat_uv[None, :, :, None, :, 0])
        dv = torch.abs(uv_p[..., None, 1] - feat_uv[None, :, :, None, :, 1])
        hit = (du <= radius) & (dv <= radius) & ham_ok[None] & vis[..., None]
        out.append((hit.any(dim=-1) & not_leading).sum(dim=(1, 2, 3)))
    return torch.cat(out)


def calibrate_metric_scale(
    rig: MultiCamRig,
    feats1: FrameFeatures,
    feats2: FrameFeatures,
    res: InitResult,
    R: Optional[np.ndarray] = None,
    t: Optional[np.ndarray] = None,
    radius: float = 5.0,
    th_desc: float = 64.0,
    min_inliers: int = 12,
) -> Tuple[float, int]:
    """Recover the metric scale of the two-view bootstrap from the rig's
    baseline. Same-camera observations are scale-invariant, but the fixed
    metric extrinsics make cross-camera re-observations sweep with scale:
    score 96 scales geometric in [0.05, 20], then 64 around the best, and
    return the consensus-maximizing one.

    Returns (scale, inliers_at_best). The scale multiplies res.points_cam
    and the leading camera's translation; 1.0 when cross-camera support is
    too weak."""
    l = res.leading_cam
    Mc_all = rig.Mc.cpu().numpy().astype(np.float64)   # [C, 4, 4]
    C = Mc_all.shape[0]
    if C < 2 or len(res.points_cam) < 8:
        return 1.0, 0
    Mc_l = Mc_all[l]
    if R is None or t is None:
        # the leading camera's relative pose, recovered from Mt2
        T21 = np.linalg.inv(np.linalg.inv(Mc_l) @ np.asarray(res.Mt2) @ Mc_l)
        R, t = T21[:3, :3], T21[:3, 3]
    dev = feats1.desc.device
    # world -> cam: frame 1 (body = I) is inv(Mc_c), fully metric; frame 2 is
    # inv(Mc_c) Mc_l [R | s t] inv(Mc_l), whose translation is affine in s
    Tcw_R = np.zeros((2, C, 3, 3))
    tcw_m = np.zeros((2, C, 3))
    tcw_s = np.zeros((2, C, 3))
    Ainv_l = np.linalg.inv(Mc_l)
    for c in range(C):
        T1 = np.linalg.inv(Mc_all[c])
        Tcw_R[0, c] = T1[:3, :3]
        tcw_m[0, c] = T1[:3, 3]
        A = T1 @ Mc_l
        AR = A[:3, :3] @ R
        Tcw_R[1, c] = AR @ Ainv_l[:3, :3]
        tcw_m[1, c] = AR @ Ainv_l[:3, 3] + A[:3, 3]
        tcw_s[1, c] = A[:3, :3] @ t
    B = feats1.desc.shape[-1]
    f32 = dict(dtype=torch.float32, device=dev)
    args = dict(
        Xc=torch.tensor(res.points_cam, **f32),
        pdesc=feats1.desc.reshape(-1, B)[torch.as_tensor(res.feat1, device=dev).long()],
        Tcw_R=torch.tensor(Tcw_R, **f32),
        tcw_metric=torch.tensor(tcw_m, **f32),
        tcw_scaled=torch.tensor(tcw_s, **f32),
        Mc_l_R=torch.tensor(Mc_l[:3, :3], **f32),
        Mc_l_t=torch.tensor(Mc_l[:3, 3], **f32),
        intr=rig.cams.to_vector(),
        cams=rig.cams,
        feat_uv=torch.stack([feats1.uv, feats2.uv]),
        feat_desc=torch.stack([feats1.desc, feats2.desc]),
        feat_valid=torch.stack([feats1.valid, feats2.valid]),
        skip_cam=l,
        radius=radius,
        th_desc=th_desc,
    )
    coarse = np.geomspace(0.05, 20.0, 96).astype(np.float32)
    sc = _scale_scores(torch.tensor(coarse, device=dev), **args).cpu().numpy()
    s0 = float(coarse[int(np.argmax(sc))])
    step = float(coarse[1] / coarse[0])
    fine = np.geomspace(s0 / step, s0 * step, 64).astype(np.float32)
    sf = _scale_scores(torch.tensor(fine, device=dev), **args).cpu().numpy()
    i1 = int(np.argmax(sf))
    best_n = int(sf[i1])
    if best_n < min_inliers:
        return 1.0, best_n
    return float(fine[i1]), best_n
