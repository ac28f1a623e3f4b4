"""Plain two-stage tracking of one frame with mdBRIEF's masked distance:
benchmark/reference/tracking.py's stages, with each feature matched to the
map point of least masked Hamming distance

    d(q, t) = (popcount((q ^ t) & m_q) + popcount((q ^ t) & m_t)) / 2,

m_q and m_t the two descriptors' stability masks (mdBRIEF, Urban & Hinz
2016), and a match needing d <= th_desc = 0.5 x 3 x B, half the unmasked
TH_HIGH (the system's threshold for masked matching). Everything else, the
projection, the windows, the level band, the claims and the robust pose
solve, is tracking.py's; its `predict` and `pose_solve` are used by import.

Plain torch, float32 unless the caller asks for another precision; the
distances are exact halves of integers in any precision.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.geometry import hom, hom_inv, in_mirror, project
from benchmark.reference.tracking import BIG, POPCOUNT, pose_solve, predict  # noqa: F401  (predict: re-exported)


def hamming_masked(a: torch.Tensor, ma: torch.Tensor, b: torch.Tensor, mb: torch.Tensor) -> torch.Tensor:
    """[Q, B] descriptors and masks x [T, B] ones -> [Q, T] float32 masked
    distances."""
    lut = POPCOUNT.to(a.device)
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    for j in range(a.shape[1]):
        x = a[:, j, None] ^ b[None, :, j]
        out += lut[(x & ma[:, j, None]).long()] + lut[(x & mb[None, :, j]).long()]
    return out.to(torch.float32) * 0.5


def match(rig, feats: dict, pose: torch.Tensor, pts: dict, scale: float, levels: int, radius: float,
          th_desc: float):
    """assign [C*K] (local point index or -1) of one stage."""
    C, K = feats["valid"].shape
    X = pts["X"]
    M = hom(pose) @ rig.Mc
    Minv = hom_inv(M)
    Xc = torch.einsum("cij,lj->cli", Minv[:, :3, :3], X) + Minv[:, None, :3, 3]
    uv = project(rig.invpol[:, None], rig.cde[:, None], rig.pp[:, None], Xc)
    inside = in_mirror(rig.pp[:, None], rig.wh[:, None], uv)
    view = X[None] - M[:, None, :3, 3]
    dist = torch.linalg.vector_norm(view, dim=-1)
    band = (dist >= pts["min_dist"][None] * 0.8) & (dist <= pts["max_dist"][None] * 1.2)
    ratio = torch.clamp_min(dist / torch.clamp_min(pts["min_dist"][None], 1e-6), 1.0)
    level = torch.clamp(torch.round(torch.log(ratio) / math.log(scale)).to(torch.int32), 0, levels - 1)
    cand = pts["valid"][None] & (Xc[..., 2] > 0) & inside & band
    if pts.get("normal") is not None:
        n = pts["normal"]
        cos = (view * n[None]).sum(-1) / torch.clamp_min(dist, 1e-9)
        cand &= ~(torch.linalg.vector_norm(n, dim=-1) > 1e-6)[None] | (cos > 0.5)
    rad = radius * torch.pow(scale, level.to(X.dtype))
    assign = torch.full((C, K), -1, dtype=torch.int64, device=X.device)
    for c in range(C):
        q_ok = feats["valid"][c]
        du = torch.abs(feats["uv"][c, :, None, 0] - uv[c, None, :, 0])
        dv = torch.abs(feats["uv"][c, :, None, 1] - uv[c, None, :, 1])
        dl = torch.abs(feats["octave"][c, :, None].to(X.dtype) - level[c, None, :].to(X.dtype))
        allowed = q_ok[:, None] & cand[c][None] & (du <= rad[c][None]) & (dv <= rad[c][None]) & (dl <= 1.0)
        ham = hamming_masked(feats["desc"][c], feats["dmask"][c], pts["desc"], pts["dmask"])
        d = torch.where(allowed, ham, torch.full(allowed.shape, BIG, device=X.device, dtype=torch.float32))
        best, idx = d.min(dim=1)                          # first minimum
        ok = (best < BIG) & (best <= th_desc)
        claim = torch.full((X.shape[0],), BIG, device=X.device, dtype=torch.float32)
        claim = claim.scatter_reduce(0, idx[ok], best[ok], reduce="amin")
        keep = ok & (best <= claim[idx])
        assign[c] = torch.where(keep, idx, torch.full_like(idx, -1))
    return assign.reshape(C * K)


def stage(rig, feats: dict, pose: torch.Tensor, pts: dict, scale: float, levels: int, radius: float,
          th_desc: float):
    """(pose, assign [C*K], inlier [C*K], n_inliers) of one stage."""
    C, K = feats["valid"].shape
    assign = match(rig, feats, pose, pts, scale, levels, radius, th_desc)
    keep = assign >= 0
    X = pts["X"][torch.clamp_min(assign, 0)]
    cam = torch.arange(C, device=X.device).repeat_interleave(K)
    uv = feats["uv"].reshape(C * K, 2)
    inv_s2 = (1.0 / torch.pow(scale, 2.0 * feats["octave"].to(X.dtype))).reshape(C * K)
    chi_th = (1.345 * 2.0) ** 2
    p1, chi2 = pose_solve(rig, pose, X, cam, uv, inv_s2, keep)
    inl = keep & (chi2 < chi_th)
    p2, chi2 = pose_solve(rig, p1, X, cam, uv, inv_s2, inl)
    inl = keep & (chi2 < chi_th)
    return p2, assign, inl, int(inl.sum())


def track(rig, feats: dict, pose_pred: torch.Tensor, pts: dict, spec: dict, radius1: float = 15.0,
          radius2: float = 4.0, min_pose_inliers: int = 6, dtype=torch.float32):
    """The two stages: dict(pose1, n1, pose, assign, inlier, n_inliers).
    `feats` and `pts` carry `dmask` beside `desc`. `dtype`: the precision
    of the geometry and the pose solve."""
    scale, levels = float(spec["scale_factor"]), int(spec["n_levels"])
    rig = rig.to(dtype)
    feats = {k: v.to(dtype) if v.is_floating_point() else v for k, v in feats.items()}
    pts = {k: v.to(dtype) if v is not None and v.is_floating_point() else v for k, v in pts.items()}
    pose_pred = pose_pred.to(dtype)
    th = 0.5 * 3.0 * int(spec["desc_size"])
    p1, _, _, n1 = stage(rig, feats, pose_pred, pts, scale, levels, radius1, th)
    start = p1 if n1 >= min_pose_inliers else pose_pred
    p2, assign, inl, n2 = stage(rig, feats, start, pts, scale, levels, radius2, th)
    return dict(pose1=p1, n1=n1, pose=p2, assign=assign, inlier=inl, n_inliers=n2)
