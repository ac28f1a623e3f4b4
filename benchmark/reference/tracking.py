"""Plain two-stage tracking of one frame against a local map, written from
the description of MultiCol-SLAM's tracking step (the motion-model stage,
then the local-map stage from its pose):

each stage projects the local map's points into every camera at the stage's
start pose, keeps those in front, inside the mirror, inside the scale band
[0.8 min, 1.2 max] and seen within 60 degrees of their mean viewing
direction, predicts each point's pyramid level from its distance, and gives
every valid feature the map point of least Hamming distance among those
within radius x 1.2^level pixels (both axes) and one level of the feature's
octave (ties to the lower index); a match needs a distance <= th_desc, and a
point claimed by several features of one camera goes to the closest. Then
two rounds of robust pose-only Levenberg-Marquardt (Huber 2.69 on the
sigma-normalized residual, 10 iterations each, lambda from 1e-3 halved on
success and x10 on failure), with the rows of chi2 >= 2.69^2 dropped
between the rounds. Stage 2 starts from stage 1's pose when stage 1 kept at
least `min_pose_inliers` rows, else from the prediction.

Plain torch, float32; the Jacobian of each residual is taken with forward
automatic differentiation. The predicted pose is the last pose composed
with the motion model's velocity, in float64 numpy.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from benchmark.reference.geometry import hom, hom_inv, in_mirror, np_cayley, np_hom, project

BIG = 1e9
POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)


def predict(last_pose: np.ndarray, velocity: np.ndarray) -> np.ndarray:
    """The motion model: last pose composed with the velocity, float32."""
    return np_cayley(np_hom(last_pose) @ np.asarray(velocity, np.float64))


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[Q, B] x [T, B] uint8 -> [Q, T] int32 bit differences."""
    lut = POPCOUNT.to(a.device)
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    for j in range(a.shape[1]):
        out += lut[(a[:, j, None] ^ b[None, :, j]).long()]
    return out


def match(rig, feats: dict, pose: torch.Tensor, pts: dict, scale: float, levels: int, radius: float,
          th_desc: float):
    """assign [C*K] (local point index or -1) of one stage."""
    C, K = feats["valid"].shape
    X = pts["X"]
    M = hom(pose) @ rig.Mc                                    # [C, 4, 4] camera -> world
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
        d = torch.where(allowed, hamming(feats["desc"][c], pts["desc"]).to(torch.float32),
                        torch.full(allowed.shape, BIG, device=X.device, dtype=torch.float32))
        best, idx = d.min(dim=1)                          # first minimum
        ok = (best < BIG) & (best <= th_desc)
        claim = torch.full((X.shape[0],), BIG, device=X.device, dtype=torch.float32)
        claim = claim.scatter_reduce(0, idx[ok], best[ok], reduce="amin")
        keep = ok & (best <= claim[idx])
        assign[c] = torch.where(keep, idx, torch.full_like(idx, -1))
    return assign.reshape(C * K)


def row_projection(pose6, X, Mc, invpol, cde, pp):
    """(pixel [2], depth) of one world point X seen by the camera of
    extrinsics Mc [4, 4] at body pose pose6."""
    # batch axes of one keep every intermediate a tensor of rank >= 1, so
    # that Python scalars do not promote it under forward differentiation
    Minv = hom_inv(hom(pose6[None]) @ Mc[None])
    Xc = (Minv[:, :3, :3] @ X[None, :, None])[..., 0] + Minv[:, :3, 3]
    return project(invpol[None], cde[None], pp[None], Xc)[0], Xc[0, 2]


def pose_solve(rig, pose: torch.Tensor, X: torch.Tensor, cam: torch.Tensor, uv: torch.Tensor,
               inv_s2: torch.Tensor, valid: torch.Tensor, iters: int = 10, delta: float = 1.345 * 2.0,
               lam: float = 1e-3):
    """Robust pose-only LM of one body pose; (pose, chi2 [O], inf on rows
    invalid or behind the camera)."""
    rows = (X, rig.Mc[cam], rig.invpol[cam], rig.cde[cam], rig.pp[cam])
    proj = vmap(row_projection, in_dims=(None, 0, 0, 0, 0, 0))

    def resid(p):
        pred, z = proj(p, *rows)
        return uv - pred, z

    def cost(p):
        r, z = resid(p)
        e2 = (r * r).sum(-1) * inv_s2
        e = torch.sqrt(e2 + 1e-18)
        rho = torch.where(e <= delta, e2, 2.0 * delta * e - delta * delta)
        return torch.where(valid & (z > 0), rho, torch.zeros_like(rho)).sum()

    jac = vmap(jacfwd(lambda *a: row_projection(*a)[0], argnums=0), in_dims=(None, 0, 0, 0, 0, 0))
    lam_t = torch.tensor(lam, device=pose.device, dtype=pose.dtype)
    c0 = cost(pose)
    done = False
    eye = torch.eye(6, device=pose.device, dtype=pose.dtype)
    for _ in range(iters):
        if done:
            break
        r, z = resid(pose)
        J = -jac(pose, *rows)                                 # d r / d pose  [O, 2, 6]
        e2 = (r * r).sum(-1) * inv_s2
        e = torch.sqrt(e2 + 1e-18)
        w = torch.where(valid & (z > 0), inv_s2 * torch.clamp_max(delta / e, 1.0), torch.zeros_like(e2))
        g = torch.einsum("oij,oi->j", J, -(w[:, None] * r))
        H = torch.einsum("oia,o,oib->ab", J, w, J)
        Hd = H + lam_t * torch.clamp_min(torch.diagonal(H), 1e-8) * eye + 1e-8 * eye
        step = torch.linalg.solve(Hd.float(), g.float()).to(pose.dtype)   # the 6x6 solve in float32 at least
        step = torch.where(torch.isfinite(step), step, torch.zeros_like(step))
        cand = pose + step
        c1 = cost(cand)
        if bool(torch.isfinite(c1) & (c1 <= c0)):
            pose, c0 = cand, c1
            lam_t = torch.clamp(lam_t * 0.5, 1e-6, 1e4)
            done = bool(torch.max(torch.abs(step)) < 1e-6)
        else:
            lam_t = torch.clamp(lam_t * 10.0, 1e-6, 1e4)
    r, z = resid(pose)
    e2 = (r * r).sum(-1) * inv_s2
    return pose, torch.where(valid & (z > 0), e2, torch.full_like(e2, math.inf))


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
    `dtype`: the precision of the geometry and the pose solve (the
    descriptors' distances are exact integers whatever it is)."""
    scale, levels = float(spec["scale_factor"]), int(spec["n_levels"])
    rig = rig.to(dtype)
    feats = {k: v.to(dtype) if v.is_floating_point() else v for k, v in feats.items()}
    pts = {k: v.to(dtype) if v is not None and v.is_floating_point() else v for k, v in pts.items()}
    pose_pred = pose_pred.to(dtype)
    th = 3.0 * int(spec["desc_size"])
    p1, _, _, n1 = stage(rig, feats, pose_pred, pts, scale, levels, radius1, th)
    start = p1 if n1 >= min_pose_inliers else pose_pred
    p2, assign, inl, n2 = stage(rig, feats, start, pts, scale, levels, radius2, th)
    return dict(pose1=p1, n1=n1, pose=p2, assign=assign, inlier=inl, n_inliers=n2)
