"""Batched RANSAC (port of `multicol_slam_tpu/ops/ransac.py`): the
essential-matrix relative pose of the map bootstrap, the non-central
absolute pose of relocalization, and Horn's closed-form Sim3 of loop
closing.

A fixed batch of S hypotheses: every minimal problem is one batched solve
(8-point SVD, or the non-central DLT on rays with a Procrustes projection),
and all hypotheses are scored against all N correspondences in one dense
pass. The winner is refit on its whole consensus set.

Randomness: the reference draws with `jax.random`, which torch cannot
reproduce. Each solver therefore takes the hypotheses' indices `idx`
explicitly, or a `torch.Generator` to draw them from.

SVD: the sign of a singular vector, the order of the four (R, t) candidates
and the degenerate hypotheses (a sample with a repeated index) may differ
from LAPACK's; E and the set of candidates do not. Compare the winner. The
same holds for Horn's eigenvector: q and -q give one R, and only a
near-degenerate sample (three almost collinear points) may pick another.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from multicol_slam_tpu_torch.utils.geometry import quat_to_rot, skew, triangulate_midpoint


def sample_indices(n_hyp: int, sample_size: int, n_data: int,
                   generator: Optional[torch.Generator] = None, device=DEFAULT_DEVICE,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[S, m] random correspondence indices. Without `weights`, drawn with
    replacement (a row with a repeated index only wastes its hypothesis),
    on the generator's device, else on `device`; with `weights` [n_data]
    (non-negative, at least m of them > 0), each row draws m distinct
    indices with p = weights / sum(weights), as the reference's choice
    without replacement, on the generator's device and returned on the
    weights' (the system's generator is a CPU one for data on the card)."""
    if weights is not None:
        w = weights.to(generator.device if generator is not None else weights.device, torch.float32)
        return torch.multinomial(w.expand(n_hyp, -1), sample_size, replacement=False,
                                 generator=generator).to(weights.device)
    device = generator.device if generator is not None else resolve_device(device)
    return torch.randint(0, max(int(n_data), 1), (n_hyp, sample_size), generator=generator,
                         device=device)


def _eight_point(r1: torch.Tensor, r2: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched 8-point algorithm on unit rays. r1, r2 [S, m>=8, 3] -> E
    [S, 3, 3] with r2^T E r1 = 0, projected to the essential manifold.
    Optional row weights w [S, m] (the inlier refit)."""
    # each correspondence: kron(r1, r2) . vec(E) = 0 (row-major E)
    A = torch.einsum("smi,smj->smij", r1, r2).reshape(r1.shape[0], r1.shape[1], 9)
    if w is not None:
        A = A * w[..., None]
    # the 9th right singular vector of an [S, 8, 9] matrix needs full_matrices
    Vh = torch.linalg.svd(A, full_matrices=True).Vh
    E = Vh[:, -1, :].reshape(-1, 3, 3).transpose(1, 2)   # vec was (i=r1, j=r2): E[j, i]
    # project to the essential manifold: singular values (1, 1, 0)
    U, _, Vt = torch.linalg.svd(E)
    D = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return torch.einsum("sij,j,sjk->sik", U, D, Vt)


def decompose_essential(E: torch.Tensor):
    """E [S, 3, 3] -> the 4 candidates (R1, t), (R1, -t), (R2, t), (R2, -t)
    with X2 = R X1 + t. Returns R [S, 4, 3, 3], t [S, 4, 3]."""
    U, _, Vt = torch.linalg.svd(E)
    # proper rotations in the factors: det(U) = det(V) = +1
    detU = torch.linalg.det(U)
    detV = torch.linalg.det(Vt)
    ones = torch.ones_like(detU)
    U = U * torch.stack([ones, ones, detU], -1)[:, None, :]
    Vt = Vt * torch.stack([ones, ones, detV], -1)[:, :, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    Ra = torch.einsum("sij,jk,skl->sil", U, W, Vt)
    Rb = torch.einsum("sij,kj,skl->sil", U, W, Vt)   # W^T
    t = U[:, :, 2]
    return torch.stack([Ra, Ra, Rb, Rb], dim=1), torch.stack([t, -t, t, -t], dim=1)


class RelPoseResult(NamedTuple):
    R: torch.Tensor          # [3, 3]  X2 = R X1 + t
    t: torch.Tensor          # [3]     unit norm
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # scalar
    score: torch.Tensor      # scalar f32


def _triangulation_error(R, t, rays1, rays2):
    """OpenGV-style model scoring: triangulate each correspondence under
    (R, t) [X2 = R X1 + t, unit t], and return the angular errors (1 - cos)
    to both observed rays summed, and the two ray depths. Batched over model
    stacks R [..., 3, 3], t [..., 3]; rays [N, 3]. Returns (err, lam1, lam2),
    each [..., N]."""
    batch = R.shape[:-2]
    o1 = torch.zeros(batch + (1, 3), dtype=rays1.dtype, device=rays1.device)
    d1 = rays1.expand(batch + rays1.shape)
    o2 = (-torch.einsum("...ji,...j->...i", R, t))[..., None, :]
    d2 = torch.einsum("...ji,nj->...ni", R, rays2)   # rays2 rotated into frame 1
    X, lam1, lam2 = triangulate_midpoint(o1, d1, o2, d2)
    p1n = X / (torch.linalg.vector_norm(X, dim=-1, keepdim=True) + 1e-18)
    p2 = X - o2
    p2n = p2 / (torch.linalg.vector_norm(p2, dim=-1, keepdim=True) + 1e-18)
    e1 = 1.0 - torch.sum(p1n * d1, dim=-1)
    e2 = 1.0 - torch.sum(p2n * d2, dim=-1)
    return e1 + e2, lam1, lam2


def ransac_essential(
    rays1: torch.Tensor,
    rays2: torch.Tensor,
    valid: torch.Tensor,
    n_hyp: int = 256,
    err_th: float = 1e-4,
    generator: Optional[torch.Generator] = None,
    idx: Optional[torch.Tensor] = None,
) -> RelPoseResult:
    """Two-view relative pose from ray correspondences (the init bootstrap's
    solver; OpenGV's scoring: triangulate + angular reprojection error 1 - cos
    below 1e-4, cMultiInitializer.cpp:143). rays* [N, 3] unit; valid [N]
    bool. The hypotheses are `idx [S, 8]` when given, else drawn from
    `generator` (n_hyp of them). Everything stays on the rays' device."""
    N = rays1.shape[0]
    if idx is None:
        idx = sample_indices(n_hyp, 8, N, generator, rays1.device)
    idx = idx.to(rays1.device).long()
    E = _eight_point(rays1[idx], rays2[idx])                      # [S, 3, 3]
    R4, t4 = decompose_essential(E)
    Rf = R4.reshape(-1, 3, 3)
    tf = t4.reshape(-1, 3)
    err, lam1, lam2 = _triangulation_error(Rf, tf, rays1, rays2)  # [4S, N]
    inl = (err < err_th) & (lam1 > 0) & (lam2 > 0) & valid[None, :]
    counts = inl.sum(dim=1)
    best = torch.argmax(counts)
    # refit on all inliers of the winner, then rescore its 4 candidates
    w = inl[best].to(rays1.dtype)
    R4r, t4r = decompose_essential(_eight_point(rays1[None], rays2[None], w[None]))
    Rr, tr = R4r[0], t4r[0]
    err_r, lam1_r, lam2_r = _triangulation_error(Rr, tr, rays1, rays2)  # [4, N]
    inl_r = (err_r < err_th) & (lam1_r > 0) & (lam2_r > 0) & valid[None, :]
    counts_r = inl_r.sum(dim=1)
    kbest = torch.argmax(counts_r)
    use_refit = counts_r[kbest] >= counts[best]
    R_out = torch.where(use_refit, Rr[kbest], Rf[best])
    t_out = torch.where(use_refit, tr[kbest], tf[best])
    inl_out = torch.where(use_refit, inl_r[kbest], inl[best])
    n_out = torch.where(use_refit, counts_r[kbest], counts[best])
    return RelPoseResult(R_out, t_out, inl_out, n_out, n_out.to(torch.float32))


# ---------------------------------------------------------------------------
# Non-central absolute pose (relocalization): DLT on rays + Procrustes
# ---------------------------------------------------------------------------

def _noncentral_dlt(X: torch.Tensor, rays: torch.Tensor, Rc: torch.Tensor, tc: torch.Tensor,
                    w: Optional[torch.Tensor] = None):
    """Linear non-central absolute pose from m >= 6 point <-> ray matches:
    the world -> body [R | t] from cross(Rc r, R X + t - tc) = 0, linear in
    (R, t), least squares by the 12x12 normal equations, then R projected
    onto SO(3). X [S, m, 3], rays [S, m, 3] (camera frame), Rc [S, m, 3, 3],
    tc [S, m, 3] each match's camera -> body extrinsics, w [S, m] optional
    weights. Returns R [S, 3, 3], t [S, 3]."""
    S, m, _ = X.shape
    rb = torch.einsum("smij,smj->smi", Rc, rays)                 # rays in the body frame
    Cx = skew(rb)                                                 # [S, m, 3, 3]
    # unknown z = [rows of R; t]: Cx (R X + t) = Cx tc
    A_R = torch.einsum("smab,smc->smabc", Cx, X).reshape(S, m, 3, 9)
    A = torch.cat([A_R, Cx], dim=-1).reshape(S, 3 * m, 12)
    b = torch.einsum("smab,smb->sma", Cx, tc).reshape(S, 3 * m)
    if w is not None:
        ww = torch.repeat_interleave(torch.sqrt(torch.clamp_min(w, 0.0)), 3, dim=-1)
        A = A * ww[..., None]
        b = b * ww
    eye = torch.eye(12, dtype=X.dtype, device=X.device)
    AtA = torch.einsum("ska,skb->sab", A, A) + 1e-9 * eye
    Atb = torch.einsum("ska,sk->sa", A, b)
    z = torch.linalg.solve(AtA, Atb[..., None])[..., 0]
    R_raw = z[:, :9].reshape(S, 3, 3)
    t_raw = z[:, 9:]
    U, sv, Vt = torch.linalg.svd(R_raw)
    detUV = torch.linalg.det(torch.matmul(U, Vt))
    D = torch.stack([torch.ones_like(detUV), torch.ones_like(detUV), detUV], -1)
    R = torch.einsum("sij,sj,sjk->sik", U, D, Vt)
    scale = torch.sum(sv * D, dim=-1) / 3.0
    return R, t_raw / torch.clamp_min(scale, 1e-9)[:, None]


def _body_to_world(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """inv([R | t]) as a 4x4 (body -> world)."""
    M = torch.eye(4, dtype=R.dtype, device=R.device)
    M[:3, :3] = R.T
    M[:3, 3] = -(R.T @ t)
    return M


class AbsPoseResult(NamedTuple):
    Mt: torch.Tensor         # [4, 4] body -> world
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # scalar


def sample_weighted(n_hyp: int, sample_size: int, valid: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[S, m] indices of distinct valid rows per hypothesis (the
    reference's choice without replacement, p = valid / sum(valid))."""
    return sample_indices(n_hyp, sample_size, len(valid), generator, weights=valid)


def ransac_noncentral_pose(
    X: torch.Tensor,
    rays: torch.Tensor,
    Rc: torch.Tensor,
    tc: torch.Tensor,
    valid: torch.Tensor,
    n_hyp: int = 160,
    sample_size: int = 6,
    ray_th: float = 1e-2,
    generator: Optional[torch.Generator] = None,
    idx: Optional[torch.Tensor] = None,
) -> AbsPoseResult:
    """Relocalization pose RANSAC (in place of OpenGV's GP3P + gpnp,
    cTracking.cpp:1274-1275). X [N, 3] world points; rays [N, 3] unit rays
    in the observing camera's frame; Rc / tc [N, 3, 3] / [N, 3] that
    camera's extrinsics; valid [N]. A correspondence is an inlier when the
    sine between its ray and the predicted direction is below ray_th, in
    front. The hypotheses are `idx [S, m]` when given, else drawn from
    `generator` among the valid rows."""
    if idx is None:
        idx = sample_weighted(n_hyp, sample_size, valid, generator)
    idx = idx.to(X.device).long()
    R, t = _noncentral_dlt(X[idx], rays[idx], Rc[idx], tc[idx])       # world -> body
    rb = torch.einsum("nij,nj->ni", Rc, rays)                        # [N, 3] body-frame rays
    pred = torch.einsum("sij,nj->sni", R, X) + t[:, None, :] - tc[None]
    pred = pred / (torch.linalg.vector_norm(pred, dim=-1, keepdim=True) + 1e-12)
    sine = torch.linalg.vector_norm(torch.cross(pred, rb[None].expand_as(pred), dim=-1), dim=-1)
    dotp = torch.sum(pred * rb[None], dim=-1)
    inl = (sine < ray_th) & (dotp > 0) & valid[None]
    counts = inl.sum(dim=1)
    best = torch.argmax(counts)
    return AbsPoseResult(_body_to_world(R[best], t[best]), inl[best], counts[best])


def refine_noncentral_pose(X: torch.Tensor, rays: torch.Tensor, Rc: torch.Tensor, tc: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """gpnp-style refinement: the weighted non-central DLT over all inliers
    (weights w [N] in [0, 1]). Returns Mt [4, 4] body -> world."""
    R, t = _noncentral_dlt(X[None], rays[None], Rc[None], tc[None], w[None])
    return _body_to_world(R[0], t[0])


# ---------------------------------------------------------------------------
# Horn's closed-form Sim3 (loop closing)
# ---------------------------------------------------------------------------

def horn_sim3(P: torch.Tensor, Q: torch.Tensor, with_scale: bool = True):
    """Closed-form similarity Q ~ s R P + t (Horn's quaternion method, the
    reference's cSim3Solver::computeT, cSim3Solver.cpp:286-371), batched over
    leading dims: P, Q [..., m, 3]. Returns (R [..., 3, 3], t [..., 3], s [...])."""
    cP = P.mean(dim=-2, keepdim=True)
    cQ = Q.mean(dim=-2, keepdim=True)
    Pc, Qc = P - cP, Q - cQ
    M = torch.einsum("...mi,...mj->...ij", Pc, Qc)      # S_ab = sum_m P_a Q_b
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    # Horn's symmetric 4x4 N: its top eigenvector is the optimal quaternion
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    q = torch.linalg.eigh(N).eigenvectors[..., :, -1]   # [w, x, y, z]
    R = quat_to_rot(torch.stack([q[..., 1], q[..., 2], q[..., 3], q[..., 0]], -1))
    if with_scale:
        # symmetric scale (Horn section 2E): s = sqrt(sum |Qc|^2 / sum |Pc|^2)
        s = torch.sqrt(torch.sum(Qc * Qc, dim=(-2, -1)) / (torch.sum(Pc * Pc, dim=(-2, -1)) + 1e-12))
    else:
        s = torch.ones(P.shape[:-2], dtype=P.dtype, device=P.device)
    t = cQ[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R, cP[..., 0, :])
    return R, t, s


class Sim3Result(NamedTuple):
    R: torch.Tensor          # [3, 3]
    t: torch.Tensor          # [3]
    s: torch.Tensor          # scalar
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # scalar


def ransac_sim3(
    P: torch.Tensor,
    Q: torch.Tensor,
    valid: torch.Tensor,
    err_fn,
    n_hyp: int = 300,
    with_scale: bool = True,
    generator: Optional[torch.Generator] = None,
    idx: Optional[torch.Tensor] = None,
) -> Sim3Result:
    """Sim3 RANSAC on 3-point samples (cSim3Solver: 3-point minimal sets, at
    most 300 iterations), all hypotheses at once. err_fn(R [S, 3, 3],
    t [S, 3], s [S]) -> inlier mask [S, N]: the caller scores by reprojection
    through each observation's camera (cSim3Solver.cpp:374-416). The
    hypotheses are `idx [S, 3]` when given, else drawn from `generator`."""
    if idx is None:
        idx = sample_indices(n_hyp, 3, P.shape[0], generator, P.device)
    idx = idx.to(P.device).long()
    R, t, s = horn_sim3(P[idx], Q[idx], with_scale)
    inl = err_fn(R, t, s) & valid[None]
    counts = inl.sum(dim=1)
    best = torch.argmax(counts)
    return Sim3Result(R[best], t[best], s[best], inl[best], counts[best])
