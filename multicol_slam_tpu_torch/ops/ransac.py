"""Batched essential-matrix RANSAC on unit rays, the map bootstrap's relative
pose solver (port of the central relative-pose part of
`multicol_slam_tpu/ops/ransac.py`; the non-central pose and Sim3 solvers
wait).

A fixed batch of S hypotheses: every 8-point problem is one batched SVD, and
all 4 S chirality candidates are scored against all N correspondences in one
dense pass (triangulate, reproject, angular error 1 - cos). The winner is
refit on its whole consensus set.

Randomness: the reference draws with `jax.random`, which torch cannot
reproduce. `ransac_essential` therefore takes the hypotheses' indices
`idx [S, 8]` explicitly, or a `torch.Generator` to draw them from.

SVD: the sign of a singular vector, the order of the four (R, t) candidates
and the degenerate hypotheses (a sample with a repeated index) may differ
from LAPACK's; E and the set of candidates do not. Compare the winner.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from multicol_slam_tpu_torch.utils.geometry import triangulate_midpoint


def sample_indices(n_hyp: int, sample_size: int, n_data: int,
                   generator: Optional[torch.Generator] = None, device=DEFAULT_DEVICE) -> torch.Tensor:
    """[S, m] random correspondence indices, drawn with replacement (a row
    with a repeated index only wastes its hypothesis), on the generator's
    device, else on `device`."""
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
