"""Damped Gauss-Newton / Levenberg-Marquardt for MultiCol BA (port of
`multicol_slam_tpu/optim/lm.py`).

- Normal equations are never formed: the Hessian-vector product
  H v = J^T W J v is a gather of each row's parameter blocks, small
  contractions, and segment sums back onto poses, points and cameras,
  solved by preconditioned CG (block-Jacobi: the U_k / V_p blocks).
- Huber weights by IRLS; Levenberg damping on the block diagonal; a step is
  kept when it lowers the robust cost, and the solve stops once a kept step
  gains less than 1e-6 of the cost (g2o's terminate action).
- Pose-only mode is block-diagonal: one batched 6x6 solve per iteration.

Layout: per-observation arrays are observation-major ([O, 2, d]). Segment
sums are deterministic: `Segments` sorts each index column once per problem
and `torch.segment_reduce` adds each segment in row order (a scatter-add on
CUDA adds in atomic order, and a SLAM run amplifies the last bits).

The reference's `lax.while_loop`s stop early. Here the host reads the
`done` flag once per chunk of iterations; an iteration run after `done` is
a no-op (`torch.where`), so a chunked solve returns what the loop returns.

Distributed BA (`parallel/`): the counterpart of the reference's
`axis_name` is a *reducer*, a callable that sums a tensor across ranks in
place (`parallel.distributed.all_reduce_sum` wraps
`torch.distributed.all_reduce`). `None` means one device. The reduction
sites are the reference's psums: the gradient with the block diagonals,
each Hessian-vector product before its damping term, the robust cost, and
with `LMConfig.points_sharded` the point term of each inner product. Each
site packs its pieces into one flat buffer and reduces it with one call
(the sums are elementwise, so the values are those of a psum per piece).
`done` derives from reduced values only, so every rank takes the same
branch.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multicol_slam_tpu_torch.optim.problem import (
    BAParams, FreeMask, Observations, huber_weights, pose_residuals_and_jac,
    residuals_and_jacobians, residuals_only, robust_cost,
)
from multicol_slam_tpu_torch.utils import tracing


class LMConfig(NamedTuple):
    max_iters: int = 15
    cg_iters: int = 20
    huber_delta: float = 2.4477  # sqrt(5.991), BA chi2 gate (cOptimizer.cpp:161)
    init_lambda: float = 1e-4
    gain_eps: float = 1e-6       # terminate-action gain threshold
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    # The distributed layout (meaningful with a reducer). False: observation
    # rows shard, everything else replicates, and every segment sum is
    # reduced. True: points and the rows that observe them co-shard (obs.pt
    # holds LOCAL indices), so the point blocks V, g_pt and h_pt stay on
    # their rank; the pose and rig blocks and the point term of each inner
    # product are reduced.
    points_sharded: bool = False
    # The reference's solve_mc / solve_intr have no field here: the rig's
    # Jacobian blocks follow `FreeMask.mc` / `FreeMask.intr` (the default
    # FreeMask(mc=False, intr=False) is solve_mc=False, solve_intr=False).


# sums a tensor across ranks in place; None: one device
Reducer = Optional[Callable[[torch.Tensor], None]]


def _reduce(reducer: Reducer, *parts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """`parts` summed across ranks with one call of `reducer`: packed into
    one flat buffer, reduced in place, split back. Without a reducer, the
    parts as they are."""
    if reducer is None:
        return parts
    flat = torch.cat([p.reshape(-1) for p in parts])
    reducer(flat)
    return tuple(c.view_as(p) for c, p in zip(torch.split(flat, [p.numel() for p in parts]), parts))


class Segments(NamedTuple):
    """Each index column of a problem sorted once: (order, lengths) for the
    keyframe, point and camera segments."""

    kf: Tuple[torch.Tensor, torch.Tensor]
    pt: Tuple[torch.Tensor, torch.Tensor]
    cam: Tuple[torch.Tensor, torch.Tensor]


def segments(ids: torch.Tensor, n: int):
    """(order, lengths) of an index column over n segments, for `_segsum`."""
    ids = ids.long()
    return torch.argsort(ids, stable=True), torch.bincount(ids, minlength=n)


def make_segments(params: BAParams, obs: Observations) -> Segments:
    return Segments(segments(obs.kf, params.poses.shape[0]), segments(obs.pt, params.points.shape[0]),
                    segments(obs.cam, params.mc.shape[0]))


def _segsum(rows: torch.Tensor, seg) -> torch.Tensor:
    """sum_o rows[o] -> out[ids[o]]: [O, D] -> [n_seg, D], each segment
    added in row order."""
    order, lengths = seg
    with tracing.span("lm.segsum"):
        return torch.segment_reduce(rows[order], "sum", lengths=lengths, axis=0, unsafe=True)


def _carries_mask(m) -> bool:
    """True when a FreeMask calibration entry frees something: a per-camera
    tensor, or a truthy scalar. The rig's Jacobian blocks are built only
    then (the standard BA modes keep mc / intr fixed)."""
    if m is False or m is None:
        return False
    if isinstance(m, (bool, np.bool_)) or (torch.is_tensor(m) and m.dim() == 0):
        return bool(m)
    return True


def _mask_params(d: BAParams, free: FreeMask) -> BAParams:
    """Zero the update on fixed groups. free.mc / free.intr: a bool for
    every camera or a per-camera [C] mask (a per-camera mask pins the gauge
    in self-calibrating BA)."""
    def cams(m, x):
        m = torch.as_tensor(m, dtype=x.dtype, device=x.device)
        return x * (m[:, None] if m.dim() == 1 else m)
    return BAParams(d.poses * free.poses[:, None].to(d.poses.dtype),
                    d.points * free.points[:, None].to(d.points.dtype),
                    cams(free.mc, d.mc), cams(free.intr, d.intr))


def _dot(a: BAParams, b: BAParams, reducer: Reducer = None, points_sharded: bool = False) -> torch.Tensor:
    """Inner product over the parameters. With points sharded the point term
    is a partial sum and is reduced; the replicated terms are not (they are
    equal on every rank)."""
    pt = torch.sum(a.points * b.points)
    if points_sharded:
        pt, = _reduce(reducer, pt)
    return torch.sum(a.poses * b.poses) + pt + torch.sum(a.mc * b.mc) + torch.sum(a.intr * b.intr)


def _axpy(alpha, x: BAParams, y: BAParams) -> BAParams:
    return BAParams(*(alpha * a + b for a, b in zip(x, y)))


def _outer(J: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_i J[o, i, a] w[o] J[o, i, b] flattened: [O, d * d]."""
    return torch.einsum("oia,o,oib->oab", J, w, J).reshape(J.shape[0], -1)


def _build_grad_and_blocks(params: BAParams, seg: Segments, Jp, Jx, Jm, Ji, w, r,
                           reducer: Reducer = None, points_sharded: bool = False):
    """RHS g = -J^T W r (r = measured - predicted) and the block diagonals
    U_k (poses), V_p (points), Um_c, Ui_c (rig), reduced across ranks in one
    buffer (without the point pieces when points are sharded)."""
    K, P = params.poses.shape[0], params.points.shape[0]
    C, Di = params.mc.shape[0], params.intr.shape[1]
    wr = -(w[:, None] * r)                                   # [O, 2]
    g_pose = _segsum(torch.einsum("oij,oi->oj", Jp, wr), seg.kf)
    g_pt = _segsum(torch.einsum("oij,oi->oj", Jx, wr), seg.pt)
    U = _segsum(_outer(Jp, w), seg.kf).reshape(K, 6, 6)
    V = _segsum(_outer(Jx, w), seg.pt).reshape(P, 3, 3)
    if Jm is not None:
        g_mc = _segsum(torch.einsum("oij,oi->oj", Jm, wr), seg.cam)
        Um = _segsum(_outer(Jm, w), seg.cam).reshape(C, 6, 6)
    else:
        g_mc = params.mc.new_zeros((C, 6))
        Um = params.mc.new_zeros((C, 6, 6))
    if Ji is not None:
        g_intr = _segsum(torch.einsum("oij,oi->oj", Ji, wr), seg.cam)
        Ui = _segsum(_outer(Ji, w), seg.cam).reshape(C, Di, Di)
    else:
        g_intr = params.intr.new_zeros((C, Di))
        Ui = params.intr.new_zeros((C, Di, Di))
    if points_sharded:
        g_pose, g_mc, g_intr, U, Um, Ui = _reduce(reducer, g_pose, g_mc, g_intr, U, Um, Ui)
    else:
        g_pose, g_pt, g_mc, g_intr, U, V, Um, Ui = _reduce(reducer, g_pose, g_pt, g_mc, g_intr, U, V, Um, Ui)
    return BAParams(g_pose, g_pt, g_mc, g_intr), (U, V, Um, Ui)


def _damped_diag(B: torch.Tensor) -> torch.Tensor:
    """The diagonal of each block, floored at 1e-8 (Marquardt scaling)."""
    return torch.clamp_min(torch.diagonal(B, dim1=-2, dim2=-1), 1e-8)


def _hvp(obs: Observations, seg: Segments, Jp, Jx, Jm, Ji, w, lam, blocks, free: FreeMask,
         v: BAParams, reducer: Reducer = None, points_sharded: bool = False) -> BAParams:
    """(J^T W J + lam * diag(blocks)) v. The partial sums over this rank's
    rows are reduced in one buffer before the damping term, whose blocks
    are reduced already."""
    v = _mask_params(v, free)
    jv = (torch.einsum("oij,oj->oi", Jp, v.poses[obs.kf])
          + torch.einsum("oij,oj->oi", Jx, v.points[obs.pt]))
    if Jm is not None:
        jv = jv + torch.einsum("oij,oj->oi", Jm, v.mc[obs.cam])
    if Ji is not None:
        jv = jv + torch.einsum("oij,oj->oi", Ji, v.intr[obs.cam])
    wjv = w[:, None] * jv                                    # [O, 2]
    h_pose = _segsum(torch.einsum("oij,oi->oj", Jp, wjv), seg.kf)
    h_pt = _segsum(torch.einsum("oij,oi->oj", Jx, wjv), seg.pt)
    h_mc = _segsum(torch.einsum("oij,oi->oj", Jm, wjv), seg.cam) if Jm is not None \
        else torch.zeros_like(v.mc)
    h_intr = _segsum(torch.einsum("oij,oi->oj", Ji, wjv), seg.cam) if Ji is not None \
        else torch.zeros_like(v.intr)
    if points_sharded:
        h_pose, h_mc, h_intr = _reduce(reducer, h_pose, h_mc, h_intr)
    else:
        h_pose, h_pt, h_mc, h_intr = _reduce(reducer, h_pose, h_pt, h_mc, h_intr)
    U, V, Um, Ui = blocks
    h = BAParams(h_pose + lam * (_damped_diag(U) * v.poses), h_pt + lam * (_damped_diag(V) * v.points),
                 h_mc + lam * (_damped_diag(Um) * v.mc), h_intr + lam * (_damped_diag(Ui) * v.intr))
    return _mask_params(h, free)


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 inverse by the adjugate (a handful of elementwise ops)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
    A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
    A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, torch.full_like(det, 1e-20))
    rows = torch.stack([torch.stack([A11, A12, A13], -1), torch.stack([A21, A22, A23], -1),
                        torch.stack([A31, A32, A33], -1)], -2)
    return rows * inv_det[..., None, None]


def _block_inv(B: torch.Tensor, lam) -> torch.Tensor:
    """Damped block inverses of the preconditioner. B [N, d, d]."""
    d = B.shape[-1]
    eye = torch.eye(d, dtype=B.dtype, device=B.device)
    Bd = B + (lam * _damped_diag(B))[..., None] * eye + 1e-6 * eye
    return _inv3x3(Bd) if d == 3 else torch.linalg.inv(Bd)


def _precond_apply(Minv, free: FreeMask, g: BAParams) -> BAParams:
    out = BAParams(*(torch.einsum("kab,kb->ka", M, x) for M, x in zip(Minv, g)))
    return _mask_params(out, free)


def _pcg(obs, seg, Jp, Jx, Jm, Ji, w, lam, blocks, Minv, free: FreeMask, g: BAParams,
         n_iters: int, reducer: Reducer = None, points_sharded: bool = False) -> BAParams:
    """Preconditioned CG for (H + lam D) delta = g, a fixed n_iters. g,
    blocks and Minv are replicated (the point parts rank-local when points
    are sharded); each Hessian-vector product reduces its row sums."""
    x = BAParams(*(torch.zeros_like(a) for a in g))
    r = g
    z = _precond_apply(Minv, free, r)
    p = z
    rz = _dot(r, z, reducer, points_sharded)
    for _ in range(n_iters):
        Hp = _hvp(obs, seg, Jp, Jx, Jm, Ji, w, lam, blocks, free, p, reducer, points_sharded)
        alpha = rz / torch.clamp_min(_dot(p, Hp, reducer, points_sharded), 1e-20)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, Hp, r)
        z = _precond_apply(Minv, free, r)
        rz_new = _dot(r, z, reducer, points_sharded)
        beta = rz_new / torch.clamp_min(rz, 1e-20)
        p = _axpy(beta, p, z)
        rz = rz_new
    return x


class LMState(NamedTuple):
    params: BAParams
    lam: torch.Tensor
    cost: torch.Tensor
    done: torch.Tensor
    n_iters: torch.Tensor


def _lm_cost(params: BAParams, obs: Observations, config: LMConfig, reducer: Reducer = None) -> torch.Tensor:
    r, z = residuals_only(params, obs)
    c, = _reduce(reducer, robust_cost(r, z, obs, config.huber_delta))
    return c


def _lm_init(params: BAParams, obs: Observations, config: LMConfig, reducer: Reducer = None) -> LMState:
    dev = params.poses.device
    return LMState(params, torch.tensor(config.init_lambda, dtype=torch.float32, device=dev),
                   _lm_cost(params, obs, config, reducer), torch.zeros((), dtype=torch.bool, device=dev),
                   torch.zeros((), dtype=torch.int64, device=dev))


def _lm_step_body(state: LMState, obs: Observations, seg: Segments, free: FreeMask,
                  config: LMConfig, reducer: Reducer = None) -> LMState:
    """One LM iteration: Jacobians -> PCG -> gain-ratio accept. A no-op on
    a state already `done`."""
    p = state.params
    r, z, Jp, Jx, Jm, Ji = residuals_and_jacobians(p, obs, with_mc=_carries_mask(free.mc),
                                                   with_intr=_carries_mask(free.intr))
    w, _ = huber_weights(r, z, obs, config.huber_delta)
    ps = config.points_sharded
    grad, blocks = _build_grad_and_blocks(p, seg, Jp, Jx, Jm, Ji, w, r, reducer, ps)
    grad = _mask_params(grad, free)
    Minv = tuple(_block_inv(B, state.lam) for B in blocks)
    delta = _pcg(obs, seg, Jp, Jx, Jm, Ji, w, state.lam, blocks, Minv, free, grad, config.cg_iters, reducer, ps)
    delta = BAParams(*(torch.where(torch.isfinite(x), x, torch.zeros_like(x)) for x in delta))
    new_params = BAParams(*(a + b for a, b in zip(p, _mask_params(delta, free))))
    new_cost = _lm_cost(new_params, obs, config, reducer)
    live = ~state.done
    accept = (new_cost < state.cost) & live
    gain = (state.cost - new_cost) / torch.clamp_min(torch.abs(state.cost), 1e-12)
    params_next = BAParams(*(torch.where(accept, a, b) for a, b in zip(new_params, p)))
    lam_next = torch.clamp(torch.where(accept, state.lam * config.lambda_down,
                                       state.lam * config.lambda_up), 1e-9, 1e6)
    return LMState(params_next, torch.where(live, lam_next, state.lam),
                   torch.where(accept, new_cost, state.cost),
                   state.done | (accept & (gain < config.gain_eps)), state.n_iters + live.long())


def lm_solve_interruptible(
    params: BAParams,
    obs: Observations,
    free: FreeMask,
    config: LMConfig = LMConfig(),
    interrupt=None,
    chunk_iters: int = 1,
    pre_step=None,
    reducer: Reducer = None,
) -> Tuple[BAParams, torch.Tensor]:
    """Host-driven LM: chunks of `chunk_iters` iterations, one host read of
    the `done` flag after each, `interrupt()` (the reference's InterruptBA,
    cLocalMapping.cpp:515) checked between chunks. `pre_step()` runs before
    each chunk (the async mapping worker's tracker-priority gate). Returns
    (params, robust cost).

    With a reducer, `interrupt` and `pre_step` raise: a decision one rank
    takes alone leaves the others waiting in a collective."""
    if reducer is not None and (interrupt is not None or pre_step is not None):
        raise ValueError("a distributed solve takes no interrupt or pre_step: every rank must take the same branch")
    with tracing.span("lm.solve", "solve") as sp:
        seg = make_segments(params, obs)
        state = _lm_init(params, obs, config, reducer)
        it = 0
        while it < config.max_iters:
            if pre_step is not None:
                pre_step()
            for _ in range(min(max(chunk_iters, 1), config.max_iters - it)):
                with tracing.span("lm.iter"):
                    state = _lm_step_body(state, obs, seg, free, config, reducer)
                it += 1
            with tracing.span("lm.done_read"):
                done = bool(state.done)
            if done:
                break
            if interrupt is not None and interrupt():
                break
        if sp is not None:
            # the problem's shapes and the iterations run: what the segment
            # sums had to move (each iteration: gradient and blocks, then a
            # Hessian-vector product per PCG step)
            sp.count(rows=obs.kf.shape[0], poses=params.poses.shape[0], points=params.points.shape[0],
                     iters=it, cg_steps=it * config.cg_iters)
        return state.params, state.cost


def lm_solve(params: BAParams, obs: Observations, free: FreeMask,
             config: LMConfig = LMConfig(), reducer: Reducer = None) -> Tuple[BAParams, torch.Tensor]:
    """Full LM loop until `done` or max_iters. Returns (params, robust cost).
    Pass a reducer for distributed BA (`parallel/`): each rank then holds its
    shard of the rows (and, with `config.points_sharded`, of the points)."""
    return lm_solve_interruptible(params, obs, free, config, chunk_iters=1, reducer=reducer)


# ---------------------------------------------------------------------------
# Pose-only fast path (PoseOptimization): block-diagonal direct solve.
# ---------------------------------------------------------------------------

def pose_only_solve(
    params: BAParams,
    obs: Observations,
    n_iters: int = 10,
    huber_delta: float = 2.69,
    lam: float = 1e-3,
) -> Tuple[BAParams, torch.Tensor]:
    """Optimize the body pose with everything else fixed (one pose, K = 1:
    the tracking case). The loop always runs `n_iters` iterations and
    freezes the state with `torch.where` once converged: no host sync.
    Returns (params with the updated pose, chi2 [O] of the final residuals,
    inf for rows that are invalid or behind the camera)."""
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
