"""BA entry points (port of `multicol_slam_tpu/optim/ba.py`).

The pose-only, local, global, structure-only and self-calibrating modes are
the same (params, observations, free mask) structure solved by
optim/lm.py; the mode chooses only the masks and the robust-kernel
constants. Loop closing adds two Gauss-Newton solvers:

  optimize_sim3            ~ cOptimizerLoopStuff::OptimizeSim3 (:63-271)
  optimize_essential_graph ~ OptimizeEssentialGraph (:273-520)

Their Jacobians are forward-mode autodiff (`torch.func`), as the
reference's `jax.jacfwd`; the essential graph's sums over edges are the
deterministic segment sums of optim/lm.py (a scatter-add on CUDA adds in
atomic order).

Tracking's `pose_optimization` (two robust rounds of pose-only
Gauss-Newton) is one launch of a hand-written kernel on the card
(`csrc/pose_opt.cu`, in the library of `ops/cuda_lib.py`); its plain
version, `pose_optimization_plain`, runs for CPU tensors and is what the
tests hold the kernel to."""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd, jvp, vmap

from multicol_slam_tpu_torch.ops.cuda_lib import KernelEntry, check_all
from multicol_slam_tpu_torch.optim.lm import (
    LMConfig, _segsum, lm_solve, lm_solve_interruptible, pose_only_solve, segments,
)
from multicol_slam_tpu_torch.optim.problem import (
    INTR_DIM, BAParams, FreeMask, Observations, intr_project, residuals_only,
)
from multicol_slam_tpu_torch.utils.geometry import (
    cayley_to_hom, hom_inverse, sim3_apply, sim3_compose, sim3_exp, sim3_inverse, sim3_log, transform_points,
)

CHI2_BA = 5.991                      # Huber sqrt(5.991) in BA
POSE_HUBER = 1.345 * 2.0             # cOptimizer.cpp:344 (huberMultiplier = 2)
CHI2_POSE = POSE_HUBER * POSE_HUBER  # outlier demotion threshold
POSE_ITERS = 10                      # Gauss-Newton iterations a pose-only round
POSE_LAM = 1e-3                      # the pose-only rounds' initial damping
SIM3_HUBER = 1.345 * 4.0
SIM3_CHI2 = 9.210                    # the inlier gate of both Sim3 edges

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# both rounds of pose_optimization, csrc/pose_opt.cu
POSE_KERNEL = KernelEntry("mcslam_pose_opt", [_P, _P, _I] + [_P] * 5 + [_I, _P, _P, _I, _I, _F, _F, _F] + [_P] * 6)
_POSE_SCRATCH_BYTES = KernelEntry("mcslam_pose_opt_scratch_bytes", [_I, _I], ctypes.c_size_t)


def pose_optimization(params: BAParams, obs: Observations):
    """Two rounds of pose-only optimization with chi2 outlier demotion between
    them. Returns (poses [K, 6], inlier mask [O], n_inliers).

    The inputs must pass `check_pose_inputs` on every device. CPU tensors
    take the plain version, CUDA tensors the kernel (one launch for both
    rounds); any other device raises."""
    return pose_optimization_iters(params, obs)[:3]


def pose_optimization_iters(params: BAParams, obs: Observations):
    """`pose_optimization` and the iterations each round ran before it
    stopped: (poses, inlier, n_inliers, iters), iters an int32 [2] on the
    card (the kernel's, not read here) and None on the CPU."""
    check_pose_inputs(params, obs)
    dev = params.poses.device
    if dev.type == "cpu":
        return (*pose_optimization_plain(params, obs), None)
    if dev.type == "cuda":
        return pose_optimization_cuda(params, obs)
    raise ValueError(f"pose_optimization: no kernel for device {dev}")


def pose_optimization_plain(params: BAParams, obs: Observations):
    """The plain version of `pose_optimization`: two eager
    `pose_only_solve` rounds."""
    p1, chi2 = pose_only_solve(params, obs, n_iters=POSE_ITERS, huber_delta=POSE_HUBER, lam=POSE_LAM)
    inl = obs.valid & (chi2 < CHI2_POSE)
    p2, chi2b = pose_only_solve(p1, obs._replace(valid=inl), n_iters=POSE_ITERS, huber_delta=POSE_HUBER,
                                lam=POSE_LAM)
    inl2 = obs.valid & (chi2b < CHI2_POSE)
    return p2.poses, inl2, inl2.sum()


def check_pose_inputs(params: BAParams, obs: Observations):
    """What the kernel reads: one float32 pose [1, 6] (K > 1 raises, as
    in the plain version), points [L, 3], mc [C, 6] and intr [C, 22];
    int64 pt and cam [O], float32 uv [O, 2] and inv_sigma2 [O], bool
    valid [O]; contiguous, 4-byte aligned, on the pose's device. Raises
    ValueError. obs.kf is not read (one pose)."""
    if params.poses.dim() == 2 and params.poses.shape[0] > 1:
        raise ValueError("pose_optimization is ported for a single pose (K = 1) only")
    O, L, C = obs.pt.shape[0], params.points.shape[0], params.mc.shape[0]
    f32 = torch.float32
    check_all([("poses", params.poses, f32, (1, 6)), ("points", params.points, f32, (L, 3)),
               ("mc", params.mc, f32, (C, 6)), ("intr", params.intr, f32, (C, INTR_DIM)),
               ("pt", obs.pt, torch.int64, (O,)), ("cam", obs.cam, torch.int64, (O,)),
               ("uv", obs.uv, f32, (O, 2)), ("inv_sigma2", obs.inv_sigma2, f32, (O,)),
               ("valid", obs.valid, torch.bool, (O,))], params.poses.device)


def pose_optimization_cuda(params: BAParams, obs: Observations):
    """One launch of the kernel on the current stream, no sync: (poses
    [1, 6], inlier [O], n_inliers, iters [2] int32: each round's
    iterations before its stop). Inputs as `check_pose_inputs` says."""
    dev = params.poses.device
    O, L, C = obs.pt.shape[0], params.points.shape[0], params.mc.shape[0]
    pose = torch.empty((1, 6), dtype=torch.float32, device=dev)
    inlier = torch.empty((O,), dtype=torch.bool, device=dev)
    n_inliers = torch.empty((), dtype=torch.int64, device=dev)
    iters = torch.empty((2,), dtype=torch.int32, device=dev)
    n_scratch = _POSE_SCRATCH_BYTES.function()(O, C)
    scratch = torch.empty((n_scratch,), dtype=torch.uint8, device=dev) if n_scratch else None
    fn = POSE_KERNEL.function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(params.poses.data_ptr(), params.points.data_ptr(), L, obs.pt.data_ptr(), obs.cam.data_ptr(),
                 obs.uv.data_ptr(), obs.inv_sigma2.data_ptr(), obs.valid.data_ptr(), O,
                 params.mc.data_ptr(), params.intr.data_ptr(), C, POSE_ITERS, POSE_HUBER, CHI2_POSE, POSE_LAM,
                 pose.data_ptr(), inlier.data_ptr(), n_inliers.data_ptr(), iters.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"pose_opt kernel launch failed: cudaError_t {err}")
    POSE_KERNEL.count()
    return pose, inlier, n_inliers, iters


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
    pre_step=None,
) -> Tuple[BAParams, torch.Tensor]:
    """Local BA driven `chunk_iters` LM iterations at a time, abortable
    between chunks (InterruptBA, cLocalMapping.cpp:515); `pre_step()` runs
    before each chunk."""
    return lm_solve_interruptible(params, obs, free, _config(max_iters, cg_iters), interrupt,
                                  chunk_iters=chunk_iters, pre_step=pre_step)


def prune_observations(params: BAParams, obs: Observations, chi2_th: float = CHI2_BA) -> torch.Tensor:
    """Post-BA outlier pruning (LocalBundleAdjustment's chi2 erase pass,
    cOptimizer.cpp:798-860). Returns the updated valid mask."""
    r, z = residuals_only(params, obs)
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    return obs.valid & (chi2 <= chi2_th) & (z > 0)


# ---------------------------------------------------------------------------
# Sim3 of a keyframe pair (the loop's geometric check)
# ---------------------------------------------------------------------------

class Sim3Obs(NamedTuple):
    """Matched map points of two MultiKeyFrames, each with the camera that
    observes it (cOptimizerLoopStuff.cpp:63-271: the forward edge projects
    the KF2 point through S12 into KF1's camera, the inverse edge the KF1
    point through S12^-1 into KF2's camera)."""

    X1: torch.Tensor            # [N, 3] points in KF1's body frame
    X2: torch.Tensor            # [N, 3] points in KF2's body frame
    uv1: torch.Tensor           # [N, 2] measured pixels in KF1 (cam1)
    uv2: torch.Tensor           # [N, 2] measured pixels in KF2 (cam2)
    cam1: torch.Tensor          # [N] int
    cam2: torch.Tensor          # [N] int
    inv_sigma2_1: torch.Tensor  # [N]
    inv_sigma2_2: torch.Tensor  # [N]
    valid: torch.Tensor         # [N] bool


def _project_body(rig_mc, rig_intr, cam_idx, Xb):
    """Body-frame points Xb [..., N, 3] through camera cam_idx [N] of the rig:
    (uv [..., N, 2], z [..., N])."""
    Xc = transform_points(hom_inverse(cayley_to_hom(rig_mc[cam_idx])), Xb)
    return intr_project(rig_intr[cam_idx], Xc), Xc[..., 2]


def optimize_sim3(v7_init: torch.Tensor, sobs: Sim3Obs, rig_mc: torch.Tensor, rig_intr: torch.Tensor,
                  n_iters: int = 12, fix_scale: bool = False):
    """Gauss-Newton on the 7-dof S12 (KF2 body -> KF1 body) over the symmetric
    reprojection error through each observation's camera, Huber 1.345 x 4,
    n_iters fixed steps. fix_scale zeroes the scale column of the Jacobian.
    Returns (v7, inlier mask, n_inliers); an inlier passes chi2 9.210 in
    both directions (the reference's th2, cOptimizerLoopStuff.cpp ~:200)."""

    def residuals(v7):
        R12, t12, s12 = sim3_exp(v7)
        X2in1 = sim3_apply(R12, t12, s12, sobs.X2)
        X1in2 = sim3_apply(*sim3_inverse(R12, t12, s12), sobs.X1)
        uv1p, z1 = _project_body(rig_mc, rig_intr, sobs.cam1, X2in1)
        uv2p, z2 = _project_body(rig_mc, rig_intr, sobs.cam2, X1in2)
        r1 = (sobs.uv1 - uv1p) * torch.sqrt(sobs.inv_sigma2_1)[:, None]
        r2 = (sobs.uv2 - uv2p) * torch.sqrt(sobs.inv_sigma2_2)[:, None]
        r = torch.cat([r1, r2], dim=-1)                            # [N, 4]
        return r, (r, sobs.valid & (z1 > 0) & (z2 > 0))

    eye = torch.eye(7, dtype=v7_init.dtype, device=v7_init.device)
    v7 = v7_init
    for _ in range(n_iters):
        J, (r, ok) = jacfwd(residuals, has_aux=True)(v7)           # [N, 4, 7]
        e = torch.sqrt(torch.sum(r * r, -1) + 1e-18)
        w = torch.where(ok, torch.clamp_max(SIM3_HUBER / e, 1.0), torch.zeros_like(e))
        if fix_scale:
            J = torch.cat([J[..., :6], torch.zeros_like(J[..., 6:])], dim=-1)
        H = torch.einsum("nij,n,nik->jk", J, w, J) + 1e-6 * eye
        g = -torch.einsum("nij,n,ni->j", J, w, r)
        v7 = v7 + torch.linalg.solve(H, g[:, None])[:, 0]
    _, (r, ok) = residuals(v7)
    inl = ok & (torch.sum(r[:, :2] ** 2, -1) < SIM3_CHI2) & (torch.sum(r[:, 2:] ** 2, -1) < SIM3_CHI2)
    return v7, inl, inl.sum()


# ---------------------------------------------------------------------------
# The essential graph (Sim3 pose graph)
# ---------------------------------------------------------------------------

class Sim3Edges(NamedTuple):
    i: torch.Tensor       # [E] vertex index i
    j: torch.Tensor       # [E] vertex index j
    meas: torch.Tensor    # [E, 7] measured S_ji (v7): S_j ~= S_ji o S_i
    weight: torch.Tensor  # [E] edge weight (loop edges weigh more)
    valid: torch.Tensor   # [E] bool


def _edge_residual(vi, vj, meas):
    """log(S_ji_meas o S_i o S_j^-1) of one edge."""
    Ri, ti, si = sim3_exp(vi)
    Rj, tj, sj = sim3_exp(vj)
    Rm, tm, sm = sim3_exp(meas)
    Rji, tji, sji = sim3_compose(Rm, tm, sm, Ri, ti, si)
    return sim3_log(*sim3_compose(Rji, tji, sji, *sim3_inverse(Rj, tj, sj)))


def _edge_jacobians(vi, vj, meas):
    """d residual / d vi and d vj of every edge, [E, 7, 7] each: forward mode,
    one tangent of all edges at a time (the edges stay a real batch axis;
    vmap over per-edge 0-dim tensors promotes some of them to float64)."""
    basis = torch.eye(7, dtype=vi.dtype, device=vi.device)[:, None, :].expand(7, *vi.shape)

    def column(f, x):
        return vmap(lambda tan: jvp(f, (x,), (tan,))[1])(basis).permute(1, 2, 0)
    return (column(lambda a: _edge_residual(a, vj, meas), vi),
            column(lambda b: _edge_residual(vi, b, meas), vj))


def optimize_essential_graph(v7: torch.Tensor, edges: Sim3Edges, fixed: torch.Tensor, n_iters: int = 20,
                             dense_limit: int = 300) -> torch.Tensor:
    """Sim3 pose-graph Gauss-Newton (OptimizeEssentialGraph,
    cOptimizerLoopStuff.cpp:273-520): vertices are S_iw (world -> keyframe
    body, 7 dof), each edge constrains a relative Sim3 with residual
    log(S_ji_meas o S_i o S_j^-1). K <= dense_limit assembles the damped
    7K x 7K system and solves it densely; a larger graph runs 60 steps of
    block-Jacobi PCG over the edge table a GN step (the matrix never
    formed). v7 [K, 7]; fixed [K] bool (the loop keyframe, :339). Returns
    the optimized v7 [K, 7]."""
    K = v7.shape[0]
    dev, dt = v7.device, v7.dtype
    ii, jj = edges.i.long(), edges.j.long()
    E = ii.shape[0]
    w = torch.where(edges.valid, edges.weight.to(dt), torch.zeros((), dtype=dt, device=dev))
    free = (~fixed).to(dt)
    seg_v = segments(torch.cat([ii, jj]), K)        # rows of i, then of j, onto vertices

    def linearize(v):
        r = _edge_residual(v[ii], v[jj], edges.meas)       # [E, 7]
        Ji, Jj = _edge_jacobians(v[ii], v[jj], edges.meas)  # [E, 7, 7] each
        g = -_segsum(torch.cat([torch.einsum("eab,e,ea->eb", Ji, w, r),
                                torch.einsum("eab,e,ea->eb", Jj, w, r)]), seg_v)
        return Ji, Jj, g

    def outer(A, B):
        return torch.einsum("eab,e,eac->ebc", A, w, B)

    if K <= dense_limit:
        blocks = torch.cat([ii * K + ii, jj * K + jj, ii * K + jj, jj * K + ii])
        seg_h = segments(blocks, K * K)
        fm = torch.repeat_interleave(free, 7)
        eye = torch.eye(7 * K, dtype=dt, device=dev)
        for _ in range(n_iters):
            Ji, Jj, g = linearize(v7)
            H = _segsum(torch.cat([outer(Ji, Ji), outer(Jj, Jj), outer(Ji, Jj), outer(Jj, Ji)]).reshape(4 * E, 49),
                        seg_h).reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
            # fixed vertices: rows and columns zeroed, identity on the diagonal
            Hm = (H + 1e-5 * eye) * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
            delta = torch.linalg.solve(Hm, (g.reshape(7 * K) * fm)[:, None])[:, 0]
            v7 = v7 + delta.reshape(K, 7)
        return v7

    free = free[:, None]
    eye7 = torch.eye(7, dtype=dt, device=dev)
    for _ in range(n_iters):
        Ji, Jj, g = linearize(v7)
        g = g * free
        # block-Jacobi preconditioner from the per-vertex diagonal blocks
        Hd = _segsum(torch.cat([outer(Ji, Ji), outer(Jj, Jj)]).reshape(2 * E, 49), seg_v).reshape(K, 7, 7)
        Minv = torch.linalg.inv(Hd + 1e-5 * eye7)

        def Hv(x):
            x = x * free
            sw = w[:, None] * (torch.einsum("eab,eb->ea", Ji, x[ii]) + torch.einsum("eab,eb->ea", Jj, x[jj]))
            y = _segsum(torch.cat([torch.einsum("eab,ea->eb", Ji, sw), torch.einsum("eab,ea->eb", Jj, sw)]), seg_v)
            return (y + 1e-5 * x) * free

        def precond(x):
            return torch.einsum("kab,kb->ka", Minv, x) * free

        x = torch.zeros_like(g)
        rr = g
        z = precond(rr)
        p, rz = z, torch.sum(rr * z)
        for _ in range(60):
            Hp = Hv(p)
            alpha = rz / torch.clamp_min(torch.sum(p * Hp), 1e-20)
            x = x + alpha * p
            rr = rr - alpha * Hp
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            p = z + rz_new / torch.clamp_min(rz, 1e-20) * p
            rz = rz_new
        v7 = v7 + x
    return v7
