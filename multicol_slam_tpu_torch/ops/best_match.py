"""Fused masked-Hamming best match: the CUDA kernels of `csrc/best_match.cu`
and their plain PyTorch versions.

Counterpart of `multicol_slam_tpu/ops/pallas_match.py`, two TPU kernels:

  K1 `masked_best_match_cams` <- `masked_best_match_pallas_cams` (`pallas_call`
     at :361, bodies `kernel` and `kernel_masked`, :305-340), called once per
     tracking stage and twice by `match_window_frames`;
  K2 `masked_best_match` <- `masked_best_match_pallas` (:113, body
     `_match_kernel`, :45-98): one camera, no masks, no col_best.

Per camera c and query q, over the targets t allowed by the window
|uv_q - uv_t| <= min(rad_q, rad_t) (a negative radius disables) and the
level band |oct_q - lvl_t| <= level_tol, it returns

    best [C, Q] f32     smallest distance, BIG = 1e9 when nothing is allowed
    second [C, Q] f32   smallest distance over every column but the argmin
    idx [C, Q] i32      first argmin, -1 when nothing is allowed
    col_best [C, T] f32 smallest distance over the queries of each target

with the distance popc(a ^ b), or (popc(x & m_q) + popc(x & m_t)) / 2 when
mdBRIEF masks are given (callers then halve their thresholds).

What bounds it on this card: the dense +-1 products, as the TPU kernel
computes them, are 2.52 G operations at the tracking shape (C=3, Q=400,
T=4096), 1.27 us at the int8 tensor-core peak; the bytes take a tenth of
that. So the kernel is a latency problem, and its design (the source's
note) splits the targets over a grid of (query tiles of QUERY_TILE,
chunks of `target_chunk` targets, cameras), stages target tiles with the
bulk async copy, computes the distances on the tensor cores (b1 AND+POPC
products) and merges the blocks' partials exactly, in chunk order, in the
last block of each query tile. `masked_best_match_cams_split_plain` is that
split and merge in PyTorch, for the tests.

Each wrapper runs its plain version for CPU tensors only. For CUDA tensors
it launches its kernel or raises. The kernels live in the port's one CUDA
library (`ops/cuda_lib.py`), built with nvcc for sm_90a at first use.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from multicol_slam_tpu_torch.ops.cuda_lib import CSRC, KernelEntry, check_all
from multicol_slam_tpu_torch.ops.matching import hamming_matrix, hamming_matrix_masked
from multicol_slam_tpu_torch.utils import tracing

BIG = 1e9
QUERY_TILE = 64    # queries of a block: 4 warps x the 16 rows of an mma tile
TARGET_TILE = 64   # targets of a shared-memory stage
MIN_BLOCKS = 528   # four blocks for each of the H100's 132 SMs
BODY = "tensor cores: mma.sync m16n8k256 b1 AND+POPC, 2 products a pair (4 with masks)"
SOURCE = CSRC / "best_match.cu"

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# K1, masked_best_match_cams
KERNEL = KernelEntry("mcslam_best_match", [_P] * 7 + [_I] + [_P] * 3 + [_I] * 4 + [_F] + [_I] + [_P] * 6)
# K2, masked_best_match
KERNEL_SINGLE = KernelEntry("mcslam_best_match_single", [_P] * 8 + [_I] * 3 + [_F] + [_I] + [_P] * 5)


def window_mask(uv_q, oct_q, uv_t, rad_t, lvl_t, rad_q=None, level_tol: float = 1.0) -> torch.Tensor:
    """[C, Q, T] bool: the pairs that pass the window and the level band."""
    if rad_q is None:
        rad_q = torch.full(uv_q.shape[:-1], BIG, dtype=torch.float32, device=uv_q.device)
    rad = torch.minimum(rad_q[..., :, None], rad_t[..., None, :])
    du = torch.abs(uv_q[..., :, None, 0] - uv_t[..., None, :, 0])
    dv = torch.abs(uv_q[..., :, None, 1] - uv_t[..., None, :, 1])
    dl = torch.abs(oct_q.to(torch.float32)[..., :, None] - lvl_t.to(torch.float32)[..., None, :])
    return (du <= rad) & (dv <= rad) & (dl <= level_tol)


def masked_best_match_cams_plain(
    desc_q: torch.Tensor,
    uv_q: torch.Tensor,
    oct_q: torch.Tensor,
    desc_t: torch.Tensor,
    uv_t: torch.Tensor,
    rad_t: torch.Tensor,
    lvl_t: torch.Tensor,
    rad_q: Optional[torch.Tensor] = None,
    mask_q: Optional[torch.Tensor] = None,
    mask_t: Optional[torch.Tensor] = None,
    level_tol: float = 1.0,
) -> Outputs:
    """Plain version of the kernel: the dense [C, Q, T] masked distance, then
    row and column reductions. Same arguments and outputs as
    `masked_best_match_cams`."""
    if mask_q is not None and mask_t is not None:
        ham = hamming_matrix_masked(desc_q, mask_q, desc_t, mask_t)
    else:
        ham = hamming_matrix(desc_q, desc_t)
    mask = window_mask(uv_q, oct_q, uv_t, rad_t, lvl_t, rad_q, level_tol)
    d = torch.where(mask, ham, torch.full_like(ham, BIG))
    idx = torch.argmin(d, dim=-1, keepdim=True)                 # first minimum
    best = torch.gather(d, -1, idx)[..., 0]
    second = torch.scatter(d, -1, idx, BIG).amin(dim=-1)
    idx = torch.where(best < BIG, idx[..., 0], -1).to(torch.int32)
    return best, second, idx, d.amin(dim=-2)


def target_chunk(C: int, Q: int, T: int) -> int:
    """Targets one block of the kernel covers: the largest of 256 and 128
    that still gives MIN_BLOCKS blocks over (query tiles, target chunks,
    cameras), else one stage tile."""
    q_tiles = -(-Q // QUERY_TILE)
    for chunk in (256, 128):
        if C * q_tiles * -(-T // chunk) >= MIN_BLOCKS:
            return chunk
    return TARGET_TILE


def masked_best_match_cams_split_plain(
    desc_q: torch.Tensor,
    uv_q: torch.Tensor,
    oct_q: torch.Tensor,
    desc_t: torch.Tensor,
    uv_t: torch.Tensor,
    rad_t: torch.Tensor,
    lvl_t: torch.Tensor,
    rad_q: Optional[torch.Tensor] = None,
    mask_q: Optional[torch.Tensor] = None,
    mask_t: Optional[torch.Tensor] = None,
    level_tol: float = 1.0,
    chunk: int = 256,
) -> Outputs:
    """The plain version computed per chunk of `chunk` targets and merged in
    increasing chunk order, as the kernel merges its blocks' partials (the
    TPU kernel's tile merge, pallas_match.py:282-284):

        best = min(r1, t1); second = min(max(r1, t1), min(r2, t2))
        idx = idx_t if t1 < r1 else idx_r   (a tie keeps the lower chunk)

    Same arguments and outputs as `masked_best_match_cams`; for the tests."""
    C, Q = desc_q.shape[:2]
    T = desc_t.shape[-2]
    dev = desc_q.device
    r1 = torch.full((C, Q), BIG, dtype=torch.float32, device=dev)
    r2 = torch.full((C, Q), BIG, dtype=torch.float32, device=dev)
    ri = torch.full((C, Q), -1, dtype=torch.int32, device=dev)
    cols = []
    masked = mask_q is not None and mask_t is not None
    for t0 in range(0, T, chunk):
        sl = slice(t0, t0 + chunk)
        t1, t2, ti, cb = masked_best_match_cams_plain(
            desc_q, uv_q, oct_q, desc_t[..., sl, :], uv_t[:, sl], rad_t[:, sl], lvl_t[:, sl], rad_q,
            mask_q, mask_t[..., sl, :] if masked else None, level_tol)
        ti = torch.where(ti >= 0, ti + t0, ti)
        r2 = torch.minimum(torch.maximum(r1, t1), torch.minimum(r2, t2))
        ri = torch.where(t1 < r1, ti, ri)
        r1 = torch.minimum(r1, t1)
        cols.append(cb)
    return r1, r2, ri, torch.cat(cols, dim=-1)


def _scratch(C: int, Q: int, T: int, chunk: int, dev) -> torch.Tensor:
    """The kernel's scratch: each block's partial (best, second, idx) per
    query, [3, C, S, Q] with S = ceil(T / chunk), then one ticket per
    (camera, query tile)."""
    S = max(1, -(-T // chunk))
    return torch.empty(3 * C * S * Q + C * -(-Q // QUERY_TILE), dtype=torch.int32, device=dev)


def masked_best_match_cams(
    desc_q: torch.Tensor,    # [C, Q, B] uint8
    uv_q: torch.Tensor,      # [C, Q, 2] f32
    oct_q: torch.Tensor,     # [C, Q] f32 or i32
    desc_t: torch.Tensor,    # [C, T, B] uint8, or [T, B] shared by all cameras
    uv_t: torch.Tensor,      # [C, T, 2] f32
    rad_t: torch.Tensor,     # [C, T] f32 (<0 disables)
    lvl_t: torch.Tensor,     # [C, T] f32
    rad_q: Optional[torch.Tensor] = None,   # [C, Q] f32 (None -> unlimited)
    mask_q: Optional[torch.Tensor] = None,  # [C, Q, B] uint8 mdBRIEF masks
    mask_t: Optional[torch.Tensor] = None,  # like desc_t
    level_tol: float = 1.0,
) -> Outputs:
    """(best, second, idx, col_best) of the masked Hamming matrix per camera;
    see the module docstring. With the tracer on, the call is a `k1` span
    that counts the launch's shape (C, Q, T, B, shared, masked) and P, the
    pairs that pass the window and the level band. P is computed when the
    counters are read, from the launch's inputs (kept until then, and not
    modified by the callers), so the traced program launches no kernel the
    untraced one does not."""
    with tracing.span("k1") as sp:
        out = _best_match_cams(desc_q, uv_q, oct_q, desc_t, uv_t, rad_t, lvl_t, rad_q, mask_q, mask_t, level_tol)
    if sp is not None:
        C, Q, B = desc_q.shape
        sp.count(C=C, Q=Q, T=desc_t.shape[-2], B=B, shared=int(desc_t.dim() == 2),
                 masked=int(mask_q is not None and mask_t is not None),
                 P=lambda: window_mask(uv_q, oct_q, uv_t, rad_t, lvl_t, rad_q, level_tol).sum())
    return out


def _best_match_cams(desc_q, uv_q, oct_q, desc_t, uv_t, rad_t, lvl_t, rad_q, mask_q, mask_t, level_tol) -> Outputs:
    if desc_q.device.type == "cpu":
        return masked_best_match_cams_plain(desc_q, uv_q, oct_q, desc_t, uv_t, rad_t, lvl_t,
                                            rad_q, mask_q, mask_t, level_tol)
    if not desc_q.is_cuda:
        raise ValueError(f"masked_best_match_cams: no kernel for device {desc_q.device}")
    dev = desc_q.device
    C, Q, B = desc_q.shape
    T = desc_t.shape[-2]
    if B not in (16, 32, 64):
        raise ValueError(f"descriptor bytes must be 16, 32 or 64, got {B}")
    shared = desc_t.dim() == 2
    t_shape = (T, B) if shared else (C, T, B)
    masked = mask_q is not None and mask_t is not None
    if rad_q is None:
        rad_q = torch.full((C, Q), BIG, dtype=torch.float32, device=dev)
    oct_q = oct_q.to(torch.float32)
    lvl_t = lvl_t.to(torch.float32)
    checks = [("desc_q", desc_q, torch.uint8, (C, Q, B)), ("uv_q", uv_q, torch.float32, (C, Q, 2)),
              ("oct_q", oct_q, torch.float32, (C, Q)), ("rad_q", rad_q, torch.float32, (C, Q)),
              ("desc_t", desc_t, torch.uint8, t_shape), ("uv_t", uv_t, torch.float32, (C, T, 2)),
              ("rad_t", rad_t, torch.float32, (C, T)), ("lvl_t", lvl_t, torch.float32, (C, T))]
    if masked:
        if (mask_t.dim() == 2) != shared:
            raise ValueError("mask_t must be shared across cameras exactly when desc_t is")
        checks += [("mask_q", mask_q, torch.uint8, (C, Q, B)), ("mask_t", mask_t, torch.uint8, t_shape)]
    check_all(checks, dev)
    best = torch.empty((C, Q), dtype=torch.float32, device=dev)
    second = torch.empty((C, Q), dtype=torch.float32, device=dev)
    idx = torch.empty((C, Q), dtype=torch.int32, device=dev)
    col_best = torch.empty((C, T), dtype=torch.float32, device=dev)
    chunk = target_chunk(C, Q, T)
    scratch = _scratch(C, Q, T, chunk, dev)
    fn = KERNEL.function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(desc_q.data_ptr(), mask_q.data_ptr() if masked else None,
                 uv_q.data_ptr(), oct_q.data_ptr(), rad_q.data_ptr(),
                 desc_t.data_ptr(), mask_t.data_ptr() if masked else None, int(shared),
                 uv_t.data_ptr(), rad_t.data_ptr(), lvl_t.data_ptr(),
                 C, Q, T, B, float(level_tol), chunk,
                 best.data_ptr(), second.data_ptr(), idx.data_ptr(), col_best.data_ptr(),
                 scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"best_match kernel launch failed: cudaError_t {err}")
    KERNEL.count()
    return best, second, idx, col_best


def masked_best_match_plain(
    desc_q: torch.Tensor,
    uv_q: torch.Tensor,
    oct_q: torch.Tensor,
    desc_t: torch.Tensor,
    uv_t: torch.Tensor,
    rad_t: torch.Tensor,
    lvl_t: torch.Tensor,
    rad_q: Optional[torch.Tensor] = None,
    level_tol: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2: the dense [Q, T] masked Hamming matrix of one
    camera, then the row reductions. Same arguments and outputs as
    `masked_best_match`."""
    best, second, idx, _ = masked_best_match_cams_plain(
        desc_q[None], uv_q[None], oct_q[None], desc_t, uv_t[None], rad_t[None], lvl_t[None],
        None if rad_q is None else rad_q[None], level_tol=level_tol)
    return best[0], second[0], idx[0]


def masked_best_match(
    desc_q: torch.Tensor,    # [Q, B] uint8
    uv_q: torch.Tensor,      # [Q, 2] f32
    oct_q: torch.Tensor,     # [Q] f32 or i32
    desc_t: torch.Tensor,    # [T, B] uint8
    uv_t: torch.Tensor,      # [T, 2] f32
    rad_t: torch.Tensor,     # [T] f32 (<0 disables)
    lvl_t: torch.Tensor,     # [T] f32
    rad_q: Optional[torch.Tensor] = None,   # [Q] f32 (None -> unlimited)
    level_tol: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: (best [Q], second [Q], idx [Q]) of one camera's window- and
    level-masked Hamming matrix, the counterpart of the TPU kernel
    `masked_best_match_pallas`. No masks and no col_best; the semantics are
    K1's at C = 1 (ties to the lowest t, BIG and idx -1 when nothing passes).

    No system path calls it: like its TPU counterpart it is a single-camera
    op beside K1, held to its plain version by the tests and chip_smoke.py.
    It is K1's kernel without the column work: at Q = T = 800 the grid is 13
    query tiles x 13 chunks of 64 targets."""
    if desc_q.device.type == "cpu":
        return masked_best_match_plain(desc_q, uv_q, oct_q, desc_t, uv_t, rad_t, lvl_t,
                                       rad_q, level_tol)
    if not desc_q.is_cuda:
        raise ValueError(f"masked_best_match: no kernel for device {desc_q.device}")
    dev = desc_q.device
    Q, B = desc_q.shape
    T = desc_t.shape[0]
    if B not in (16, 32, 64):
        raise ValueError(f"descriptor bytes must be 16, 32 or 64, got {B}")
    if rad_q is None:
        rad_q = torch.full((Q,), BIG, dtype=torch.float32, device=dev)
    oct_q = oct_q.to(torch.float32)
    lvl_t = lvl_t.to(torch.float32)
    check_all([("desc_q", desc_q, torch.uint8, (Q, B)), ("uv_q", uv_q, torch.float32, (Q, 2)),
                ("oct_q", oct_q, torch.float32, (Q,)), ("rad_q", rad_q, torch.float32, (Q,)),
                ("desc_t", desc_t, torch.uint8, (T, B)), ("uv_t", uv_t, torch.float32, (T, 2)),
                ("rad_t", rad_t, torch.float32, (T,)), ("lvl_t", lvl_t, torch.float32, (T,))], dev)
    best = torch.empty((Q,), dtype=torch.float32, device=dev)
    second = torch.empty((Q,), dtype=torch.float32, device=dev)
    idx = torch.empty((Q,), dtype=torch.int32, device=dev)
    chunk = target_chunk(1, Q, T)
    scratch = _scratch(1, Q, T, chunk, dev)
    fn = KERNEL_SINGLE.function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(desc_q.data_ptr(), uv_q.data_ptr(), oct_q.data_ptr(), rad_q.data_ptr(),
                 desc_t.data_ptr(), uv_t.data_ptr(), rad_t.data_ptr(), lvl_t.data_ptr(),
                 Q, T, B, float(level_tol), chunk, best.data_ptr(), second.data_ptr(),
                 idx.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"best_match_single kernel launch failed: cudaError_t {err}")
    KERNEL_SINGLE.count()
    return best, second, idx
