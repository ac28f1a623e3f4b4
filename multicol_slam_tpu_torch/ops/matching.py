"""Dense Hamming distances between binary descriptors, and the match
filters (port of `multicol_slam_tpu/ops/matching.py`).

Descriptors unpack to +-1 vectors and ham = (nbits - a.b) / 2. The products
are float32: +-1 dot products are integers up to 512 in magnitude, so the
distances are exact. Thresholds: TH_HIGH = 3 * bytes, TH_LOW = 2 * bytes,
halved for the masked (mdBRIEF) distance.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

BIG = 1e9   # "no candidate"


def th_high(desc_bytes: int, masked: bool = False) -> float:
    return 1.5 * desc_bytes if masked else 3.0 * desc_bytes


def th_low(desc_bytes: int, masked: bool = False) -> float:
    return 1.0 * desc_bytes if masked else 2.0 * desc_bytes


def _unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """[..., B] uint8 -> [..., 8B] bool, LSB first."""
    w = (1 << torch.arange(8, device=desc.device)).to(torch.uint8)
    bits = (desc[..., :, None] & w) > 0
    return bits.reshape(*desc.shape[:-1], desc.shape[-1] * 8)


def unpack_pm1(desc: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[..., B] uint8 -> [..., 8B] +-1 (bit set -> +1)."""
    return _unpack_bits(desc).to(dtype) * 2 - 1


def hamming_matrix(desc_q: torch.Tensor, desc_t: torch.Tensor) -> torch.Tensor:
    """Hamming distances [..., Q, T] (batch dims broadcast)."""
    a = unpack_pm1(desc_q)
    b = unpack_pm1(desc_t)
    return 0.5 * (a.shape[-1] - torch.matmul(a, b.transpose(-1, -2)))


def hamming_matrix_masked(desc_q, mask_q, desc_t, mask_t) -> torch.Tensor:
    """mdBRIEF masked distance [..., Q, T]:
    (popcount(xor & mQ) + popcount(xor & mT)) / 2, with
    popcount(xor & m) = (sum(m) - (a * m) . b) / 2 for a, b in {-1, +1}."""
    a = unpack_pm1(desc_q)
    b = unpack_pm1(desc_t)
    mq = _unpack_bits(mask_q).to(a.dtype)
    mt = _unpack_bits(mask_t).to(a.dtype)
    dot_q = torch.matmul(a * mq, b.transpose(-1, -2))
    dot_t = torch.matmul(a, (b * mt).transpose(-1, -2))
    sum_q = mq.sum(-1)[..., :, None]
    sum_t = mt.sum(-1)[..., None, :]
    return 0.25 * ((sum_q - dot_q) + (sum_t - dot_t))


def masked_best_match(dist: torch.Tensor, mask: torch.Tensor, max_dist: float,
                      ratio: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise best match under a candidate mask, with the optional Lowe
    ratio best < ratio * second best (the 0.9 / 0.8 tests, cTracking.cpp:410,
    733; cLocalMapping.cpp:161). dist [Q, T]; mask [Q, T] bool. Returns
    (idx [Q] int32, best [Q], ok [Q]); ties go to the lowest t."""
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, idx[:, None])[:, 0]
    ok = best <= max_dist
    if ratio is not None:
        second = d.scatter(1, idx[:, None], BIG).min(dim=1).values
        ok = ok & (best < ratio * second)
    return idx.to(torch.int32), best, ok


def resolve_duplicate_targets(idx: torch.Tensor, dist: torch.Tensor, ok: torch.Tensor, n_targets: int) -> torch.Tensor:
    """One query per target: where several queries claim a target, keep the
    ones at its smallest distance (the reference's bestDist bookkeeping when
    filling mvpMapPoints). Returns the updated ok [Q]."""
    d = torch.where(ok, dist, torch.full_like(dist, BIG))
    tmin = torch.full((n_targets,), BIG, dtype=d.dtype, device=d.device)
    tmin = tmin.scatter_reduce(0, idx.long(), d, reduce="amin")
    return ok & (d <= tmin[idx.long()])


def window_mask(uv_q: torch.Tensor, uv_t: torch.Tensor, radius, octave_q: Optional[torch.Tensor] = None,
                octave_t: Optional[torch.Tensor] = None, level_tol: Optional[int] = None) -> torch.Tensor:
    """Spatial window [Q, T]: |u_q - u_t| <= r and |v_q - v_t| <= r (a
    scalar radius or one per query), and |octave_q - octave_t| <= level_tol
    when given: the dense GetFeaturesInArea (cMultiFrame.cpp:272-340)."""
    r = torch.as_tensor(radius, dtype=uv_q.dtype, device=uv_q.device)
    if r.dim() == 1:
        r = r[:, None]
    du = torch.abs(uv_q[:, None, 0] - uv_t[None, :, 0])
    dv = torch.abs(uv_q[:, None, 1] - uv_t[None, :, 1])
    m = (du <= r) & (dv <= r)
    if octave_q is not None and level_tol is not None:
        m = m & (torch.abs(octave_q[:, None] - octave_t[None, :]) <= level_tol)
    return m


def mutual_filter(idx_qt: torch.Tensor, ok_q: torch.Tensor, idx_tq: torch.Tensor) -> torch.Tensor:
    """Keep q only if t = idx_qt[q] maps back: idx_tq[t] == q (cross-check)."""
    q_ids = torch.arange(idx_qt.shape[0], dtype=idx_qt.dtype, device=idx_qt.device)
    return ok_q & (idx_tq[idx_qt.long()] == q_ids)


def rotation_consistency(dangle: torch.Tensor, ok: torch.Tensor, n_bins: int = 30,
                         keep_bins: int = 3) -> torch.Tensor:
    """ORB rotation-histogram check (cORBmatcher's rotHist): histogram the
    match angle deltas into 30 bins and keep only matches in the `keep_bins`
    most popular bins that also hold >= 10% of the top bin's votes.
    dangle [..., Q] radians; ok [..., Q] bool; one histogram per leading
    index."""
    two_pi = 2.0 * math.pi
    frac = torch.remainder(dangle, two_pi) / two_pi            # floor modulo, as jnp's %
    bins = torch.clamp((frac * n_bins).to(torch.int32), 0, n_bins - 1).long()
    counts = torch.zeros(ok.shape[:-1] + (n_bins,), dtype=torch.int32, device=dangle.device)
    counts = counts.scatter_add(-1, bins, ok.to(torch.int32))
    top = torch.topk(counts, keep_bins, dim=-1).values
    thresh = torch.maximum(top[..., -1], (0.1 * top[..., 0]).to(counts.dtype))
    keep = torch.gather(counts, -1, bins) >= torch.clamp_min(thresh, 1)[..., None]
    return ok & keep
