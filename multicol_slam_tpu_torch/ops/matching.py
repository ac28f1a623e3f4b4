"""Dense Hamming distances between binary descriptors, and the match
filters (port of `multicol_slam_tpu/ops/matching.py`, the parts the
tracking step and the map bootstrap need).

Descriptors unpack to +-1 vectors and ham = (nbits - a.b) / 2. The products
are float32: +-1 dot products are integers up to 512 in magnitude, so the
distances are exact. Thresholds: TH_HIGH = 3 * bytes, TH_LOW = 2 * bytes,
halved for the masked (mdBRIEF) distance.
"""
from __future__ import annotations

import math

import torch


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
