"""Dense Hamming distances between binary descriptors (port of
`multicol_slam_tpu/ops/matching.py`, the parts the tracking step needs).

Descriptors unpack to +-1 vectors and ham = (nbits - a.b) / 2. The products
are float32: +-1 dot products are integers up to 512 in magnitude, so the
distances are exact. Thresholds: TH_HIGH = 3 * bytes, TH_LOW = 2 * bytes,
halved for the masked (mdBRIEF) distance.
"""
from __future__ import annotations

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
