"""Dense FAST-9/16 corners + grid-uniform top-K selection (port of
`multicol_slam_tpu/ops/fast.py`).

The segment test runs densely on every pixel from 16 shifted views, a
bitmask of ring predicates and a doubled-mask arc test. Selection keeps the
best corners per grid cell, then the global best by a log2-quantized
response tier with a spatial tie-break. Ties in both selections go to the
lower index (`jax.lax.top_k`'s rule), which a stable descending sort gives.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device

# Bresenham circle of radius 3 (dx, dy), the FAST-16 ring, clockwise.
FAST_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    np.int32,
)
RING_5_8 = np.array(
    [(0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1)],
    np.int32,
)
RING_7_12 = np.array(
    [
        (0, -2), (1, -2), (2, -1), (2, 0), (2, 1), (1, 2),
        (0, 2), (-1, 2), (-2, 1), (-2, 0), (-2, -1), (-1, -2),
    ],
    np.int32,
)
# pattern -> (ring, arc): 0 = AGAST_5_8, 1 = AGAST_7_12s, 2 = OAST_9_16 (FAST-9)
RING_ARC = {0: (RING_5_8, 5), 1: (RING_7_12, 7), 2: (FAST_RING, 9)}


def _ring_views(img: torch.Tensor, ring: np.ndarray) -> torch.Tensor:
    """out[i, c, y, x] = img[c, y + dy_i, x + dx_i], wrapping at borders."""
    views = [torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(1, 2)) for dx, dy in ring]
    return torch.stack(views, dim=0)


def _has_arc(bits: torch.Tensor, n_ring: int, arc: int) -> torch.Tensor:
    """True where the low n_ring bits hold a circular run of >= arc set bits."""
    m = bits | (bits << n_ring)
    r = m
    for i in range(1, arc):
        r = r & (m >> i)
    return (r & ((1 << n_ring) - 1)) != 0


def fast_corners(img: torch.Tensor, threshold: float, pattern: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-test corners on [C, H, W] float images. Returns (is_corner
    [C, H, W] bool, score [C, H, W] f32), score being the larger of the
    bright and dark sums of |ring - center| - threshold over passing pixels."""
    ring_tab, arc = RING_ARC[int(pattern)]
    n_ring = len(ring_tab)
    ring = _ring_views(img, ring_tab)
    center = img[None]
    bright = ring > center + threshold
    dark = ring < center - threshold
    wb = (1 << torch.arange(n_ring, dtype=torch.int32, device=img.device)).reshape(n_ring, 1, 1, 1)
    bright_bits = torch.sum(bright.to(torch.int32) * wb, dim=0, dtype=torch.int32)
    dark_bits = torch.sum(dark.to(torch.int32) * wb, dim=0, dtype=torch.int32)
    is_corner = _has_arc(bright_bits, n_ring, arc) | _has_arc(dark_bits, n_ring, arc)
    diff = torch.abs(ring - center) - threshold
    score_b = torch.sum(torch.where(bright, diff, 0.0), dim=0)
    score_d = torch.sum(torch.where(dark, diff, 0.0), dim=0)
    return is_corner, torch.maximum(score_b, score_d)


def border_mask(h: int, w: int, border: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    m = torch.zeros((h, w), dtype=torch.bool, device=resolve_device(device))
    if h > 2 * border and w > 2 * border:
        m[border : h - border, border : w - border] = True
    return m


def _topk_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_topk_grid(
    score: torch.Tensor,
    valid: torch.Tensor,
    k_total: int,
    cell: Optional[int] = None,
    k_per_cell: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spatially uniform top-k: keep the k_per_cell best per cell x cell tile,
    then the k_total best by response tier (floor(log2)) with a spatial
    tie-break. score [C, H, W] (-inf where invalid), valid [C, H, W] bool.
    Returns (uv [C, k_total, 2] int32, resp [C, k_total], ok [C, k_total])."""
    C, H, W = score.shape
    if cell is None:
        cell = 32
        usable = 0.785  # share of cells inside the fisheye mirror circle
        while cell > 4 and (H // cell) * (W // cell) * usable < 2 * k_total:
            cell //= 2
    if k_per_cell is None:
        n_cells = max((H // cell) * (W // cell), 1)
        k_per_cell = max(2, -(-2 * k_total // n_cells))
    neg_inf = -float("inf")
    s = torch.where(valid, score, neg_inf)
    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    s = torch.nn.functional.pad(s, (0, Wp - W, 0, Hp - H), value=-float("inf"))
    gh, gw = Hp // cell, Wp // cell
    tiles = s.reshape(C, gh, cell, gw, cell).permute(0, 1, 3, 2, 4).reshape(C, gh, gw, cell * cell)
    if k_per_cell == 1:
        cell_scores, cell_idx = torch.max(tiles, dim=-1, keepdim=True)
    else:
        cell_scores, cell_idx = _topk_first(tiles, k_per_cell)
    iy = cell_idx // cell
    ix = cell_idx % cell
    dev = score.device
    base_y = (torch.arange(gh, device=dev) * cell)[None, :, None, None]
    base_x = (torch.arange(gw, device=dev) * cell)[None, None, :, None]
    abs_y = (iy + base_y).reshape(C, -1)
    abs_x = (ix + base_x).reshape(C, -1)
    flat_scores = cell_scores.reshape(C, -1)
    n_slots = flat_scores.shape[1]
    k_eff = min(k_total, n_slots)
    qresp = torch.floor(torch.log2(torch.clamp_min(flat_scores, 1e-6)))
    spatial = torch.arange(n_slots, dtype=flat_scores.dtype, device=dev) / n_slots
    key = torch.where(torch.isfinite(flat_scores), qresp - spatial[None, :], neg_inf)
    top_key, top_i = _topk_first(key, k_eff)
    top_scores = torch.gather(flat_scores, 1, top_i)
    if k_eff < k_total:
        pad = k_total - k_eff
        top_key = torch.nn.functional.pad(top_key, (0, pad), value=-float("inf"))
        top_scores = torch.nn.functional.pad(top_scores, (0, pad), value=-float("inf"))
        top_i = torch.nn.functional.pad(top_i, (0, pad))
    uv = torch.stack([torch.gather(abs_x, 1, top_i), torch.gather(abs_y, 1, top_i)], dim=-1).to(torch.int32)
    ok = torch.isfinite(top_key)
    return uv, torch.where(ok, top_scores, torch.zeros_like(top_scores)), ok


def level_quota(n_features: int, n_levels: int, scale_factor: float) -> np.ndarray:
    """Per-level feature budget, geometric in 1/scale."""
    factor = 1.0 / scale_factor
    first = n_features * (1.0 - factor) / (1.0 - factor ** n_levels)
    quota = np.round(first * factor ** np.arange(n_levels)).astype(np.int32)
    quota[-1] = max(int(n_features - quota[:-1].sum()), 0)
    return quota
