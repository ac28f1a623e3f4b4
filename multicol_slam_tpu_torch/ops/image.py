"""Image ops for the feature pipeline: pyramid, box filter, 3x3 max filter,
patch gather (port of `multicol_slam_tpu/ops/image.py`).

The reference resizes with `jax.image.resize(..., "linear")`, whose default
is antialiased: each output sample is a triangle-kernel average whose width
grows with the downscale factor. `resize_weights` rebuilds JAX's weight
matrices in float32 numpy, and `build_pyramid` applies them as two float32
matrix products (`torch.nn.functional.interpolate` differs: without
antialiasing it is off by tens of grey levels).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> List[Tuple[int, int]]:
    """Per-level (h, w): level l is scaled by 1/scale_factor^l (rounded)."""
    shapes = []
    for lvl in range(n_levels):
        s = 1.0 / (scale_factor ** lvl)
        shapes.append((int(round(h * s)), int(round(w * s))))
    return shapes


def scale_factors(n_levels: int, scale_factor: float) -> np.ndarray:
    """mvScaleFactor: [1, s, s^2, ...] (mdBRIEFextractorOct.cpp:156)."""
    return scale_factor ** np.arange(n_levels)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of JAX's antialiased linear resize
    along one axis (jax._src.image.scale.compute_weight_mat, triangle kernel,
    float32 throughout)."""
    f32 = np.float32
    if in_size == out_size:
        return np.eye(in_size, dtype=f32)
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def pyramid_weights(h: int, w: int, n_levels: int, scale_factor: float):
    """Per level l >= 1: (rows [h_{l-1}, h_l], cols [w_{l-1}, w_l]) numpy
    weights of the cascade level l-1 -> l."""
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    return [
        (resize_weights(h0, h1), resize_weights(w0, w1))
        for (h0, w0), (h1, w1) in zip(shapes[:-1], shapes[1:])
    ]


def build_pyramid(
    img: torch.Tensor,
    n_levels: int,
    scale_factor: float,
    weights: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> List[torch.Tensor]:
    """[C, H, W] float32 -> list of [C, h_l, w_l], each level resized from the
    previous one. `weights` are `pyramid_weights` as tensors on img's device
    (built here when not given)."""
    if img.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("build_pyramid needs float32 matmuls: set "
                         "torch.backends.cuda.matmul.allow_tf32 = False")
    C, H, W = img.shape
    if weights is None:
        weights = [
            (torch.from_numpy(a).to(img.device), torch.from_numpy(b).to(img.device))
            for a, b in pyramid_weights(H, W, n_levels, scale_factor)
        ]
    out = [img]
    for wr, wc in weights:
        out.append(torch.matmul(torch.matmul(wr.t(), out[-1]), wc))
    return out


def box_filter(img: torch.Tensor, size: int = 5) -> torch.Tensor:
    """Normalized size x size box blur with reflect-101 borders, separable:
    a horizontal then a vertical pass of shifted adds (no cuDNN, so no TF32).
    img [C, H, W]."""
    k = 1.0 / size
    p = size // 2
    H, W = img.shape[-2:]
    xp = F.pad(img, (p, p), mode="reflect")
    out = xp[..., 0:W] * k
    for i in range(1, size):
        out = out + xp[..., i : i + W] * k
    yp = F.pad(out.transpose(-1, -2), (p, p), mode="reflect").transpose(-1, -2)
    res = yp[..., 0:H, :] * k
    for i in range(1, size):
        res = res + yp[..., i : i + H, :] * k
    return res


def max_pool_3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 max filter (-inf outside) for non-maximum suppression, [C, H, W]."""
    return F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]


def gather_patches(img: torch.Tensor, centers: torch.Tensor, radius: int) -> torch.Tensor:
    """Square patches around integer centers, the whole window clamped to stay
    inside the image. img [..., H, W]; centers [..., K, 2] (u col, v row) ->
    [..., K, P, P] with P = 2 * radius + 1."""
    H, W = img.shape[-2:]
    P = 2 * radius + 1
    r0 = torch.clamp(centers[..., 1] - radius, 0, max(H - P, 0))
    c0 = torch.clamp(centers[..., 0] - radius, 0, max(W - P, 0))
    ar = torch.arange(P, device=img.device, dtype=centers.dtype)
    rows = r0[..., None] + ar
    cols = c0[..., None] + ar
    idx = (rows[..., :, None] * W + cols[..., None, :]).long()         # [..., K, P, P]
    K = centers.shape[-2]
    flat = img.reshape(*img.shape[:-2], H * W)
    out = torch.gather(flat, -1, idx.reshape(*idx.shape[:-3], K * P * P))
    return out.reshape(*idx.shape)
