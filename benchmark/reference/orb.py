"""Plain ORB extraction of a multi-camera frame, written from the
description of the system's extractor (MultiCol-SLAM's ORB path):

- pyramid: level l is level l-1 resized by 1 / scale_factor with an
  antialiased linear (triangle-kernel) resize, as two float32 matrix
  products of separable weights;
- a 5x5 normalized box blur with reflect-101 borders on every level;
- FAST-9/16 on the raw level (a circular run of at least 9 ring pixels all
  brighter than centre + th or all darker than centre - th; score the
  larger of the bright and the dark sums of |ring - centre| - th), 3x3
  non-maximum suppression (a pixel survives when no neighbour scores
  higher), a 19 px border and the level's mirror mask;
- grid selection: the best k_per_cell of each cell, then the level's quota
  by response tier floor(log2 score), ties to the lower (cell, rank) slot;
- intensity-centroid angle over the radius-15 disc of the blurred level,
  and steered BRIEF (256 pairs of a Gaussian pattern, seed 20160823, rounded
  half to even) on the blurred level, bits LSB first.

Plain torch, float32, on whichever device the image is. The pattern and
every weight are worked out here from their definitions.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.geometry import in_mirror

BORDER = 19
SAMPLE_R = 23        # half-size of the patch a keypoint's tests read
ANGLE_R = 15
PATTERN_SEED = 20160823
RING = [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)]


def quotas(n: int, levels: int, scale: float) -> list:
    """Features per level, geometric in 1 / scale, the rest to the last."""
    f = 1.0 / scale
    first = n * (1.0 - f) / (1.0 - f ** levels)
    q = [int(x) for x in np.round(first * f ** np.arange(levels)).astype(np.int32)]
    q[-1] = max(n - sum(q[:-1]), 0)
    return q


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of an antialiased linear resize: each
    output sample averages the inputs under a triangle kernel stretched by
    the downscale factor, normalized, zero outside [-0.5, n_in - 0.5]."""
    f = np.float32
    if n_in == n_out:
        return np.eye(n_in, dtype=f)
    inv = f(1.0 / (n_out / n_in))
    width = max(inv, f(1.0))
    centre = (np.arange(n_out, dtype=f) + f(0.5)) * inv - f(0.0) - f(0.5)
    w = np.maximum(f(0.0), f(1.0) - np.abs(np.abs(centre[None, :] - np.arange(n_in, dtype=f)[:, None]) / width))
    tot = np.sum(w, axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(f).eps), w / np.where(tot != 0, tot, f(1.0)), f(0.0))
    return np.where(((centre >= -0.5) & (centre <= n_in - 0.5))[None, :], w, f(0.0)).astype(f)


def pyramid(img: torch.Tensor, levels: int, scale: float) -> list:
    C, H, W = img.shape
    out = [img]
    for lvl in range(1, levels):
        s0, s1 = scale ** -(lvl - 1), scale ** -lvl
        h0, w0 = int(round(H * s0)), int(round(W * s0))
        h1, w1 = int(round(H * s1)), int(round(W * s1))
        wr = torch.from_numpy(resize_matrix(h0, h1)).to(img.device)
        wc = torch.from_numpy(resize_matrix(w0, w1)).to(img.device)
        out.append(torch.matmul(torch.matmul(wr.t(), out[-1]), wc))
    return out


def blur5(img: torch.Tensor) -> torch.Tensor:
    """5x5 box mean, reflect-101 borders, rows then columns, terms added in
    order."""
    H, W = img.shape[-2:]
    xp = F.pad(img, (2, 2), mode="reflect")
    acc = xp[..., 0:W] * 0.2
    for i in range(1, 5):
        acc = acc + xp[..., i:i + W] * 0.2
    yp = F.pad(acc.transpose(-1, -2), (2, 2), mode="reflect").transpose(-1, -2)
    out = yp[..., 0:H, :] * 0.2
    for i in range(1, 5):
        out = out + yp[..., i:i + H, :] * 0.2
    return out


def fast9(img: torch.Tensor, th: float):
    """(score [C, H, W] with -inf off corners). Ring pixels wrap at the
    borders, which the 19 px border masks off."""
    ring = torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(1, 2)) for dx, dy in RING])
    c = img[None]
    bright, dark = ring > c + th, ring < c - th
    corner = torch.zeros_like(img, dtype=torch.bool)
    for start in range(16):
        idx = [(start + k) % 16 for k in range(9)]
        corner |= bright[idx].all(0) | dark[idx].all(0)
    diff = torch.abs(ring - c) - th
    score = torch.maximum(torch.where(bright, diff, 0.0).sum(0), torch.where(dark, diff, 0.0).sum(0))
    return torch.where(corner, score, torch.full_like(score, -math.inf))


def select(score: torch.Tensor, valid: torch.Tensor, k: int):
    """Grid-uniform best k of each camera: (uv int64 [C, k, 2], score [C, k],
    ok [C, k])."""
    C, H, W = score.shape
    cell = 32
    while cell > 4 and (H // cell) * (W // cell) * 0.785 < 2 * k:
        cell //= 2
    kpc = max(2, -(-2 * k // max((H // cell) * (W // cell), 1)))
    s = torch.where(valid, score, torch.full_like(score, -math.inf))
    gh, gw = -(-H // cell), -(-W // cell)
    s = F.pad(s, (0, gw * cell - W, 0, gh * cell - H), value=-math.inf)
    tiles = s.reshape(C, gh, cell, gw, cell).permute(0, 1, 3, 2, 4).reshape(C, gh * gw, cell * cell)
    vals, idx = torch.sort(tiles, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :kpc], idx[..., :kpc]
    cell_id = torch.arange(gh * gw, device=score.device)[None, :, None]
    ys = (cell_id // gw) * cell + idx // cell
    xs = (cell_id % gw) * cell + idx % cell
    vals, ys, xs = vals.reshape(C, -1), ys.reshape(C, -1), xs.reshape(C, -1)
    n = vals.shape[1]
    tier = torch.floor(torch.log2(torch.clamp_min(vals, 1e-6)))
    out_uv = torch.zeros((C, k, 2), dtype=torch.int64, device=score.device)
    out_s = torch.zeros((C, k), dtype=score.dtype, device=score.device)
    out_ok = torch.zeros((C, k), dtype=torch.bool, device=score.device)
    slot = torch.arange(n, device=score.device)
    for c in range(C):
        fin = torch.isfinite(vals[c])
        # tier descending, then slot ascending
        order = np.lexsort((slot.cpu().numpy(), -tier[c].cpu().numpy()))
        order = torch.as_tensor(order, device=score.device)
        order = order[fin[order]][:k]
        m = len(order)
        out_uv[c, :m, 0], out_uv[c, :m, 1] = xs[c, order], ys[c, order]
        out_s[c, :m], out_ok[c, :m] = vals[c, order], True
    return out_uv, out_s, out_ok


def pattern(n_bits: int = 512) -> torch.Tensor:
    rng = np.random.default_rng(PATTERN_SEED)
    pts = np.clip(np.round(rng.normal(0.0, 31 / 5.0, size=(n_bits, 2))), -13, 13)
    return torch.from_numpy(pts.astype(np.int64))


def describe(blur: torch.Tensor, uv: torch.Tensor, pat: torch.Tensor):
    """(angle [C, k], desc [C, k, 32] uint8) of integer keypoints uv [C, k, 2]
    on the blurred level [C, H, W]. Reads clamp to a 47x47 patch placed
    inside the image around each keypoint."""
    C, H, W = blur.shape
    P = 2 * SAMPLE_R + 1
    u, v = uv[..., 0], uv[..., 1]
    r0 = torch.clamp(v - SAMPLE_R, 0, H - P)
    c0 = torch.clamp(u - SAMPLE_R, 0, W - P)
    flat = blur.reshape(C, H * W)

    def at(rows, cols):        # rows, cols relative to the patch origin [C, k, ...]
        rows, cols = torch.broadcast_tensors(rows, cols)
        extra = (1,) * (rows.dim() - 2)
        rows = torch.clamp(rows, 0, P - 1) + r0.reshape(C, -1, *extra)
        cols = torch.clamp(cols, 0, P - 1) + c0.reshape(C, -1, *extra)
        idx = (rows * W + cols).reshape(C, -1)
        return torch.gather(flat, 1, idx).reshape(rows.shape)

    Q = 2 * ANGLE_R + 1
    oy = torch.clamp(v - r0 - ANGLE_R, 0, P - Q)
    ox = torch.clamp(u - c0 - ANGLE_R, 0, P - Q)
    d = torch.arange(-ANGLE_R, ANGLE_R + 1, device=blur.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    disc = (dx * dx + dy * dy) <= ANGLE_R * ANGLE_R
    win = at(oy[..., None, None] + ANGLE_R + dy, ox[..., None, None] + ANGLE_R + dx)   # [C, k, Q, Q]
    m10 = torch.einsum("...ij,ij->...", win, (dx * disc).to(win.dtype))
    m01 = torch.einsum("...ij,ij->...", win, (dy * disc).to(win.dtype))
    ang = torch.atan2(m01, m10)
    ca, sa = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    px, py = pat[:, 0].to(blur.dtype).to(blur.device), pat[:, 1].to(blur.dtype).to(blur.device)
    ox_ = torch.round(px * ca - py * sa).long()
    oy_ = torch.round(px * sa + py * ca).long()
    vals = at(v[..., None] + oy_ - r0[..., None], u[..., None] + ox_ - c0[..., None])
    bits = (vals[..., 0::2] < vals[..., 1::2]).to(torch.int64)
    weights = 2 ** torch.arange(8, device=blur.device)
    desc = (bits.reshape(C, uv.shape[1], -1, 8) * weights).sum(-1).to(torch.uint8)
    return ang, desc


def extract(images: torch.Tensor, spec: dict, pp: torch.Tensor, wh: torch.Tensor):
    """ORB features of [C, H, W] uint8 images: dict of uv [C, K, 2] level-0
    pixels, octave [C, K], response [C, K], angle [C, K], desc [C, K, 32],
    valid [C, K]; levels in order, each its quota's slots."""
    img = images.to(torch.float32)
    levels, scale, th = int(spec["n_levels"]), float(spec["scale_factor"]), float(spec["fast_th"])
    pat = pattern(2 * 8 * int(spec["desc_size"]))
    parts = []
    for lvl, (lev, q) in enumerate(zip(pyramid(img, levels, scale), quotas(int(spec["n_features"]), levels, scale))):
        C, h, w = lev.shape
        score = fast9(lev, th)
        nms = score >= F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
        border = torch.zeros((h, w), dtype=torch.bool, device=lev.device)
        if h > 2 * BORDER and w > 2 * BORDER:
            border[BORDER:h - BORDER, BORDER:w - BORDER] = True
        yy, xx = torch.meshgrid(torch.arange(h, device=lev.device, dtype=torch.float32),
                                torch.arange(w, device=lev.device, dtype=torch.float32), indexing="ij")
        grid = torch.stack([xx, yy], -1)[None]
        mirror = in_mirror(pp[:, None, None, :], wh[:, None, None, :], grid, scale ** (-lvl))
        valid = nms & border[None] & mirror & torch.isfinite(score)
        uv, resp, ok = select(score, valid, q)
        ang, desc = describe(blur5(lev), uv, pat)
        parts.append(dict(uv=uv.to(torch.float32) * (scale ** lvl), octave=torch.full_like(resp, lvl).to(torch.int32),
                          response=resp, angle=ang, desc=desc, valid=ok))
    return {k: torch.cat([p[k] for p in parts], 1) for k in parts[0]}
