"""Binary descriptors: steered BRIEF (ORB), dBRIEF and mdBRIEF, and
intensity-centroid angles (port of `multicol_slam_tpu/ops/brief.py`).

One [P, P] patch per keypoint (P = 2 * SAMPLE_RADIUS + 1) is gathered once
and feeds both the IC-angle moments and the descriptor tests. Each sample
is a direct gather from that patch (the reference's one-hot contraction is
a TPU device for the same values).

dBRIEF (mdBRIEFextractorOct.cpp:356-407) rotates the pattern in the
undistorted image plane around the undistorted keypoint, pushes it through
the omni model at the plane z = -a0, centres it on its mean and rounds.
mdBRIEF (:410-554) adds a stability mask: a bit is kept where the tests
under the pattern turned by +-20 degrees agree with the unturned one.
Every function takes leading batch axes (the rig's cameras); the camera
parameters carry the same leading axes without the keypoint axis.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from multicol_slam_tpu_torch.ops.image import gather_patches

HALF_PATCH = 15          # IC-angle patch radius
PATCH_SIZE = 31
PATTERN_SEED = 20160823  # the reference's pattern seed: descriptors stay bit-compatible
SAMPLE_RADIUS = 23
# the mdBRIEF perturbation, the float32 product the reference's
# jnp.deg2rad(20.0) gives
MASK_ROTATION = float(np.float32(20.0) * np.float32(np.pi / 180.0))


@functools.lru_cache(maxsize=None)
def brief_pattern(n_bits: int = 512) -> np.ndarray:
    """[n_bits, 2] int32 test locations in [-13, 13] (Gaussian, sigma =
    PATCH_SIZE / 5); consecutive entries form the pair of one bit."""
    rng = np.random.default_rng(PATTERN_SEED)
    sigma = PATCH_SIZE / 5.0
    pts = np.clip(np.round(rng.normal(0.0, sigma, size=(n_bits, 2))), -(HALF_PATCH - 2), HALF_PATCH - 2)
    return pts.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ic_angle_weights() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(wx, wy, mask) over a 31x31 window, radius-15 circle."""
    d = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    xx, yy = np.meshgrid(d, d)
    mask = (xx ** 2 + yy ** 2) <= HALF_PATCH ** 2
    return (xx * mask).astype(np.float32), (yy * mask).astype(np.float32), mask


def gather_sample_patches(img: torch.Tensor, centers: torch.Tensor):
    """Sample patches [..., K, P, P] and their origins (r0, c0) [..., K].
    img [..., H, W]; centers [..., K, 2] int (u, v)."""
    H, W = img.shape[-2:]
    R = SAMPLE_RADIUS
    P = 2 * R + 1
    patches = gather_patches(img, centers, R)
    r0 = torch.clamp(centers[..., 1] - R, 0, max(H - P, 0))
    c0 = torch.clamp(centers[..., 0] - R, 0, max(W - P, 0))
    return patches, r0, c0


def ic_angles(img: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (IC_Angle, mdBRIEFextractorOct.cpp:221-247):
    atan2(m01, m10) over the radius-15 circle around each keypoint, the
    31x31 window clamped to the image. img [..., H, W] (H, W >= 47);
    centers [..., K, 2] int (u, v) -> [..., K] radians."""
    patches, r0, c0 = gather_sample_patches(img, centers)
    return ic_angles_from_patches(patches, centers, r0, c0)


def ic_angles_dense(imgs: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """`ic_angles` of every camera: imgs [C, H, W], centers [C, K, 2] ->
    [C, K]. The reference computes it as a convolution with zero padding
    (a TPU device); the values agree with ic_angles but for keypoints within
    15 px of the border, which the detector's 19 px border excludes; here
    the window is clamped there, as ic_angles clamps it."""
    return ic_angles(imgs, centers)


def ic_angles_from_patches(patches, centers, r0, c0, wx: Optional[torch.Tensor] = None,
                           wy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """atan2(m01, m10) over the 31x31 window around each keypoint inside its
    sample patch (window clamped to the patch). wx, wy: `_ic_angle_weights`
    (made here when not given; the extractor passes its cached tables)."""
    if wx is None or wy is None:
        wx, wy, _ = (torch.as_tensor(a, device=patches.device) for a in _ic_angle_weights())
    P = patches.shape[-1]
    Q = 2 * HALF_PATCH + 1
    oy = torch.clamp(centers[..., 1] - r0 - HALF_PATCH, 0, P - Q)
    ox = torch.clamp(centers[..., 0] - c0 - HALF_PATCH, 0, P - Q)
    win = gather_patches(patches, torch.stack([ox, oy], -1)[..., None, :] + HALF_PATCH, HALF_PATCH)
    win = win[..., 0, :, :]                                       # [..., K, Q, Q]
    m10 = torch.einsum("...ij,ij->...", win, wx)
    m01 = torch.einsum("...ij,ij->...", win, wy)
    return torch.atan2(m01, m10)


def _sample_patches(patches, centers, offsets, r0, c0) -> torch.Tensor:
    """Values at centers[k] + offsets[k, s] inside the pre-gathered patches
    (clamped to the patch). offsets [..., K, S, 2] -> [..., K, S]."""
    P = patches.shape[-1]
    rows = torch.clamp(centers[..., None, 1] + offsets[..., 1] - r0[..., None], 0, P - 1)
    cols = torch.clamp(centers[..., None, 0] + offsets[..., 0] - c0[..., None], 0, P - 1)
    flat = patches.reshape(*patches.shape[:-2], P * P)
    return torch.gather(flat, -1, (rows * P + cols).long())


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 8B] bool -> [..., B] uint8, LSB first in each byte."""
    nb = bits.shape[-1]
    w = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    packed = (bits.reshape(*bits.shape[:-1], nb // 8, 8).to(torch.int32) * w).sum(-1)
    return packed.to(torch.uint8)


def _rotated_offsets(pattern: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate integer pattern [S, 2] by angles [..., K] -> [..., K, S, 2]
    int32, rounded half to even: (x ca - y sa, x sa + y ca)."""
    ca, sa = torch.cos(angles)[..., None], torch.sin(angles)[..., None]
    x, y = pattern[:, 0].to(torch.float32), pattern[:, 1].to(torch.float32)
    xr = x * ca - y * sa
    yr = x * sa + y * ca
    return torch.stack([torch.round(xr), torch.round(yr)], dim=-1).to(torch.int32)


def _pattern_of(desc_bytes: int, pattern: Optional[torch.Tensor], device) -> torch.Tensor:
    """`pattern`, or the [16 B, 2] table `brief_pattern(16 B)` of B =
    desc_bytes on `device`."""
    if pattern is not None:
        return pattern
    return torch.as_tensor(brief_pattern(2 * 8 * desc_bytes), device=device)


def compute_orb_from_patches(patches, centers, r0, c0, angles, desc_bytes: int = 32,
                             pattern: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ORB descriptors [..., K, B] uint8, B = desc_bytes; bit i is t0 < t1 of
    pair i of the rotated `pattern` ([16 B, 2] int32, `brief_pattern(16 B)`,
    made here when not given; the extractor passes its cached table)."""
    pattern = _pattern_of(desc_bytes, pattern, patches.device)
    return _pack_bits(_tests(patches, centers, _rotated_offsets(pattern, angles), r0, c0))


def compute_orb(img: torch.Tensor, centers: torch.Tensor, angles: torch.Tensor, desc_bytes: int = 32) -> torch.Tensor:
    """Steered BRIEF (ORB) on one (blurred) level image: img [..., H, W];
    centers [..., K, 2] int; angles [..., K] -> [..., K, desc_bytes] uint8."""
    patches, r0, c0 = gather_sample_patches(img, centers)
    return compute_orb_from_patches(patches, centers, r0, c0, angles, desc_bytes)


def undistort_keypoints(pol, cde, pp, a0, uv_level0: torch.Tensor) -> torch.Tensor:
    """undistortPointsOcam with scale factor a0 (cam_model_omni.h:129-140,
    scaleF = pol[0], mdBRIEFextractorOct.cpp:1288): unproject to a ray (x, y,
    z) and return (-x / z, -y / z) * a0. uv [..., K, 2] -> [..., K, 2]; pol,
    cde, pp [..., D] and a0 [...] without the keypoint axis."""
    from multicol_slam_tpu_torch.models.camera import img_to_world

    ray = img_to_world(pol[..., None, :], cde[..., None, :], pp[..., None, :], uv_level0)
    a0 = a0[..., None]
    return torch.stack([-ray[..., 0] / ray[..., 2] * a0, -ray[..., 1] / ray[..., 2] * a0], dim=-1)


def _distorted_offsets(pattern, undist_kp, angles, invpol, cde, pp, a0) -> torch.Tensor:
    """The dBRIEF pattern (rotateAndDistortPattern, mdBRIEFextractorOct.cpp:
    250-283): `pattern` [S, 2] rotated by angles [..., K] around the
    undistorted keypoints [..., K, 2], projected through the omni model at
    the plane z = -a0, less its mean over the pattern, rounded half to even.
    Returns [..., K, S, 2] int32."""
    from multicol_slam_tpu_torch.models.camera import world_to_img

    ca, sa = torch.cos(angles)[..., None], torch.sin(angles)[..., None]
    x, y = pattern[:, 0].to(torch.float32), pattern[:, 1].to(torch.float32)
    xr = x * ca - y * sa + undist_kp[..., 0:1]
    yr = x * sa + y * ca + undist_kp[..., 1:2]
    plane = torch.stack([xr, yr, (-a0)[..., None, None].expand_as(xr)], dim=-1)
    uv = world_to_img(invpol[..., None, None, :], cde[..., None, None, :], pp[..., None, None, :], plane)
    uv = uv - uv.mean(dim=-2, keepdim=True)
    return torch.round(uv).to(torch.int32)


def _tests(patches, centers, offsets, r0, c0) -> torch.Tensor:
    """The binary tests t0 < t1 of each pattern pair: [..., K, S / 2] bool."""
    vals = _sample_patches(patches, centers, offsets, r0, c0)
    return vals[..., 0::2] < vals[..., 1::2]


def compute_dbrief_from_patches(patches, centers, r0, c0, undist_kp, angles, invpol, cde, pp, a0,
                                desc_bytes: int = 32, learn_masks: bool = False,
                                pattern: Optional[torch.Tensor] = None):
    """dBRIEF descriptors and, with learn_masks, the mdBRIEF stability masks:
    (desc [..., K, B] u8, mask [..., K, B] u8), B = desc_bytes. Without
    masks every mask is 0xFF, so that the masked distance is uniform.
    `pattern`: [16 B, 2] int32, `brief_pattern(16 B)` (made here when not
    given; the extractor passes its cached table)."""
    pattern = _pattern_of(desc_bytes, pattern, patches.device)
    bits = _tests(patches, centers, _distorted_offsets(pattern, undist_kp, angles, invpol, cde, pp, a0), r0, c0)
    desc = _pack_bits(bits)
    if not learn_masks:
        return desc, torch.full_like(desc, 255)
    stable = torch.ones_like(bits)
    for delta in (MASK_ROTATION, -MASK_ROTATION):   # float32 values: the sums round as the reference's
        offs = _distorted_offsets(pattern, undist_kp, angles + delta, invpol, cde, pp, a0)
        stable = stable & (_tests(patches, centers, offs, r0, c0) == bits)
    return desc, _pack_bits(stable)


def compute_dbrief(img, centers, undist_kp, angles, invpol, cde, pp, a0, desc_bytes: int = 32,
                   learn_masks: bool = False, pattern: Optional[torch.Tensor] = None):
    """dBRIEF / mdBRIEF of keypoints `centers` [..., K, 2] on the (blurred)
    level image img [..., H, W]: `compute_dbrief_from_patches` on patches
    gathered here."""
    patches, r0, c0 = gather_sample_patches(img, centers)
    return compute_dbrief_from_patches(patches, centers, r0, c0, undist_kp, angles, invpol, cde, pp, a0,
                                       desc_bytes, learn_masks, pattern)
