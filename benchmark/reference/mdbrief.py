"""Plain mdBRIEF extraction of a multi-camera frame: dBRIEF descriptors with
online-learned stability masks, written from mdBRIEF's description (Urban &
Hinz 2016) and its reference code, mdBRIEFextractorOct.cpp:250-283
(rotateAndDistortPattern), :356-407 (dBRIEF) and :410-554 (the masks).

Detection is the ORB reference's (benchmark/reference/orb.py, by import):
the pyramid, the 5x5 blur, FAST-9 with 3x3 non-maximum suppression, the
19 px border, the mirror mask, the grid selection and the intensity-centroid
angle on the blurred level. The descriptor of a keypoint at level-0 pixel
(u, v):

- undistort it: unproject (u, v) through the camera's `pol` to the unit ray
  (x, y, z) and take (-x / z, -y / z) a0, with a0 = pol[0] (the reference's
  undistortPointsOcam with scaleF = pol[0], cam_model_omni.h:129-140);
- rotate the 512-point test pattern (orb.py's, seed 20160823) by the IC
  angle around the undistorted keypoint in the plane z = -a0, project every
  point through `invpol`, subtract the mean of the projected pattern and
  round half to even: integer pixel offsets, applied at the keypoint of its
  level;
- bit i is t0 < t1 of pair i on the blurred level, bits LSB first;
- the mask keeps bit i where the tests under the pattern turned by +20 and
  by -20 degrees (the float32 value of 20 degrees in radians) both equal
  the unturned test.

Departures from the reference code, all shared with the system under test:
the samples read the blurred level directly at integer offsets (the
reference reads its own blurred copy the same way), a sample is clamped to
the 47x47 patch placed inside the image around the keypoint, and the masks
are learned per keypoint, from its own turned patterns, as the reference's
"online" variant does for one frame. Plain torch, float32, on whichever
device the image is.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import orb
from benchmark.reference.geometry import in_mirror, poly, project

# the mask's perturbation: 20 degrees in radians, a float32 product
MASK_ROTATION = float(np.float32(20.0) * np.float32(np.pi / 180.0))


def undistort(pol: torch.Tensor, cde: torch.Tensor, pp: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Level-0 pixels uv [C, K, 2] of cameras with pol [C, D], cde [C, 3], pp
    [C, 2] -> [C, K, 2]: the unit ray's (-x / z, -y / z) times a0 = pol[0]."""
    c, d, e = cde[:, None, 0], cde[:, None, 1], cde[:, None, 2]
    ut, vt = uv[..., 0] - pp[:, None, 0], uv[..., 1] - pp[:, None, 1]
    det = c - d * e
    x = (ut - d * vt) / det
    y = (-e * ut + c * vt) / det
    z = -poly(pol[:, None, :], torch.sqrt(x * x + y * y))
    n = torch.sqrt(x * x + y * y + z * z)
    x, y, z = x / n, y / n, z / n
    a0 = pol[:, None, 0]
    return torch.stack([-x / z * a0, -y / z * a0], -1)


def offsets(pat: torch.Tensor, kp: torch.Tensor, ang: torch.Tensor, invpol: torch.Tensor, cde: torch.Tensor,
            pp: torch.Tensor, a0: torch.Tensor) -> torch.Tensor:
    """The distorted pattern [C, K, S, 2] int64: pat [S, 2] turned by ang
    [C, K] around the undistorted keypoints kp [C, K, 2] in the plane z =
    -a0, projected, less its mean over the pattern, rounded half to even."""
    ca, sa = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    px, py = pat[:, 0].to(kp.dtype), pat[:, 1].to(kp.dtype)
    xr = px * ca - py * sa + kp[..., 0:1]
    yr = px * sa + py * ca + kp[..., 1:2]
    plane = torch.stack([xr, yr, (-a0)[:, None, None].expand_as(xr)], -1)
    uv = project(invpol[:, None, None, :], cde[:, None, None, :], pp[:, None, None, :], plane)
    uv = uv - uv.mean(dim=-2, keepdim=True)
    return torch.round(uv).long()


def tests(blur: torch.Tensor, uv: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """t0 < t1 of each pair [C, K, S / 2] at the integer keypoints uv [C, K,
    2] of the blurred level [C, H, W], each sample clamped to the 47x47
    patch placed inside the image around its keypoint."""
    C, H, W = blur.shape
    P = 2 * orb.SAMPLE_R + 1
    u, v = uv[..., 0:1], uv[..., 1:2]
    r0 = torch.clamp(v - orb.SAMPLE_R, 0, H - P)
    c0 = torch.clamp(u - orb.SAMPLE_R, 0, W - P)
    rows = torch.clamp(v + offs[..., 1] - r0, 0, P - 1) + r0
    cols = torch.clamp(u + offs[..., 0] - c0, 0, P - 1) + c0
    vals = torch.gather(blur.reshape(C, H * W), 1, (rows * W + cols).reshape(C, -1)).reshape(rows.shape)
    return vals[..., 0::2] < vals[..., 1::2]


def pack(bits: torch.Tensor) -> torch.Tensor:
    """[C, K, 8 B] bool -> [C, K, B] uint8, LSB first."""
    weights = 2 ** torch.arange(8, device=bits.device)
    return (bits.to(torch.int64).reshape(*bits.shape[:-1], -1, 8) * weights).sum(-1).to(torch.uint8)


def describe(blur: torch.Tensor, uv: torch.Tensor, uv0: torch.Tensor, ang: torch.Tensor, pat: torch.Tensor,
             rig) -> tuple:
    """(desc, mask) [C, K, B] uint8 of the keypoints uv [C, K, 2] (level
    pixels; uv0 the level-0 ones) at IC angles ang [C, K]."""
    a0 = rig.pol[:, 0]
    kp = undistort(rig.pol, rig.cde, rig.pp, uv0)
    bits = tests(blur, uv, offsets(pat, kp, ang, rig.invpol, rig.cde, rig.pp, a0))
    stable = torch.ones_like(bits)
    for delta in (MASK_ROTATION, -MASK_ROTATION):
        stable &= tests(blur, uv, offsets(pat, kp, ang + delta, rig.invpol, rig.cde, rig.pp, a0)) == bits
    return pack(bits), pack(stable)


def extract(images: torch.Tensor, spec: dict, rig):
    """mdBRIEF features of [C, H, W] uint8 images with the cameras of `rig`
    (benchmark/reference/geometry.Rig): dict of uv [C, K, 2] level-0 pixels,
    octave [C, K], response [C, K], angle [C, K], desc [C, K, B], dmask
    [C, K, B], valid [C, K]; levels in order, each its quota's slots."""
    img = images.to(torch.float32)
    levels, scale, th = int(spec["n_levels"]), float(spec["scale_factor"]), float(spec["fast_th"])
    pat = orb.pattern(2 * 8 * int(spec["desc_size"])).to(img.device)
    parts = []
    for lvl, (lev, q) in enumerate(zip(orb.pyramid(img, levels, scale),
                                       orb.quotas(int(spec["n_features"]), levels, scale))):
        C, h, w = lev.shape
        score = orb.fast9(lev, th)
        nms = score >= F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
        border = torch.zeros((h, w), dtype=torch.bool, device=lev.device)
        if h > 2 * orb.BORDER and w > 2 * orb.BORDER:
            border[orb.BORDER:h - orb.BORDER, orb.BORDER:w - orb.BORDER] = True
        yy, xx = torch.meshgrid(torch.arange(h, device=lev.device, dtype=torch.float32),
                                torch.arange(w, device=lev.device, dtype=torch.float32), indexing="ij")
        grid = torch.stack([xx, yy], -1)[None]
        mirror = in_mirror(rig.pp[:, None, None, :], rig.wh[:, None, None, :], grid, scale ** (-lvl))
        uv, resp, ok = orb.select(score, nms & border[None] & mirror & torch.isfinite(score), q)
        blur = orb.blur5(lev)
        ang, _ = orb.describe(blur, uv, pat)           # the IC angle; its ORB bits are not used
        uv0 = uv.to(torch.float32) * (scale ** lvl)
        desc, mask = describe(blur, uv, uv0, ang, pat, rig)
        parts.append(dict(uv=uv0, octave=torch.full_like(resp, lvl).to(torch.int32), response=resp, angle=ang,
                          desc=desc, dmask=mask, valid=ok))
    return {k: torch.cat([p[k] for p in parts], 1) for k in parts[0]}
