"""Per-frame multi-camera feature extraction (port of
`multicol_slam_tpu/slam/features.py`).

All cameras go through each step together, the camera axis being a tensor
dimension: pyramid, box blur, dense FAST with 3x3 NMS, grid top-K, IC angles,
descriptors (ORB, or with `use_mdbrief` dBRIEF, and mdBRIEF's stability
masks with `learn_masks`), unit rays. The output is a fixed-capacity
`FrameFeatures`, K = n_features slots per camera with a validity mask.
`downselect_features` reduces a frame of the bootstrap's init bank (2x
features at FAST threshold 5) to the runtime capacity, on the host.

With the tracer on (utils/tracing.py), each level's IC angles and
descriptors run under a `features.describe` span, with the counters level,
keypoints (valid slots) and mask_bits_kept (the share of set mask bits over
them).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from multicol_slam_tpu_torch.models.camera import OmniCamera, img_to_world, mirror_mask_grid
from multicol_slam_tpu_torch.ops import brief as brief_ops
from multicol_slam_tpu_torch.ops import fast as fast_ops
from multicol_slam_tpu_torch.ops import image as image_ops
from multicol_slam_tpu_torch.utils import tracing
from multicol_slam_tpu_torch.utils.config import ExtractorSettings

EDGE_BORDER = 19  # detection border (keypoint patch safety)

# Version of the descriptor pipeline, recorded in map checkpoints
# (io/checkpoint.py): descriptors extracted under another version do not
# match a saved map's bit for bit, and relocalization into it degrades.
#   v1: IC angles from the raw pyramid level
#   v2: IC angles and descriptors both from the blurred level
DESC_PIPELINE_VERSION = 2


@dataclasses.dataclass
class FrameFeatures:
    """All features of one multi-camera frame, padded to [C, K].

    uv [C, K, 2] f32 level-0 pixels; response [C, K] f32; octave [C, K] i32;
    angle [C, K] f32 radians; rays [C, K, 3] f32 unit rays; desc [C, K, B] u8;
    dmask [C, K, B] u8 mdBRIEF stability masks (0xFF unless learn_masks);
    valid [C, K] bool.
    """

    uv: torch.Tensor
    response: torch.Tensor
    octave: torch.Tensor
    angle: torch.Tensor
    rays: torch.Tensor
    desc: torch.Tensor
    dmask: torch.Tensor
    valid: torch.Tensor

    @property
    def n_cams(self) -> int:
        return self.uv.shape[0]

    @property
    def k(self) -> int:
        return self.uv.shape[1]


class ExtractorTables(nn.Module):
    """Constant tables of the extractor for one image size, as buffers: the
    BRIEF pattern (ORB and dBRIEF share it), the IC-angle weights and the
    pyramid's resize matrices."""

    def __init__(self, settings: ExtractorSettings, height: int, width: int, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        self.settings = settings
        self.height, self.width = height, width
        self.register_buffer("pattern", torch.from_numpy(
            brief_ops.brief_pattern(2 * 8 * settings.desc_size)).to(device))
        wx, wy, _ = brief_ops._ic_angle_weights()
        self.register_buffer("ic_wx", torch.from_numpy(wx).to(device))
        self.register_buffer("ic_wy", torch.from_numpy(wy).to(device))
        weights = image_ops.pyramid_weights(height, width, settings.n_levels, settings.scale_factor)
        for lvl, (wr, wc) in enumerate(weights, start=1):
            self.register_buffer(f"resize_rows_{lvl}", torch.from_numpy(wr).to(device))
            self.register_buffer(f"resize_cols_{lvl}", torch.from_numpy(wc).to(device))

    def resize_weights(self):
        return [
            (getattr(self, f"resize_rows_{lvl}"), getattr(self, f"resize_cols_{lvl}"))
            for lvl in range(1, self.settings.n_levels)
        ]


def _extract_level(level_img, blurred, cams: OmniCamera, settings: ExtractorSettings,
                   tables: ExtractorTables, level: int, quota: int, fast_th: float):
    """Detect on the raw level, describe on the blurred one, for all cameras.
    Returns per-level (uv0, resp, octave, angle, desc, dmask, ok) of [C, quota, ...]."""
    C, h, w = level_img.shape
    pattern = settings.fast_agast_type if settings.use_agast else 2
    is_corner, score = fast_ops.fast_corners(level_img, fast_th, pattern=pattern)
    score = torch.where(is_corner, score, -float("inf"))
    nms = score >= image_ops.max_pool_3x3(score)
    bmask = fast_ops.border_mask(h, w, EDGE_BORDER, device=score.device)[None]
    mmask = mirror_mask_grid(cams, h, w, scale=settings.scale_factor ** (-level))
    valid = nms & bmask & mmask & torch.isfinite(score)
    uv_l, resp, ok = fast_ops.select_topk_grid(score, valid, quota)
    uv0 = uv_l.to(torch.float32) * (settings.scale_factor ** level)
    with tracing.span("features.describe") as sp:
        patches, r0, c0 = brief_ops.gather_sample_patches(blurred, uv_l)
        ang = brief_ops.ic_angles_from_patches(patches, uv_l, r0, c0, tables.ic_wx, tables.ic_wy)
        if settings.use_mdbrief:
            # the pattern turns around the keypoint undistorted at level-0
            # pixels with each camera's scale factor a0 = pol[0]
            a0 = cams.pol[:, 0]
            undist = brief_ops.undistort_keypoints(cams.pol, cams.cde, cams.pp, a0, uv0)
            desc, dmask = brief_ops.compute_dbrief_from_patches(
                patches, uv_l, r0, c0, undist, ang, cams.invpol, cams.cde, cams.pp, a0, settings.desc_size,
                bool(settings.learn_masks), pattern=tables.pattern)
        else:
            desc = brief_ops.compute_orb_from_patches(patches, uv_l, r0, c0, ang, settings.desc_size,
                                                      pattern=tables.pattern)
            dmask = torch.full_like(desc, 255)
        if sp is not None:
            # device values, read when the counters are
            sp.count(level=level, keypoints=lambda: ok.sum(), mask_bits_kept=lambda: _mask_share(dmask, ok))
    octave = torch.full(resp.shape, level, dtype=torch.int32, device=resp.device)
    return uv0, resp, octave, ang, desc, dmask, ok


def _mask_share(dmask: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """The share of set mask bits over the valid slots (1 with no masks, 0
    with no valid slot)."""
    w = (1 << torch.arange(8, device=dmask.device)).to(torch.uint8)
    kept = ((dmask[..., None] & w) > 0).flatten(-2).float().mean(-1)
    return (kept * ok).sum() / ok.sum().clamp_min(1)


def extract_features(
    images: torch.Tensor,
    cams: OmniCamera,
    settings: ExtractorSettings,
    tables: Optional[ExtractorTables] = None,
    n_features: Optional[int] = None,
    fast_th: Optional[float] = None,
) -> FrameFeatures:
    """Full multi-camera extraction. images [C, H, W] uint8 or float in
    [0, 255], on the device that does the work. `tables` are built here
    when not given (pass them to skip the rebuild on every frame)."""
    n_feats = int(n_features or settings.n_features)
    th = float(fast_th if fast_th is not None else settings.fast_th)
    images = images.to(torch.float32)
    C, H, W = images.shape
    if tables is None:
        tables = ExtractorTables(settings, H, W, device=images.device)
    elif (tables.height, tables.width) != (H, W) or tables.settings != settings:
        raise ValueError(f"tables were built for {tables.height}x{tables.width} and "
                         f"{tables.settings}, not {H}x{W} and {settings}")
    pyr = image_ops.build_pyramid(images, settings.n_levels, settings.scale_factor,
                                  tables.resize_weights())
    quotas = fast_ops.level_quota(n_feats, settings.n_levels, settings.scale_factor)
    outs = []
    for lvl, img_l in enumerate(pyr):
        blurred = image_ops.box_filter(img_l, 5)
        outs.append(_extract_level(img_l, blurred, cams, settings, tables, lvl,
                                   int(quotas[lvl]), th))
    uv, resp, octave, ang, desc, dmask, ok = (torch.cat(parts, dim=1) for parts in zip(*outs))
    cam_ids = torch.arange(C, device=images.device)[:, None]
    rays = img_to_world(cams.pol[cam_ids], cams.cde[cam_ids], cams.pp[cam_ids], uv)
    return FrameFeatures(uv, resp, octave, ang, rays, desc, dmask, ok)


FIELDS = ("uv", "response", "octave", "angle", "rays", "desc", "dmask", "valid")


def downselect_features(feats: FrameFeatures, K: int, keep: Optional[np.ndarray] = None,
                        quotas: Optional[np.ndarray] = None) -> Tuple[FrameFeatures, np.ndarray]:
    """Reduce a [C, K2] frame (the init bank doubles the features,
    cTracking.cpp:152-158) to the runtime [C, K] capacity.

    Per camera, rows flagged in `keep` (flat indices c * K2 + i, e.g. the
    bootstrap's triangulated features) win slots first; the rest fill by
    detector response. `quotas` (per-level slot budgets summing to <= K, the
    runtime bank's `level_quota`) keeps the extractor's level distribution,
    and leftover room fills by priority. Host numpy, once per
    initialization. Returns (FrameFeatures [C, K] on the input's device,
    remap [C * K2] -> flat [C * K] index or -1)."""
    C, K2 = feats.uv.shape[:2]
    dev = feats.uv.device
    fields = {name: getattr(feats, name).cpu().numpy() for name in FIELDS}
    keep_mask = np.zeros((C, K2), bool)
    if keep is not None and len(keep):
        keep = np.asarray(keep, np.int64)
        keep_mask[keep // K2, keep % K2] = True
    out = {name: np.zeros((C, K) + a.shape[2:], a.dtype) for name, a in fields.items()}
    out["dmask"][:] = 255
    remap = np.full(C * K2, -1, np.int64)
    for c in range(C):
        prio = np.where(fields["valid"][c], fields["response"][c], -np.inf)
        prio = np.where(keep_mask[c], prio + 1e9, prio)
        if quotas is not None:
            octv = fields["octave"][c]
            chosen = []
            taken = np.zeros(K2, bool)
            for lvl, q in enumerate(np.asarray(quotas, np.int64)):
                cand = np.nonzero((octv == lvl) & np.isfinite(prio))[0]
                cand = cand[np.argsort(-prio[cand], kind="stable")][:q]
                chosen.append(cand)
                taken[cand] = True
            rest = np.nonzero(~taken & np.isfinite(prio))[0]
            room = K - sum(len(x) for x in chosen)
            if room > 0 and len(rest):
                chosen.append(rest[np.argsort(-prio[rest], kind="stable")][:room])
            order = np.concatenate(chosen)[:K] if chosen else np.empty(0, np.int64)
        else:
            order = np.argsort(-prio, kind="stable")[:K]
            order = order[np.isfinite(prio[order])]
        n = len(order)
        for name, a in fields.items():
            out[name][c, :n] = a[c][order]
        out["valid"][c, n:] = False
        remap[c * K2 + order] = c * K + np.arange(n)
    return FrameFeatures(**{k: torch.from_numpy(v).to(dev) for k, v in out.items()}), remap
