"""Config loading for the three reference YAML schemas (port of
`multicol_slam_tpu/utils/config.py`):

  1. SLAM settings      (Slam_Settings_*.yaml, parsed cTracking.cpp:87-173)
  2. Rig calibration    (MultiCamSys_Calibration.yaml, cSystem.cpp:129-143)
  3. Per-cam intrinsics (InteriorOrientationFisheye{c}.yaml, cSystem.cpp:146-172)

The files are OpenCV FileStorage YAML. The reference reads them with
pyyaml after stripping the "%YAML:1.0" directive; the port has a parser of
its own (`load_opencv_yaml`): flat `key: value` lines, which is all the
loaders read. It takes the directive, `---`, `key:value` with no space
after the colon, `#` comments, blank lines, quoted strings, and the
integers, floats, booleans and nulls of YAML 1.1. An indented block under
a key with no value (an `!!opencv-matrix`, a nested map) is skipped.

One deliberate difference: pyyaml's YAML 1.1 reads a float without a dot
(`1e-5`) as a string, which the reference's loaders then pass to float();
this parser reads it as a float, so the loaders' results agree.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device

_KEY = re.compile(r"^([\w.]+)\s*:(.*)$")
# YAML 1.1's int forms (decimal, hex, octal) as pyyaml resolves them
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_HEX = re.compile(r"^[-+]?0x[0-9a-fA-F_]+$")
_OCT = re.compile(r"^[-+]?0[0-7_]+$")
# YAML 1.1's floats, widened to every form float() reads (see the docstring)
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*\.?[0-9_]*|\.[0-9][0-9_]*)([eE][-+]?[0-9]+)?$")
_INF = re.compile(r"^[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"^\.(nan|NaN|NAN)$")
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")


def _strip_comment(text: str) -> str:
    """`text` without a trailing `# comment` (a '#' at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def parse_scalar(text: str):
    """One YAML scalar -> int, float, bool, None or str."""
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        body = s[1:-1]
        return body.replace("''", "'") if s[0] == "'" else body.replace('\\"', '"').replace("\\\\", "\\")
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    plain = s.replace("_", "")
    if _INT.match(s):
        return int(plain)
    if _HEX.match(s):
        return int(plain, 16)
    if _OCT.match(s):
        return int(plain, 8)
    if _INF.match(s):
        return float("-inf") if s[0] == "-" else float("inf")
    if _NAN.match(s):
        return float("nan")
    if _FLOAT.match(s):
        return float(plain)
    return s


def load_opencv_yaml(path: str) -> Dict:
    """The top-level `key: value` pairs of an OpenCV FileStorage YAML file.
    A key whose value is an indented block (a matrix, a nested map) is
    skipped with its block."""
    out: Dict = {}
    with open(path, "r") as f:
        lines = f.read().splitlines()
    for ln in lines:
        body = _strip_comment(ln).rstrip()
        if not body.strip() or body.lstrip().startswith("%YAML") or body.strip() in ("---", "..."):
            continue
        if body[0] in " \t-":
            continue   # inside an indented block, or a sequence item: no loader reads them
        m = _KEY.match(body)
        if m is None:
            raise ValueError(f"{path}: cannot parse line {ln!r}")
        key, value = m.group(1), m.group(2).strip()
        if value.startswith("!!") or value == "":
            continue   # a tagged or nested block follows
        out[key] = parse_scalar(value)
    return out


@dataclasses.dataclass(frozen=True)
class ExtractorSettings:
    """Feature-extractor knobs (Slam_Settings_*.yaml `extractor.*` block)."""

    use_mdbrief: int = 0        # 0 -> ORB, 1 -> dBRIEF/mdBRIEF path
    learn_masks: int = 0        # mdBRIEF online stability masks
    use_agast: int = 0
    fast_agast_type: int = 2
    desc_size: int = 32         # descriptor bytes: 16/32/64
    n_features: int = 400
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_th: int = 20
    score_type: int = 0         # 0 Harris, 1 FAST


@dataclasses.dataclass(frozen=True)
class SlamSettings:
    """Slam_Settings_*.yaml: camera rate, motion model, extractor."""

    fps: float = 25.0
    rgb: int = 1
    use_motion_model: bool = True
    extractor: ExtractorSettings = dataclasses.field(default_factory=ExtractorSettings)
    traj_start_frame: int = 0
    traj_end_frame: int = -1

    # keyframe-cadence constants derived from the rate (cTracking.cpp:93-94)
    @property
    def min_frames(self) -> int:
        return int(round(self.fps / 3.0))

    @property
    def max_frames(self) -> int:
        return int(round(2.0 * self.fps / 3.0))


def load_slam_settings(path: str) -> SlamSettings:
    d = load_opencv_yaml(path)
    ex = ExtractorSettings(
        use_mdbrief=int(d.get("extractor.usemdBRIEF", 0)),
        learn_masks=int(d.get("extractor.masks", 0)),
        use_agast=int(d.get("extractor.useAgast", 0)),
        fast_agast_type=int(d.get("extractor.fastAgastType", 2)),
        desc_size=int(d.get("extractor.descSize", 32)),
        n_features=int(d.get("extractor.nFeatures", 400)),
        scale_factor=float(d.get("extractor.scaleFactor", 1.2)),
        n_levels=int(d.get("extractor.nLevels", 8)),
        fast_th=int(d.get("extractor.fastTh", 20)),
        score_type=int(d.get("extractor.nScoreType", 0)),
    )
    return SlamSettings(
        fps=float(d.get("Camera.fps", 25.0)),
        rgb=int(d.get("Camera.RGB", 1)),
        use_motion_model=bool(d.get("UseMotionModel", 1)),
        extractor=ex,
        traj_start_frame=int(d.get("traj.StartFrame", 0)),
        traj_end_frame=int(d.get("traj.EndFrame", -1)),
    )


def load_rig_calibration(path: str) -> np.ndarray:
    """MultiCamSys_Calibration.yaml -> [C, 6] Cayley+t extrinsics M_c
    (cSystem.cpp:129-143: keys CameraSystem.cam{i}_{1..6}, i is 1-based)."""
    d = load_opencv_yaml(path)
    n = int(d["CameraSystem.nrCams"])
    out = np.zeros((n, 6), np.float64)
    for i in range(n):
        for j in range(6):
            out[i, j] = float(d[f"CameraSystem.cam{i + 1}_{j + 1}"])
    return out


@dataclasses.dataclass(frozen=True)
class IntrinsicsConfig:
    width: int
    height: int
    pol: List[float]          # forward poly a0..a{nrpol-1}
    invpol: List[float]       # inverse poly pol0..pol{nrinvpol-1}
    cde: List[float]          # affine c, d, e
    pp: List[float]           # principal point u0, v0
    mirror_mask: bool = True


def load_intrinsics(path: str) -> IntrinsicsConfig:
    d = load_opencv_yaml(path)
    nrpol = int(d["Camera.nrpol"])
    nrinvpol = int(d["Camera.nrinvpol"])
    return IntrinsicsConfig(
        width=int(d["Camera.Iw"]),
        height=int(d["Camera.Ih"]),
        pol=[float(d[f"Camera.a{i}"]) for i in range(nrpol)],
        invpol=[float(d[f"Camera.pol{i}"]) for i in range(nrinvpol)],
        cde=[float(d["Camera.c"]), float(d["Camera.d"]), float(d["Camera.e"])],
        pp=[float(d["Camera.u0"]), float(d["Camera.v0"])],
        mirror_mask=bool(d.get("Camera.mirrorMask", 1)),
    )


def load_rig(calib_dir: str, n_cams: Optional[int] = None, device=DEFAULT_DEVICE):
    """A MultiCamRig from a calibration directory laid out like
    Examples/Lafida/ (MultiCamSys_Calibration.yaml +
    InteriorOrientationFisheye{c}.yaml), on the card unless `device` says
    otherwise."""
    from multicol_slam_tpu_torch.models.camera import OmniCamera
    from multicol_slam_tpu_torch.models.rig import MultiCamRig

    device = resolve_device(device)
    mc = load_rig_calibration(os.path.join(calib_dir, "MultiCamSys_Calibration.yaml"))
    if n_cams is not None:
        mc = mc[:n_cams]
    intr = [load_intrinsics(os.path.join(calib_dir, f"InteriorOrientationFisheye{c}.yaml"))
            for c in range(mc.shape[0])]
    cams = OmniCamera.from_params([i.pol for i in intr], [i.invpol for i in intr], [i.cde for i in intr],
                                  [i.pp for i in intr], [[i.width, i.height] for i in intr], device=device)
    return MultiCamRig.from_cayley(cams, torch.tensor(mc, dtype=torch.float32, device=device))
