"""Extractor and SLAM settings (port of `ExtractorSettings` and `SlamSettings`
in `multicol_slam_tpu/utils/config.py`). The YAML loaders are not ported yet:
the card's machine has no pyyaml, so they wait for a parser of their own."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ExtractorSettings:
    """Feature-extractor knobs (Slam_Settings_*.yaml `extractor.*` block)."""

    use_mdbrief: int = 0        # 0 -> ORB, 1 -> dBRIEF/mdBRIEF path (not ported)
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
