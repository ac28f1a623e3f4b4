"""Extractor settings (port of `ExtractorSettings` in
`multicol_slam_tpu/utils/config.py`). The YAML loaders are not ported yet."""
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
