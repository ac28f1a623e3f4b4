"""Multi-camera rig: omni cameras + fixed camera -> body extrinsics (port of
`multicol_slam_tpu/models/rig.py`). M_t maps body -> world, M_c[c] camera c
-> body; a world point X lands in camera c at (M_t M_c[c])^-1 X, in front
when its z > 0."""
from __future__ import annotations

import torch
from torch import nn

from multicol_slam_tpu_torch.models.camera import OmniCamera
from multicol_slam_tpu_torch.utils.geometry import cayley_to_hom


class MultiCamRig(nn.Module):
    """cams: OmniCamera [C]; buffers Mc [C, 4, 4] and Mc_cayley [C, 6]."""

    def __init__(self, cams: OmniCamera, Mc: torch.Tensor, Mc_cayley: torch.Tensor):
        super().__init__()
        self.cams = cams
        self.register_buffer("Mc", Mc)
        self.register_buffer("Mc_cayley", Mc_cayley)

    @property
    def n_cams(self) -> int:
        return self.Mc.shape[0]

    @classmethod
    def from_cayley(cls, cams: OmniCamera, mc_cayley: torch.Tensor) -> "MultiCamRig":
        mc_cayley = torch.as_tensor(mc_cayley, device=cams.pol.device)
        return cls(cams, cayley_to_hom(mc_cayley), mc_cayley)
