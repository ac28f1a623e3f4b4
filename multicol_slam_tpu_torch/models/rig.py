"""Multi-camera rig: omni cameras + fixed camera -> body extrinsics (port of
`multicol_slam_tpu/models/rig.py`). M_t maps body -> world, M_c[c] camera c
-> body; a world point X lands in camera c at (M_t M_c[c])^-1 X, in front
when its z > 0."""
from __future__ import annotations

import torch
from torch import nn

from multicol_slam_tpu_torch.models.camera import OmniCamera, cam_world_to_img, world_to_img
from multicol_slam_tpu_torch.utils.geometry import cayley_to_hom, hom_inverse, transform_points


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

    def with_extrinsics(self, mc_cayley: torch.Tensor) -> "MultiCamRig":
        """The same cameras with other extrinsics (self-calibrating BA)."""
        return MultiCamRig.from_cayley(self.cams, mc_cayley)


# ---------------------------------------------------------------------------
# Projection through the full chain (the MultiCol observation model)
# ---------------------------------------------------------------------------

def world_to_cam_frame(Mt: torch.Tensor, Mc: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(Mt Mc)^-1 X for broadcastable stacks: Mt, Mc [..., 4, 4], X [..., 3]
    -> camera-frame points [..., 3]."""
    return transform_points(hom_inverse(torch.matmul(Mt, Mc)), X)


def project_mcs(rig: MultiCamRig, Mt_cayley: torch.Tensor, cam_idx, X: torch.Tensor):
    """The MultiCol projection of a flat observation table: Mt_cayley
    [..., 6] body poses, cam_idx [...] int, X [..., 3] world points ->
    (uv [..., 2], z_cam [...]); z_cam > 0 is in front of the camera."""
    Xc = world_to_cam_frame(cayley_to_hom(Mt_cayley), rig.Mc[cam_idx], X)
    return cam_world_to_img(rig.cams, cam_idx, Xc), Xc[..., 2]


def project_mcs_params(invpol, cde, pp, Mt_cayley: torch.Tensor, Mc_cayley: torch.Tensor, X: torch.Tensor):
    """The projection with every parameter an argument (pose, extrinsics,
    intrinsics): the residual core of self-calibrating BA. Returns (uv
    [..., 2], z_cam [...])."""
    Xc = world_to_cam_frame(cayley_to_hom(Mt_cayley), cayley_to_hom(Mc_cayley), X)
    return world_to_img(invpol, cde, pp, Xc), Xc[..., 2]


def camera_centers(rig: MultiCamRig, Mt: torch.Tensor) -> torch.Tensor:
    """World positions of every camera's centre, (Mt Mc)[:3, 3]: Mt [..., 4, 4]
    -> [..., C, 3]."""
    return torch.einsum("...ij,cjk->...cik", Mt, rig.Mc)[..., :3, 3]


def body_center(Mt: torch.Tensor) -> torch.Tensor:
    """World position of the body frame (Mt maps body -> world)."""
    return Mt[..., :3, 3]
