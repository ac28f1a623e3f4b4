"""Plain geometry of the MultiCol model, written from its equations: Cayley
rotations, rigid transforms, and the Scaramuzza omnidirectional camera.

Projection of a camera-frame point (x, y, z):
    norm = |(x, y)|, theta = atan2(-z, norm), rho = invpol(theta),
    (uu, vv) = (x, y) / norm * rho, u = c uu + d vv + u0, v = e uu + vv + v0.

Plain torch, float32 unless the caller passes float64. Imports nothing of
the program under test; the renderer of the benchmark's world and the plain
references share it.
"""
from __future__ import annotations

import numpy as np
import torch

MIRROR_OFFSET = 22.0  # the mirror mask's radial offset at level 0, in pixels


def poly(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_i coeffs[..., i] x^i (Horner), coeffs broadcasting against x."""
    out = torch.zeros_like(x) + coeffs[..., -1]
    for i in range(coeffs.shape[-1] - 2, -1, -1):
        out = out * x + coeffs[..., i]
    return out


def cayley_rot(c: torch.Tensor) -> torch.Tensor:
    """Cayley 3-vectors [..., 3] -> rotations [..., 3, 3]."""
    a, b, d = c[..., 0], c[..., 1], c[..., 2]
    aa, bb, dd = a * a, b * b, d * d
    R = torch.stack([
        torch.stack([1.0 + aa - bb - dd, 2.0 * (a * b - d), 2.0 * (a * d + b)], -1),
        torch.stack([2.0 * (a * b + d), 1.0 - aa + bb - dd, 2.0 * (b * d - a)], -1),
        torch.stack([2.0 * (a * d - b), 2.0 * (b * d + a), 1.0 - aa - bb + dd], -1),
    ], -2)
    return R / (1.0 + aa + bb + dd)[..., None, None]


def _rows(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] and [..., 3] -> [..., 4, 4] with the row (0, 0, 0, 1)."""
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype, device=R.device).expand(R.shape[:-2] + (1, 4))
    return torch.cat([torch.cat([R, t[..., None]], -1), bottom], -2)


def hom(c6: torch.Tensor) -> torch.Tensor:
    """[..., 6] (Cayley, translation) -> [..., 4, 4]."""
    return _rows(cayley_rot(c6[..., :3]), c6[..., 3:6])


def hom_inv(M: torch.Tensor) -> torch.Tensor:
    """Inverse of rigid transforms [..., 4, 4]."""
    Rt = M[..., :3, :3].transpose(-1, -2)
    return _rows(Rt, -(Rt @ M[..., :3, 3:4])[..., 0])


def np_hom(c6) -> np.ndarray:
    """float64 numpy [6] -> [4, 4]."""
    return hom(torch.as_tensor(np.asarray(c6, np.float64))).numpy()


def np_cayley(M: np.ndarray) -> np.ndarray:
    """float64 [4, 4] -> [6] float32: c from C = (R - I)(R + I)^-1, c = (-C12, C02, -C01)."""
    R = np.asarray(M, np.float64)[:3, :3]
    eye = np.eye(3)
    C = np.linalg.solve((R + eye).T, (R - eye).T).T
    c = np.array([-C[1, 2], C[0, 2], -C[0, 1]])
    return np.concatenate([c, np.asarray(M, np.float64)[:3, 3]]).astype(np.float32)


def project(invpol, cde, pp, X: torch.Tensor) -> torch.Tensor:
    """Camera-frame points X [..., 3] -> pixels [..., 2]; parameters broadcast."""
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    norm = torch.clamp_min(torch.sqrt(x * x + y * y), 1e-14)
    rho = poly(invpol, torch.atan2(-z, norm))
    uu, vv = x / norm * rho, y / norm * rho
    return torch.stack([uu * cde[..., 0] + vv * cde[..., 1] + pp[..., 0],
                        uu * cde[..., 2] + vv + pp[..., 1]], -1)


def in_mirror(pp, wh, uv: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Inside the image and inside the mirror circle of radius (v0 + 22) s
    around the principal point, at pyramid scale s."""
    u0, v0 = pp[..., 0] * scale, pp[..., 1] * scale
    w, h = torch.round(wh[..., 0] * scale), torch.round(wh[..., 1] * scale)
    u, v = uv[..., 0], uv[..., 1]
    inside = (u > 0) & (u < w - 1) & (v > 0) & (v < h - 1)
    du, dv = u - u0, v - v0
    rad = (pp[..., 1] + MIRROR_OFFSET) * scale
    return inside & (du * du + dv * dv < rad * rad)


class Rig:
    """A rig's parameters as plain tensors: pol [C, 5], invpol [C, 12], cde
    [C, 3], pp [C, 2], wh [C, 2], mc6 [C, 6] camera -> body (Cayley)."""

    def __init__(self, spec: dict, device, dtype=torch.float32):
        C = int(spec["n_cams"])
        W, H = float(spec["width"]), float(spec["height"])

        def rows(v):
            return torch.tensor(np.asarray(v, np.float64), device=device).to(dtype)
        self.n_cams = C
        self.width, self.height = int(W), int(H)
        self.pol = rows([spec["pol"]] * C)
        self.invpol = rows([spec["invpol"]] * C)
        self.cde = rows([[1.0, 0.0, 0.0]] * C)
        self.pp = rows([[W / 2.0, H / 2.0]] * C)
        self.wh = rows([[W, H]] * C)
        self.mc6 = rows(spec["mc_cayley"][:C])
        self.Mc = hom(self.mc6)

    def to(self, dtype) -> "Rig":
        """A copy with every parameter in `dtype`."""
        out = object.__new__(Rig)
        out.__dict__.update({k: v.to(dtype) if torch.is_tensor(v) else v for k, v in self.__dict__.items()})
        return out
