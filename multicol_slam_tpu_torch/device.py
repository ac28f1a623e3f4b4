"""Where the port's constructors put their tensors: on the card, unless the
caller asks for the CPU with device="cpu"."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """`device` as a torch.device. Raises when it names CUDA and there is no
    card, instead of building on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device; the port runs on the card "
                           "(pass device='cpu' to build on the CPU)")
    return dev
