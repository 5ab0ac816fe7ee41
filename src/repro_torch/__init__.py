"""PyTorch port of the Opera rotor-fabric simulator, for NVIDIA Hopper.

A second package beside the JAX reference `repro`: it imports `torch`
and `numpy` only, and keeps its own copy of every framework-free module
it needs.  Entry points take an explicit ``device``; `resolve_device`
maps ``None`` to CUDA and refuses to carry on quietly without a card.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA card; a CUDA device without a
    card raises.  The CPU runs only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
