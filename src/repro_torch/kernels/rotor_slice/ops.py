"""Public entry of the permutation-sparse rotor slice step."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import pick
from repro_torch.kernels.rotor_slice.kernel import rotor_slice_fwd
from repro_torch.kernels.rotor_slice.ref import rotor_slice_ref


def rotor_slice_step(
    own: torch.Tensor,     # (B, N, N) undelivered bytes, normalized units
    relay: torch.Tensor,   # (B, N, N) in-flight relayed bytes
    dst: torch.Tensor,     # (N, u) int32 destination indices, sentinel N
    vlb: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Opera slice over a scenario batch; returns (own, relay,
    delivered, moved) with (B,) delivered / VLB-spread totals.

    CUDA tensors launch the Hopper kernel (`kernel.rotor_slice_fwd`,
    which counts the launch); CPU tensors run `ref.rotor_slice_ref`."""
    return pick(own, rotor_slice_fwd, rotor_slice_ref)(own, relay, dst, vlb)
