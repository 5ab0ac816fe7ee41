"""Plain PyTorch version of the grouped expert-FFN GEMM.

Port of `repro.kernels.moe_gmm.ref.moe_gmm_ref`: per expert,
``silu(h @ Wg) * (h @ Wu) @ Wd`` over capacity-padded buffers, all in
float32, rounded once to h's dtype.  `ops.moe_gmm` runs it on CPU
tensors; the CUDA kernel in ``csrc/moe_gmm.cu`` is held against it on
the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_gmm_ref(h: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """h: (E, C, D); wg/wu: (E, D, F); wd: (E, F, D).  Returns (E, C, D)."""
    h32 = h.float()
    g = torch.einsum("ecd,edf->ecf", h32, wg.float())
    u = torch.einsum("ecd,edf->ecf", h32, wu.float())
    act = F.silu(g) * u
    return torch.einsum("ecf,efd->ecd", act, wd.float()).to(h.dtype)
