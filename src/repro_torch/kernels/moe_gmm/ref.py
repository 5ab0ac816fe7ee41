"""Plain PyTorch version of the grouped expert-FFN GEMM.

Port of `repro.kernels.moe_gmm.ref.moe_gmm_ref`: per expert,
``silu(h @ Wg) * (h @ Wu) @ Wd`` over capacity-padded buffers, all in
float32, rounded once to h's dtype; `moe_gmm_bwd_ref` is its explicit
backward.  `ops.moe_gmm` runs the first on CPU tensors, where autograd
differentiates it; the CUDA kernels in ``csrc/moe_gmm.cu`` and
``csrc/moe_gmm_bwd.cu`` are held against the two on the card.
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


def moe_gmm_bwd_ref(h: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor, dout: torch.Tensor):
    """The explicit backward of `moe_gmm_ref`, in float32: G = h Wg and
    U = h Wu recomputed, A = silu(G) U; dWd = A^T dout, dA = dout Wd^T,
    dG = dA U silu'(G), dU = dA silu(G), dWg = h^T dG, dWu = h^T dU,
    dh = dG Wg^T + dU Wu^T.  Returns (dh, dwg, dwu, dwd), each rounded once
    to its input's dtype, what the CUDA kernel in ``csrc/moe_gmm_bwd.cu``
    computes."""
    h32, wg32, wu32, wd32 = h.float(), wg.float(), wu.float(), wd.float()
    d32 = dout.float()
    g = torch.einsum("ecd,edf->ecf", h32, wg32)
    u = torch.einsum("ecd,edf->ecf", h32, wu32)
    s = torch.sigmoid(g)
    silu = g * s
    da = torch.einsum("ecd,efd->ecf", d32, wd32)
    dg = da * u * (s * (1 + g * (1 - s)))
    du = da * silu
    dh = (torch.einsum("ecf,edf->ecd", dg, wg32)
          + torch.einsum("ecf,edf->ecd", du, wu32))
    return (dh.to(h.dtype),
            torch.einsum("ecd,ecf->edf", h32, dg).to(wg.dtype),
            torch.einsum("ecd,ecf->edf", h32, du).to(wu.dtype),
            torch.einsum("ecf,ecd->efd", silu * u, d32).to(wd.dtype))
