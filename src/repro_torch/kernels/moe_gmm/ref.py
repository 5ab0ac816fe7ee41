"""Plain PyTorch version of the grouped expert-FFN GEMM.

Port of `repro.kernels.moe_gmm.ref.moe_gmm_ref`: per expert,
``act(h @ Wg) * (h @ Wu) @ Wd`` over capacity-padded buffers, all in
float32, rounded once to h's dtype, with `act` the config's activation
(``ACTS``: silu, gelu in its tanh form as `jax.nn.gelu`, or relu; the
JAX package's einsum trio applies ``act_fn(cfg.act)``, moe.py:101);
`moe_gmm_bwd_ref` is its explicit backward.  `ops.moe_gmm` runs the
first on CPU tensors, where autograd differentiates it; the CUDA kernels
in ``csrc/moe_gmm.cu`` and ``csrc/moe_gmm_bwd.cu`` are held against the
two on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# the activations the kernels take, in the order of their csrc enum
ACTS = ("silu", "gelu", "relu")
_GELU_C = math.sqrt(2.0 / math.pi)
_GELU_K = 0.044715


def check_act(act: str) -> int:
    """`act`'s index in ``ACTS``; raises on any other name."""
    if act not in ACTS:
        raise ValueError(f"act {act!r}: the moe_gmm kernels take {ACTS}")
    return ACTS.index(act)


def _act(g: torch.Tensor, act: str) -> torch.Tensor:
    check_act(act)
    if act == "silu":
        return F.silu(g)
    if act == "gelu":
        return F.gelu(g, approximate="tanh")
    return F.relu(g)


def _act_and_grad(g: torch.Tensor, act: str):
    """(act(g), act'(g)) in float32; relu' is 0 at 0, as `jax.grad`."""
    check_act(act)
    if act == "silu":
        s = torch.sigmoid(g)
        return g * s, s * (1 + g * (1 - s))
    if act == "gelu":
        t = torch.tanh(_GELU_C * (g + _GELU_K * g**3))
        return (0.5 * g * (1 + t),
                0.5 * (1 + t) + 0.5 * g * (1 - t * t) * _GELU_C
                * (1 + 3 * _GELU_K * g * g))
    return F.relu(g), (g > 0).to(g.dtype)


def moe_gmm_ref(h: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """h: (E, C, D); wg/wu: (E, D, F); wd: (E, F, D).  Returns (E, C, D)."""
    h32 = h.float()
    g = torch.einsum("ecd,edf->ecf", h32, wg.float())
    u = torch.einsum("ecd,edf->ecf", h32, wu.float())
    a = _act(g, act) * u
    return torch.einsum("ecf,efd->ecd", a, wd.float()).to(h.dtype)


def moe_gmm_bwd_ref(h: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor, dout: torch.Tensor, act: str = "silu"):
    """The explicit backward of `moe_gmm_ref`, in float32: G = h Wg and
    U = h Wu recomputed, A = act(G) U; dWd = A^T dout, dA = dout Wd^T,
    dG = dA U act'(G), dU = dA act(G), dWg = h^T dG, dWu = h^T dU,
    dh = dG Wg^T + dU Wu^T.  Returns (dh, dwg, dwu, dwd), each rounded once
    to its input's dtype, what the CUDA kernel in ``csrc/moe_gmm_bwd.cu``
    computes."""
    h32, wg32, wu32, wd32 = h.float(), wg.float(), wu.float(), wd.float()
    d32 = dout.float()
    g = torch.einsum("ecd,edf->ecf", h32, wg32)
    u = torch.einsum("ecd,edf->ecf", h32, wu32)
    f, df = _act_and_grad(g, act)
    da = torch.einsum("ecd,efd->ecf", d32, wd32)
    dg = da * u * df
    du = da * f
    dh = (torch.einsum("ecf,edf->ecd", dg, wg32)
          + torch.einsum("ecf,edf->ecd", du, wu32))
    return (dh.to(h.dtype),
            torch.einsum("ecd,ecf->edf", h32, dg).to(wg.dtype),
            torch.einsum("ecd,ecf->edf", h32, du).to(wu.dtype),
            torch.einsum("ecf,ecd->efd", f * u, d32).to(wd.dtype))
