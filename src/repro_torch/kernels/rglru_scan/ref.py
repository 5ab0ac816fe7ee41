"""Plain PyTorch version of the RG-LRU diagonal-recurrence kernel.

Port of `repro.kernels.rglru_scan.ref.rglru_scan_ref`: the sequential
recurrence in float32, and `rglru_scan_bwd_ref`, its explicit backward.
`ops.rglru_scan` runs the first on CPU tensors, where autograd
differentiates it; the CUDA kernels in ``csrc/rglru_scan.cu`` and
``csrc/rglru_scan_bwd.cu`` are held against the two on the card.
`rglru_scan_bwd_chunked_ref` is the backward kernel's own order of
operations, which the card holds the kernel to bit for bit; nothing on
the port's path calls it.
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, bx: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + bx_t.  a, bx: (B, S, D); h0: (B, D).
    Returns the full state sequence (B, S, D) float32."""
    h = h0.float()
    a32, b32 = a.float(), bx.float()
    out = []
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def rglru_scan_bwd_ref(a: torch.Tensor, hs: torch.Tensor, h0: torch.Tensor,
                       dhs: torch.Tensor):
    """The explicit backward of `rglru_scan_ref`: from the gradients dhs
    of every state, g_t = dhs_t + a_{t+1} g_{t+1} walked from the end;
    da_t = g_t h_{t-1} (h0 at t = 0), dbx_t = g_t, dh0 = a_0 g_0.  hs is
    the forward's output.  Returns (da, dbx) in a's dtype and dh0 float32,
    what the CUDA kernel in ``csrc/rglru_scan_bwd.cu`` computes."""
    a32, h32, g32 = a.float(), hs.float(), dhs.float()
    prev = torch.cat([h0.float()[:, None], h32[:, :-1]], dim=1)
    q = torch.zeros_like(h0, dtype=torch.float32)
    gs = []
    for t in range(a.shape[1] - 1, -1, -1):
        g = g32[:, t] + q
        gs.append(g)
        q = a32[:, t] * g
    g = torch.stack(gs[::-1], dim=1)
    return (g * prev).to(a.dtype), g.to(a.dtype), q


def rglru_scan_bwd_chunked_ref(a: torch.Tensor, hs: torch.Tensor,
                               h0: torch.Tensor, dhs: torch.Tensor,
                               chunk: int):
    """`rglru_scan_bwd_ref` in the backward kernel's order: S cut into
    chunks of `chunk` steps; each chunk walked from its end from a zero
    carry (e_c, and P_c the product of its a's); the carries walked from
    the last chunk, Q_c = P_c Q_{c+1} + e_c from zero past the end; each
    chunk walked again from the carry into it, Q_{c+1}.  Each operation
    is rounded to float32 on its own, as the kernel's (built with
    -fmad=false), so on any device this gives the kernel's bits.  The
    last chunk's missing steps are padded with a = 1 and dhs = 0, which
    leave its zero carry as it is.  Returns (da, dbx) in a's dtype and
    dh0 float32."""
    B, S, D = a.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S
    prev = torch.cat([h0.float()[:, None], hs.float()[:, :-1]], dim=1)
    a32, g32 = a.float(), dhs.float()
    if pad:
        a32 = torch.cat([a32, a32.new_ones(B, pad, D)], dim=1)
        g32, prev = (torch.cat([t, t.new_zeros(B, pad, D)], dim=1)
                     for t in (g32, prev))
    a32, g32, prev = (t.reshape(B, nc, chunk, D) for t in (a32, g32, prev))
    p = torch.ones(B, nc, D, dtype=torch.float32, device=a.device)
    e = torch.zeros_like(p)
    for i in range(chunk - 1, -1, -1):
        e = a32[:, :, i] * (g32[:, :, i] + e)
        p = p * a32[:, :, i]
    carry = torch.zeros_like(p)    # carry[:, c] = Q_{c+1}, into chunk c
    q = torch.zeros_like(p[:, 0])
    for c in range(nc - 1, 0, -1):
        q = p[:, c] * q + e[:, c]
        carry[:, c - 1] = q
    da, dbx = torch.empty_like(a32), torch.empty_like(a32)
    q = carry
    for i in range(chunk - 1, -1, -1):
        g = g32[:, :, i] + q
        da[:, :, i] = g * prev[:, :, i]
        dbx[:, :, i] = g
        q = a32[:, :, i] * g
    da, dbx = (t.reshape(B, nc * chunk, D)[:, :S].to(a.dtype)
               for t in (da, dbx))
    return da, dbx, q[:, 0]
