"""Plain PyTorch version of the permutation-sparse rotor slice step.

Port of `repro.kernels.rotor_slice.ref` (``apply_edges``,
``rotor_slice_ref`` and ``rotor_slice_faulted_ref``).  One Opera slice
moves bytes over a union of involutive matchings: the ``(N, u)`` int32 index tensor ``dst`` (one
slice of `OperaTopology.matching_index_tensor()`) holds each rack's
destination per switch slot, with the sentinel ``N`` marking dark slots
(switch reconfiguring, or a matching's self-loop).  Every per-edge
quantity lives in ``(B, N, u)`` edge layout.

The reference writes the edge updates as compare-select trees because
XLA serializes scatters; here they are one `scatter_add` each.  Slots
are disjoint (each (i, j) pair is served by at most one switch per
slice), and sentinel slots scatter an exact zero, so the sums are the
reference's to the bit.  The relay spread stays the reference's row
gather, which the involution ``dst[dst[j, s], s] == j`` allows.

`ops.rotor_slice_step` runs `rotor_slice_ref` on CPU tensors; the CUDA
kernel in ``csrc/rotor_slice.cu`` is held against it on the card.
`rotor_slice_faulted_ref` has no kernel (nor has the reference's): the
faulted sparse engine runs it as plain torch on every device.
"""
from __future__ import annotations

from typing import Tuple

import torch


def apply_edges(dense: torch.Tensor, dst: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """``dense[b, i, dst[i, s]] += vals[b, i, s]``; sentinel slots
    (``dst == N``) add nothing."""
    bsz, n = dense.shape[0], dense.shape[-1]
    valid = dst < n
    idx = torch.where(valid, dst, 0).long()[None].expand(bsz, -1, -1)
    return dense.scatter_add(2, idx, vals * valid.to(vals.dtype))


def rotor_slice_ref(
    own: torch.Tensor,     # (B, N, N) undelivered source->dst bytes
    relay: torch.Tensor,   # (B, N, N) relayed bytes awaiting 2nd hop
    dst: torch.Tensor,     # (N, u) int32, sentinel N = dark slot
    vlb: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One slice step in edge layout; returns (own, relay, delivered,
    moved) with (B,) delivered/VLB-spread totals in normalized units
    (every live edge carries capacity 1.0 for one slice)."""
    bsz, n = own.shape[0], own.shape[1]
    u = dst.shape[1]
    valid = dst < n
    dstc = torch.where(valid, dst, 0).long()
    vf = valid.to(own.dtype)[None]                        # (1, N, u)
    idx = dstc[None].expand(bsz, n, u)

    # direct sends + relay forwarding, all in (B, N, u) edge layout
    own_e = torch.gather(own, 2, idx) * vf
    send_own_e = torch.minimum(own_e, vf)
    room_e = vf - send_own_e
    relay_e = torch.gather(relay, 2, idx) * vf
    send_relay_e = torch.minimum(relay_e, room_e)
    room_e = room_e - send_relay_e
    delivered = send_own_e.sum((1, 2)) + send_relay_e.sum((1, 2))

    own = apply_edges(own, dst, -send_own_e)
    relay = apply_edges(relay, dst, -send_relay_e)
    if not vlb:
        return own, relay, delivered, torch.zeros_like(delivered)

    # VLB spread.  Eligible bytes are those with no live circuit this
    # slice; subtracting the pre-send edge value leaves exact zeros at
    # live edges, as the dense `where(adj > 0, 0, own)` does.
    elig = apply_edges(own, dst, -(own_e - send_own_e))
    q = elig.sum(2)
    r = room_e.sum(2)
    t = torch.minimum(q, r)
    frac = torch.where(q > 0, t / q.clamp(min=1e-30), 0.0)[:, :, None]
    take = elig * frac
    share_e = room_e * torch.where(
        r > 0, 1.0 / r.clamp(min=1e-30), 0.0)[:, :, None]
    own = own - take
    # relay[j, :] += sum_s share_e[dst[j, s], s] * take[dst[j, s], :]
    # — the involution turns the scatter into a row gather.
    w = vf * torch.gather(share_e, 1, idx)
    add = torch.zeros_like(relay)
    for s in range(u):
        add = add + w[:, :, s:s + 1] * take[:, dstc[:, s], :]
    return own, relay + add, delivered, t.sum(1)


def rotor_slice_faulted_ref(
    own: torch.Tensor,        # (B, N, N)
    relay: torch.Tensor,      # (B, N, N)
    dst: torch.Tensor,        # (N, u) int32, sentinel N
    up_f: torch.Tensor,       # (B, N, u) bool: uplink failed (real)
    up_k: torch.Tensor,       # (B, N, u) bool: uplink failure known
    tor_f: torch.Tensor,      # (B, N) bool: ToR failed (real)
    tor_k: torch.Tensor,      # (B, N) bool: ToR failure known
    pair_dead: torch.Tensor,  # (B, N, N) 0/1: pair's serving switch dead
    vlb: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Faulted slice step in edge layout: the reference's
    `rotor_slice_faulted_ref`, which mirrors the float64 oracle
    `fluid.rotor_slice_step_faulted`.  It has no kernel: the faulted
    sparse engine calls it directly on every device.

    Slot s of ``dst`` is switch s, so the per-uplink masks apply by
    slot.  An edge is down (really / known) when either endpoint's
    uplink into s or either ToR is down; the far endpoint's state
    arrives by the involution gather.  Blackholed bytes are summed
    directly, as the sends into really-dead edges plus the VLB spread's
    lost share, not as attempted minus delivered: that difference of two
    large float32 totals cancels to nonzero values where nothing was
    lost.  Returns (own, relay, delivered, moved, blackholed) with (B,)
    totals."""
    bsz, n = own.shape[0], own.shape[1]
    u = dst.shape[1]
    valid = dst < n
    dstc = torch.where(valid, dst, 0).long()
    vf = valid.to(own.dtype)[None]
    idx = dstc[None].expand(bsz, n, u)

    g_f = torch.gather(up_f, 1, idx)               # up_f[b, dst[i, s], s]
    g_k = torch.gather(up_k, 1, idx)
    flat = idx.reshape(bsz, -1)
    tor_f_dst = torch.gather(tor_f, 1, flat).reshape(bsz, n, u)
    tor_k_dst = torch.gather(tor_k, 1, flat).reshape(bsz, n, u)
    e_real_e = (up_f | g_f | tor_f[:, :, None] | tor_f_dst).to(own.dtype)
    e_known_e = (up_k | g_k | tor_k[:, :, None] | tor_k_dst).to(own.dtype)
    tor_real = tor_f.to(own.dtype)
    tor_known = tor_k.to(own.dtype)

    cap_e = vf * (1.0 - e_known_e) * (1.0 - tor_real)[:, :, None]
    arrive_e = 1.0 - e_real_e
    own_e = torch.gather(own, 2, idx) * vf
    send_own_e = torch.minimum(own_e, cap_e)
    room_e = cap_e - send_own_e
    relay_e = torch.gather(relay, 2, idx) * vf
    send_relay_e = torch.minimum(relay_e, room_e)
    room_e = room_e - send_relay_e

    own = apply_edges(own, dst, -send_own_e * arrive_e)
    relay = apply_edges(relay, dst, -send_relay_e * arrive_e)
    delivered = ((send_own_e * arrive_e).sum((1, 2))
                 + (send_relay_e * arrive_e).sum((1, 2)))
    blackholed = ((send_own_e * e_real_e).sum((1, 2))
                  + (send_relay_e * e_real_e).sum((1, 2)))
    if not vlb:
        return own, relay, delivered, torch.zeros_like(delivered), blackholed

    # Eligibility excludes exactly the edges with usable capacity this
    # slice (cap_e > 0), not merely the live ones: a known-down edge's
    # bytes must VLB-spread.  Zero those edges by subtracting their
    # current values, then weight by destination-ToR health.
    dst_ok = 1.0 - tor_known
    own_after_e = torch.gather(own, 2, idx)
    capmask_vals = torch.where(cap_e > 0, own_after_e, 0.0)
    elig = apply_edges(own, dst, -capmask_vals) * dst_ok[:, None, :]
    relig = relay * pair_dead * dst_ok[:, None, :]
    q = elig.sum(2) + relig.sum(2)
    r = room_e.sum(2)
    t = torch.minimum(q, r)
    frac = torch.where(q > 0, t / q.clamp(min=1e-30), 0.0)[:, :, None]
    take = elig * frac
    rtake = relig * frac
    share_e = room_e * torch.where(
        r > 0, 1.0 / r.clamp(min=1e-30), 0.0)[:, :, None]
    lost = (share_e * e_real_e).sum(2)
    own = own - take + take * lost[:, :, None]
    relay = relay - rtake + rtake * lost[:, :, None]
    trt = take + rtake
    w = vf * torch.gather(share_e * arrive_e, 1, idx)
    add = torch.zeros_like(relay)
    for s in range(u):
        add = add + w[:, :, s:s + 1] * trt[:, dstc[:, s], :]
    lost_bytes = (trt.sum(2) * lost).sum(1)
    return (own, relay + add, delivered, t.sum(1) - lost_bytes,
            blackholed + lost_bytes)
