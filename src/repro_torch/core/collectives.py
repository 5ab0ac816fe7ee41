"""Rotor collectives — Opera's time-expanded scheduling on torch.distributed.

Port of `repro.core.collectives`, function by function.  The paper's bulk
class buffers traffic until the rotor switches provide a *direct*
source->destination circuit, so every byte crosses exactly one link (zero
bandwidth tax).  On a mesh axis of size N the analog is the N-matching
sum-factorization of the complete graph (core.topology): during "slice" m
shard i exchanges exactly with (m - i) mod N.  A rotor collective walks
the slices with one `comm.ppermute` per matching, moving each peer's
chunk on the one slice with a direct circuit.

The latency class is the opposite trade: don't wait, hop over the
currently-live expander (multi-hop `ppermute` chains), paying the
bandwidth tax in exchange for immediacy.  `expander_all_gather`
implements it, for small control tensors (loss scalars, router
statistics, health beacons).

Every function is *per-rank* code, called by every rank of the axis's
line with its own shard, as the JAX functions are called inside a
`shard_map`; each takes the `comm.Mesh` and the axis name where the JAX
function takes the axis name.  The order of the matchings and of every
addition is the JAX package's, so the sums round as its do, but for the
direct all-reduce's, which adds in axis order so that every rank gets
the same bits (`rotor_all_reduce`).  Reference
semantics (tests/test_torch_collectives.py holds them to the JAX
package's outputs):

    rotor_all_reduce(x, m, ax)        == psum(x, ax)
    rotor_reduce_scatter(x, m, ax)    == psum_scatter(x, ax, tiled chunk)
    rotor_all_gather(x, m, ax)        == all_gather(x, ax)
    rotor_all_to_all(x, m, ax)        == all_to_all(x, ax, 0, 0, tiled)

Everything is schedule-static: matchings come from the axis size
(design-time, like the paper — no runtime circuit selection).  The bytes
each rank sends are counted on the mesh (`Mesh.sent_bytes`);
`schedule_stats` gives what the schedule should send per input byte.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.core.comm import Mesh, axis_index, axis_size, ppermute
from repro_torch.core.expander import hop_distances


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _matchings(n: int) -> list:
    """All n sum-factorization matchings (partner vectors)."""
    return topo.sum_matchings(n)


def _perm_pairs(p: np.ndarray) -> list:
    return [(int(i), int(p[i])) for i in range(len(p)) if int(p[i]) != i]


def _split_leading(x: torch.Tensor, n: int) -> torch.Tensor:
    """(n, chunk) over a flattened view, zero-padded to a multiple of n."""
    flat = x.reshape(-1)
    if flat.shape[0] % n != 0:
        pad = n - flat.shape[0] % n
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(n, -1)


def _unless_fixed(recv: torch.Tensor, partner: int, i: int) -> torch.Tensor:
    """What a matching adds: zeros at its fixed point (which received
    zeros anyway), as the JAX code's ``jnp.where(partner == i, 0, recv)``."""
    return torch.zeros_like(recv) if partner == i else recv


# --------------------------------------------------------------------------
# bulk class: direct one-hop schedules
# --------------------------------------------------------------------------


def rotor_reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str
                         ) -> torch.Tensor:
    """Reduce-scatter: every shard ends with the fully-reduced chunk i.

    Each addend chunk travels exactly one hop (its direct slice) — Opera's
    bulk class.  Input may be any shape; it is flattened to (N, chunk) and
    the local reduced chunk (chunk,) is returned.
    """
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    xs = _split_leading(x, n)
    acc = xs[i]
    for p in _matchings(n):
        pairs = _perm_pairs(p)
        if not pairs:
            continue
        partner = int(p[i])
        # send the chunk destined for my partner; receive mine from them
        recv = ppermute(xs[partner], mesh, axis, pairs)
        acc = acc + _unless_fixed(recv, partner, i)
    return acc


def rotor_all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """All-gather of per-shard chunks, one direct hop per chunk."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    out = x.new_zeros((n,) + tuple(x.shape))
    out[i] = x
    for p in _matchings(n):
        pairs = _perm_pairs(p)
        if not pairs:
            continue
        partner = int(p[i])
        recv = ppermute(x, mesh, axis, pairs)
        out[partner] = x if partner == i else recv
    return out


def rotor_all_reduce(x: torch.Tensor, mesh: Mesh, axis: str,
                     mode: str = "rs_ag") -> torch.Tensor:
    """All-reduce via the rotor schedule.

    mode="rs_ag": reduce-scatter + all-gather (2 one-hop journeys/byte,
                  2*(N-1)/N * |x| bytes on the wire per shard — bandwidth
                  optimal, the beyond-paper default).
    mode="direct": every slice exchanges the *whole* tensor with the direct
                  partner ((N-1) * |x| bytes; fewer rounds, optimal for
                  small N, e.g. the 2-pod axis).

    In direct mode every rank adds the N tensors in axis order, where the
    JAX code adds them in the order they arrive (its partner's first):
    the same sum, and the same bits on every rank.  Ranks that rounded
    apart could take different decisions on it (the MoE's local branch
    routes every token on every rank from this sum); on two ranks the two
    orders are one.
    """
    if mode == "direct":
        n, i = axis_size(mesh, axis), axis_index(mesh, axis)
        parts = {i: x}
        for p in _matchings(n):
            pairs = _perm_pairs(p)
            if not pairs:
                continue
            partner = int(p[i])
            recv = ppermute(x, mesh, axis, pairs)
            if partner != i:
                parts[partner] = recv
        acc = parts[0]
        for j in range(1, n):
            acc = acc + parts[j]
        return acc
    if mode != "rs_ag":
        raise ValueError(f"mode {mode!r}: rs_ag or direct")
    chunk = rotor_reduce_scatter(x, mesh, axis)
    full = rotor_all_gather(chunk, mesh, axis).reshape(-1)
    return full[:x.numel()].reshape(x.shape)


def rotor_all_to_all(x: torch.Tensor, mesh: Mesh, axis: str,
                     vlb: bool = False) -> torch.Tensor:
    """All-to-all: x has leading dim N (chunk j is destined for shard j);
    returns the same layout with chunk j originating from shard j.

    vlb=True adds RotorLB's 2-hop Valiant spreading: every chunk first
    hops to a balanced intermediate and is delivered on the next "cycle".
    That doubles wire bytes (the paper's 100 % VLB tax) but decouples the
    per-slice load from the demand skew.
    """
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if x.shape[0] != n:
        raise ValueError(f"leading dim {x.shape[0]} != axis size {n}")

    def one_round(buf):
        out = torch.zeros_like(buf)
        out[i] = buf[i]
        for p in _matchings(n):
            pairs = _perm_pairs(p)
            if not pairs:
                continue
            partner = int(p[i])
            recv = ppermute(buf[partner], mesh, axis, pairs)
            out[partner] = buf[i] if partner == i else recv
        return out

    if not vlb:
        return one_round(x)
    rows = torch.arange(n, device=x.device)
    # phase 1: spread — the chunk destined to d goes to intermediate
    # (d + i) % n: buffer row m (intermediate m) carries x[(m - i) % n]
    at_inter = one_round(x[(rows - i) % n])
    # at_inter[s] came from source s, for final destination (i - s) % n;
    # phase 2: rebucket rows by final destination, one more round
    deliver = torch.zeros_like(at_inter)
    deliver[(i - rows) % n] = at_inter
    out = one_round(deliver)
    # out[m] came through intermediate m from source (m - i) % n
    final = torch.zeros_like(out)
    final[(rows - i) % n] = out
    return final


# --------------------------------------------------------------------------
# latency class: immediate multi-hop over the live expander
# --------------------------------------------------------------------------


def _expander_routing(n: int, u: int, seed: int = 0):
    """Static design-time routing over the union of u live matchings.

    Returns (matchings, diameter).  Like the paper, if a random draw is a
    poor expander we redraw at design time (§3.3).
    """
    for attempt in range(16):
        ms = topo.random_matchings(n, seed + attempt)
        i = np.arange(n)
        live = [p for p in ms if (p != i).any()][:u]
        adj = np.zeros((n, n), dtype=bool)
        for p in live:
            mask = p != i
            adj[i[mask], p[mask]] = True
        d = hop_distances(adj)
        if (d >= 0).all():
            return live, int(d.max())
    raise RuntimeError("could not draw a connected expander")


def expander_all_gather(x: torch.Tensor, mesh: Mesh, axis: str, u: int = 3,
                        seed: int = 0) -> torch.Tensor:
    """All-gather a *small* tensor immediately over the live expander.

    Gossip over the union of u matchings for `diameter` rounds: round h
    forwards everything known so far to each of the u neighbors.  Total
    wire bytes per shard ~= u * diameter * N * |x| — the bandwidth tax the
    paper accepts for the (tiny) latency-sensitive fraction, in exchange
    for not waiting on the rotor cycle.  Use for control-plane tensors.
    """
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if n == 1:
        return x[None]
    live, diam = _expander_routing(n, min(u, n - 1), seed)
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[i] = x
    mask = torch.zeros(n, dtype=torch.bool, device=x.device)
    mask[i] = True
    for _ in range(diam):
        for p in live:
            pairs = _perm_pairs(p)
            if not pairs:
                continue
            rbuf = ppermute(buf, mesh, axis, pairs)
            rmask = ppermute(mask, mesh, axis, pairs)
            take = rmask & ~mask
            buf = torch.where(take.view((n,) + (1,) * x.dim()), rbuf, buf)
            mask = mask | rmask
    return buf


def expander_psum_latency(x: torch.Tensor, mesh: Mesh, axis: str,
                          u: int = 3) -> torch.Tensor:
    """Latency-class sum of a small tensor (e.g. a loss scalar)."""
    return expander_all_gather(x, mesh, axis, u=u).sum(dim=0)


# --------------------------------------------------------------------------
# hierarchical schedules (multi-pod)
# --------------------------------------------------------------------------


def hierarchical_rotor_all_reduce(x: torch.Tensor, mesh: Mesh, data_axis: str,
                                  pod_axis: Optional[str] = None
                                  ) -> torch.Tensor:
    """RS(data) -> AR(pod, direct) -> AG(data).

    Inter-pod traffic is (N_pod - 1) direct exchanges of the 1/N_data
    shard — the pod axis never sees the full gradient, which is what lets
    the schedule scale to many pods (each added pod adds one matching
    slice, not one ring lap).
    """
    chunk = rotor_reduce_scatter(x, mesh, data_axis)
    if pod_axis is not None:
        chunk = rotor_all_reduce(chunk, mesh, pod_axis, mode="direct")
    full = rotor_all_gather(chunk, mesh, data_axis).reshape(-1)
    return full[:x.numel()].reshape(x.shape)


Tree = Union[torch.Tensor, Mapping]


def rotor_psum_tree(tree: Tree, mesh: Mesh, data_axis: str,
                    pod_axis: Optional[str] = None) -> Tree:
    """`hierarchical_rotor_all_reduce` of every leaf of a tensor, or of
    nested mappings of names to tensors (the port's parameter and
    gradient trees), in the mapping's order."""
    if isinstance(tree, torch.Tensor):
        return hierarchical_rotor_all_reduce(tree, mesh, data_axis, pod_axis)
    return {k: rotor_psum_tree(v, mesh, data_axis, pod_axis)
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# gradient compression (beyond-paper distributed-optimization trick)
# --------------------------------------------------------------------------


def quantize(x: torch.Tensor, bits: int = 8
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, scale): `x` as int`bits` (int8 storage) with one per-shard
    scale, max |x| / (2^(bits-1) - 1), rounded half to even."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(x.abs().max(), min=1e-30) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def compressed_rotor_all_reduce(
    x: torch.Tensor, mesh: Mesh, axis: str,
    error: Optional[torch.Tensor] = None, bits: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-quantized rotor all-reduce with error feedback.

    Quantize (x + carried_error) to int`bits` with a per-shard scale,
    all-reduce the dequantized payload, and carry the quantization
    residual into the next step.  Returns (all_reduced_approx, new_error).
    The payload is reduced as float32 in the dequantized domain (scales
    differ per shard): the wire carries 4 bytes an element, as the JAX
    package's does.  Its payload is ``q.astype(bf16) * scale.astype(bf16)``
    cast to float32, which XLA compiles with excess precision (its
    default ``xla_allow_excess_precision``): the scale is rounded to
    bfloat16, the product of the two (exact in float32) is not.  So here.
    """
    if error is not None:
        x = x + error
    q, scale = quantize(x, bits)
    new_error = x - q.to(x.dtype) * scale
    payload = q.float() * scale.to(torch.bfloat16).float()
    total = rotor_all_reduce(payload, mesh, axis)
    return total.to(x.dtype), new_error


# --------------------------------------------------------------------------
# schedule metadata
# --------------------------------------------------------------------------


def schedule_stats(n: int, u: int = 3) -> dict:
    """Wire-byte accounting per shard for |x| = 1 unit, matching §2/§3."""
    live, diam = _expander_routing(n, min(u, max(n - 1, 1)))
    return dict(
        axis_size=n,
        slices=n,
        rotor_ar_bytes=2 * (n - 1) / n,           # RS+AG, per input byte
        rotor_ar_direct_bytes=(n - 1),            # small-N direct mode
        rotor_a2a_bytes=(n - 1) / n,              # per input byte
        rotor_a2a_vlb_bytes=2 * (n - 1) / n,      # 100 % VLB tax (§3.4)
        expander_diameter=diam,
        expander_allgather_bytes=float(len(live) * diam),  # per gathered byte
        bandwidth_tax_latency=float(max(diam - 1, 0)),
    )
