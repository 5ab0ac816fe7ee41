"""Batched PyTorch fluid engine for rotor fabrics.

Port of `repro.netsim.fluid_jax` (unfaulted half).  A batch of B
bulk-demand scenarios over one topology steps slice by slice for a
fixed ``max_cycles``; completion stats are read on the host afterwards
from the cumulative-delivery trajectory, as the numpy oracle's
early-exit loop records them.  All byte quantities are normalized to
units of one slice-link capacity (`core.schedule.slice_capacity_bytes`)
so float32 keeps ample mantissa headroom.

Two engines share the public API (`engine=` on
`simulate_rotor_bulk_batch`):

* **dense** — plain torch ops over the ``(S, N, N)`` matching tensor;
  the VLB relay spread is one batched ``share^T @ take`` matmul, run in
  full float32 (TF32 is switched off for it, as XLA's f32 dot is exact).
* **sparse** — the ``(S, N, u)`` index tensor through
  `kernels.rotor_slice.ops.rotor_slice_step`: the hand-written CUDA
  kernel on the card, its plain PyTorch version on the CPU.

Both drivers keep the trajectory on the device: the ``(B, T)`` delivered
and wire tensors are preallocated and column ``t`` is written each
step, with no host sync until the run ends.  ``engine="auto"`` picks
sparse at N >= `SPARSE_AUTO_RACKS`.

Fault injection and paced demand (Fig. 11): each engine has a faulted
step that rebuilds the per-step masks from the compiled int32
component timelines (`faults.compile_fault_masks`) by comparisons on
the global step, so one program serves every failure draw.  The
faulted sparse step is `rotor_slice_faulted_ref` in plain torch on
every device; the reference has no kernel for it either.  Blackholed
bytes are summed directly from the sends into really-dead edges, not
taken as attempted minus delivered (ROADMAP R1).  An event-less
schedule with no pacing runs the unfaulted program, so
`FailureSchedule.empty()` gives the same bits as ``faults=None``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.opera_paper import OperaNetConfig
from repro_torch.core.schedule import cycle_timing, slice_capacity_bytes
from repro_torch.core.topology import OperaTopology, build_opera_topology
from repro_torch.kernels.rotor_slice.ops import rotor_slice_step
from repro_torch.kernels.rotor_slice.ref import rotor_slice_faulted_ref
from repro_torch.netsim.faults import (
    FailureSchedule,
    FaultMasks,
    compile_fault_masks,
)
from repro_torch.netsim.fluid import RotorFluidResult

# engine="auto" switches to the sparse engine at this rack count: the JAX
# package's crossover on its own backend, kept so that "auto" resolves as
# there.  On the H100 the faster engine depends on the batch and on VLB
# as well as on N (chip_smoke.py's crossover phase; PERF.md).
SPARSE_AUTO_RACKS = 192

def _slice_step(own, relay, adj, vlb: bool):
    """One dense topology slice over the batch: `fluid_jax._slice_step`
    with a leading batch axis.  Returns (own, relay, delivered, moved)
    with (B,) totals; moved is None without VLB."""
    send_own = torch.minimum(own, adj)
    own = own - send_own
    room = adj - send_own
    send_relay = torch.minimum(relay, room)
    relay = relay - send_relay
    room = room - send_relay
    delivered = send_own.sum((1, 2)) + send_relay.sum((1, 2))
    if not vlb:
        return own, relay, delivered, None
    elig = torch.where(adj > 0, 0.0, own)
    q = elig.sum(2)
    r = room.sum(2)
    t = torch.minimum(q, r)
    take = elig * torch.where(q > 0, t / q.clamp(min=1e-30), 0.0)[:, :, None]
    share = room * torch.where(r > 0, 1.0 / r.clamp(min=1e-30), 0.0)[:, :, None]
    own = own - take
    relay = relay + share.transpose(1, 2) @ take
    return own, relay, delivered, t.sum(1)


def _run_batch(adj, own0, vlb: bool, num_cycles: int):
    """Dense driver: batch x cycles x slices.  Returns the cumulative
    delivered/wire trajectories (B, num_cycles * S) and the final
    undelivered residual (B,), in normalized units."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bsz = own0.shape[0]
    num_slices = adj.shape[0]
    done_t = own0.new_empty((bsz, num_cycles * num_slices))
    wire_t = torch.empty_like(done_t)
    own, relay = own0, torch.zeros_like(own0)
    done = own0.new_zeros(bsz)
    wire = own0.new_zeros(bsz)
    for step in range(num_cycles * num_slices):
        own, relay, delivered, moved = _slice_step(
            own, relay, adj[step % num_slices], vlb)
        done = done + delivered
        wire = wire + delivered
        if moved is not None:
            wire = wire + moved
        done_t[:, step] = done
        wire_t[:, step] = wire
    return done_t, wire_t, own.sum((1, 2)) + relay.sum((1, 2))


def _sparse_slice_step(own, relay, done, wire, dst, vlb: bool):
    """One sparse slice step plus trajectory accumulation."""
    own, relay, delivered, moved = rotor_slice_step(own, relay, dst, vlb=vlb)
    return own, relay, done + delivered, wire + delivered + moved


def _run_batch_sparse(dst, own0, vlb: bool, num_cycles: int):
    """Sparse analogue of `_run_batch`, one `rotor_slice_step` per slice;
    same (done_t, wire_t, residual) contract."""
    bsz = own0.shape[0]
    num_slices = dst.shape[0]
    done_t = own0.new_empty((bsz, num_cycles * num_slices))
    wire_t = torch.empty_like(done_t)
    own, relay = own0, torch.zeros_like(own0)
    done = own0.new_zeros(bsz)
    wire = own0.new_zeros(bsz)
    for step in range(num_cycles * num_slices):
        own, relay, done, wire = _sparse_slice_step(
            own, relay, done, wire, dst[step % num_slices], vlb)
        done_t[:, step] = done
        wire_t[:, step] = wire
    return done_t, wire_t, own.sum((1, 2)) + relay.sum((1, 2))


# --------------------------------------------------------------------------
# Faulted engines (fault injection and paced demand)
# --------------------------------------------------------------------------


def _component_masks(g: int, up_onset, up_detect, up_recover,
                     tor_onset, tor_detect, tor_recover):
    """Which uplinks (B, N, S+1) and ToRs (B, N) are really down and
    which are known down at global step `g`: comparisons on the int32
    timelines, on the device (`faults.step_masks` is the numpy
    reference)."""
    return ((g >= up_onset) & (g < up_recover),
            (g >= up_detect) & (g < up_recover),
            (g >= tor_onset) & (g < tor_recover),
            (g >= tor_detect) & (g < tor_recover))


def _pair_dead(up_k, tor_k, pair_sw, dtype):
    """(B, N, N) 0/1: pairs whose one serving switch (every slice) is
    known down at either end, or whose either ToR is."""
    p_k = torch.gather(up_k, 2, pair_sw.expand(up_k.shape[0], -1, -1))
    return (p_k | p_k.transpose(1, 2)
            | tor_k[:, :, None] | tor_k[:, None, :]).to(dtype)


def _slice_step_faulted(own, relay, adj, sw, pair_sw, g: int, timelines,
                        vlb: bool):
    """One dense slice under failure masks: `fluid_jax._slice_step_faulted`
    with a leading batch axis, blackholed bytes summed directly (R1).
    Returns (own, relay, delivered, moved, blackholed) with (B,) totals;
    moved is None without VLB."""
    up_f, up_k, tor_fb, tor_kb = _component_masks(g, *timelines)
    swb = sw.expand(own.shape[0], -1, -1)
    i_f = torch.gather(up_f, 2, swb)
    i_k = torch.gather(up_k, 2, swb)
    e_real = (i_f | i_f.transpose(1, 2)
              | tor_fb[:, :, None] | tor_fb[:, None, :]).to(own.dtype)
    e_known = (i_k | i_k.transpose(1, 2)
               | tor_kb[:, :, None] | tor_kb[:, None, :]).to(own.dtype)
    tor_real = tor_fb.to(own.dtype)

    cap = adj * (1.0 - e_known) * (1.0 - tor_real)[:, :, None]
    arrive = 1.0 - e_real
    send_own = torch.minimum(own, cap)
    own = own - send_own * arrive
    room = cap - send_own
    send_relay = torch.minimum(relay, room)
    relay = relay - send_relay * arrive
    room = room - send_relay
    delivered = ((send_own * arrive).sum((1, 2))
                 + (send_relay * arrive).sum((1, 2)))
    blackholed = ((send_own * e_real).sum((1, 2))
                  + (send_relay * e_real).sum((1, 2)))
    if not vlb:
        return own, relay, delivered, None, blackholed
    dst_ok = (1.0 - tor_kb.to(own.dtype))[:, None, :]
    elig = torch.where(cap > 0, 0.0, own * dst_ok)
    relig = relay * _pair_dead(up_k, tor_kb, pair_sw, own.dtype) * dst_ok
    q = elig.sum(2) + relig.sum(2)
    r = room.sum(2)
    t = torch.minimum(q, r)
    frac = torch.where(q > 0, t / q.clamp(min=1e-30), 0.0)[:, :, None]
    take = elig * frac
    rtake = relig * frac
    share = room * torch.where(r > 0, 1.0 / r.clamp(min=1e-30),
                               0.0)[:, :, None]
    lost = (share * e_real).sum(2)
    own = own - take + take * lost[:, :, None]
    relay = relay - rtake + rtake * lost[:, :, None]
    relay = relay + (share * arrive).transpose(1, 2) @ (take + rtake)
    lost_bytes = ((take + rtake).sum(2) * lost).sum(1)
    return (own, relay, delivered, t.sum(1) - lost_bytes,
            blackholed + lost_bytes)


def _sparse_slice_step_faulted(own, relay, dst, pair_sw, g: int, timelines,
                               vlb: bool):
    """One sparse slice under failure masks: slot s of ``dst`` is switch
    s, so the uplink timelines apply by slot; only the pair-dead mask
    gathers through the (N, N) serving-switch map."""
    up_f, up_k, tor_fb, tor_kb = _component_masks(g, *timelines)
    u = dst.shape[1]
    return rotor_slice_faulted_ref(
        own, relay, dst, up_f[:, :, :u], up_k[:, :, :u], tor_fb, tor_kb,
        _pair_dead(up_k, tor_kb, pair_sw, own.dtype), vlb)


def _run_faulted(step, slices, own0, num_cycles: int, paced_cycles: int):
    """Shared step loop of the faulted engines: `step(own, relay, t, g)`
    runs slice t at global step g.  With `paced_cycles`, each of the
    first that many cycles starts by injecting 1/paced_cycles of the
    demand.  Returns (done_t, wire_t, residual, blackholed)."""
    bsz = own0.shape[0]
    done_t = own0.new_empty((bsz, num_cycles * slices))
    wire_t = torch.empty_like(done_t)
    if paced_cycles:
        inject = own0 * (1.0 / paced_cycles)
        own = torch.zeros_like(own0)
    else:
        own = own0
    relay = torch.zeros_like(own0)
    done = own0.new_zeros(bsz)
    wire = own0.new_zeros(bsz)
    blk = own0.new_zeros(bsz)
    for c in range(num_cycles):
        if c < paced_cycles:
            own = own + inject
        for t in range(slices):
            g = c * slices + t
            own, relay, delivered, moved, blackholed = step(own, relay, t, g)
            done = done + delivered
            wire = wire + delivered
            if moved is not None:
                wire = wire + moved
            blk = blk + blackholed
            done_t[:, g] = done
            wire_t[:, g] = wire
    return done_t, wire_t, own.sum((1, 2)) + relay.sum((1, 2)), blk


def _run_batch_faulted(adj, sw, pair_sw, own0, timelines, vlb: bool,
                       num_cycles: int, paced_cycles: int):
    """Dense faulted run.  `sw` (S, N, N) and `pair_sw` (N, N) are the
    int64 switch-id maps; `timelines` the six (B, ...) int32 tensors of
    `FaultMasks`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return _run_faulted(
        lambda own, relay, t, g: _slice_step_faulted(
            own, relay, adj[t], sw[t], pair_sw, g, timelines, vlb),
        adj.shape[0], own0, num_cycles, paced_cycles)


def _run_batch_sparse_faulted(dst, pair_sw, own0, timelines, vlb: bool,
                              num_cycles: int, paced_cycles: int):
    """Sparse faulted run over the (S, N, u) index tensor."""
    return _run_faulted(
        lambda own, relay, t, g: _sparse_slice_step_faulted(
            own, relay, dst[t], pair_sw, g, timelines, vlb),
        dst.shape[0], own0, num_cycles, paced_cycles)


@dataclasses.dataclass
class RotorBatchResult:
    """Per-scenario bulk stats for a batch of B scenarios over T slices.

    Scalars are (B,) arrays; `finished_frac` keeps the full (B, T)
    trajectory.  Delivery stats are read at each scenario's completion
    step `slices_run`, the truncation the numpy oracle performs."""

    finished_frac: np.ndarray      # (B, T)
    time_us: np.ndarray            # (T,)
    fct_99_ms: np.ndarray          # (B,)
    fct_mean_ms: np.ndarray        # (B,)
    throughput_gbps: np.ndarray    # (B,)
    wire_bytes: np.ndarray         # (B,)
    goodput_bytes: np.ndarray      # (B,)
    residual_bytes: np.ndarray     # (B,) undelivered at run end
    total_bytes: np.ndarray        # (B,) offered demand
    slices_run: np.ndarray         # (B,)
    blackholed_bytes: Optional[np.ndarray] = None  # (B,) lost-in-flight sends

    @property
    def bandwidth_tax(self) -> np.ndarray:
        return self.wire_bytes / np.maximum(self.goodput_bytes, 1.0) - 1.0

    @property
    def batch_size(self) -> int:
        return self.finished_frac.shape[0]

    def scenario(self, b: int) -> RotorFluidResult:
        """View one batch row as the single-scenario result type."""
        k = int(self.slices_run[b])
        return RotorFluidResult(
            finished_frac=list(self.finished_frac[b, :k]),
            time_us=list(self.time_us[:k]),
            fct_99_ms=float(self.fct_99_ms[b]),
            fct_mean_ms=float(self.fct_mean_ms[b]),
            throughput_gbps=float(self.throughput_gbps[b]),
            wire_bytes=float(self.wire_bytes[b]),
            goodput_bytes=float(self.goodput_bytes[b]),
            slices_run=k,
            blackholed_bytes=(
                float(self.blackholed_bytes[b])
                if self.blackholed_bytes is not None else 0.0
            ),
        )


def fault_operands(topo: OperaTopology, faults, bsz: int, device):
    """Compile `faults` (None, a schedule, a list of them, or
    `FaultMasks`) for a batch of `bsz` rows and put the faulted runs'
    operands on `device`: returns the masks, the six int32 timelines
    and the (N, N) int64 serving-switch map."""
    if faults is None:
        faults = FailureSchedule.empty(topo)
    masks = (faults if isinstance(faults, FaultMasks)
             else compile_fault_masks(topo, faults)).broadcast_to(bsz)
    timelines = tuple(torch.as_tensor(a, device=device) for a in (
        masks.up_onset, masks.up_detect, masks.up_recover,
        masks.tor_onset, masks.tor_detect, masks.tor_recover))
    return masks, timelines, torch.as_tensor(masks.pair_switch,
                                             device=device).long()


def _faults_all_empty(faults) -> bool:
    """True when `faults` carries no failure event: None, an event-less
    `FailureSchedule`, or a sequence of event-less ones."""
    if faults is None:
        return True
    if isinstance(faults, FailureSchedule):
        return faults.is_empty
    if isinstance(faults, (list, tuple)):
        return all(isinstance(f, FailureSchedule) and f.is_empty
                   for f in faults)
    return False


def resolve_engine(engine: str, num_racks: int) -> str:
    """Map ``engine="auto"`` to "dense"/"sparse" by design-point size."""
    if engine == "auto":
        return "sparse" if num_racks >= SPARSE_AUTO_RACKS else "dense"
    if engine not in ("dense", "sparse"):
        raise ValueError(f"engine must be auto|dense|sparse, got {engine!r}")
    return engine


def simulate_rotor_bulk_batch(
    cfg: OperaNetConfig,
    demands: np.ndarray,           # (B, N, N) or (N, N) rack->rack bytes
    vlb: bool = True,
    max_cycles: int = 400,
    topo: Optional[OperaTopology] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    faults=None,  # FailureSchedule | Sequence[FailureSchedule] | FaultMasks
    paced_cycles: int = 0,
    engine: str = "auto",          # auto | dense | sparse
    device: DeviceLike = None,
) -> RotorBatchResult:
    """Simulate a batch of bulk-demand scenarios over one topology.

    The batch axis is the scenario grid (workloads, load levels, demand
    seeds).  ``device=None`` runs on the CUDA card and raises without
    one; ``device="cpu"`` runs the plain PyTorch path.

    `faults` is a `faults.FailureSchedule` shared by every row, a
    sequence of them (one draw per row), or compiled `FaultMasks`;
    `paced_cycles` spreads each row's demand over that many cycle
    starts instead of offering it all at t=0.  Either routes the batch
    through the engine's faulted program; an event-less `faults` with
    no pacing runs the unfaulted one."""
    dev = resolve_device(device)
    demands = np.asarray(demands, np.float64)
    if demands.ndim == 2:
        demands = demands[None]
    n = cfg.num_racks
    if demands.shape[1:] != (n, n):
        raise ValueError(f"demand shape {demands.shape[1:]} != ({n}, {n})")
    topo = topo or build_opera_topology(n, cfg.u, seed=seed, groups=cfg.groups)
    t = cycle_timing(cfg)
    cap = slice_capacity_bytes(cfg, t)
    engine = resolve_engine(engine, n)

    own0 = torch.as_tensor(demands / cap, dtype=dtype, device=dev)
    blackholed = None
    if _faults_all_empty(faults) and not paced_cycles:
        if engine == "sparse":
            dst = torch.as_tensor(topo.matching_index_tensor(), device=dev)
            done_t, wire_t, residual = _run_batch_sparse(
                dst, own0, bool(vlb), int(max_cycles))
        else:
            adj = torch.as_tensor(topo.matching_tensor(), dtype=dtype,
                                  device=dev)
            done_t, wire_t, residual = _run_batch(
                adj, own0, bool(vlb), int(max_cycles))
    else:
        masks, timelines, pair_sw = fault_operands(
            topo, faults, demands.shape[0], dev)
        if engine == "sparse":
            dst = torch.as_tensor(topo.matching_index_tensor(), device=dev)
            done_t, wire_t, residual, blk = _run_batch_sparse_faulted(
                dst, pair_sw, own0, timelines, bool(vlb), int(max_cycles),
                int(paced_cycles))
        else:
            adj = torch.as_tensor(topo.matching_tensor(), dtype=dtype,
                                  device=dev)
            sw = torch.as_tensor(masks.switch_id, device=dev).long()
            done_t, wire_t, residual, blk = _run_batch_faulted(
                adj, sw, pair_sw, own0, timelines, bool(vlb),
                int(max_cycles), int(paced_cycles))
        blackholed = blk.cpu().numpy().astype(np.float64) * cap

    # Device f32 trajectories are de-normalized on the host at float64
    # before stats, mirroring the numpy oracle's precision.
    done = done_t.cpu().numpy().astype(np.float64) * cap
    wire = wire_t.cpu().numpy().astype(np.float64) * cap
    residual = residual.cpu().numpy().astype(np.float64) * cap
    totals = demands.sum((1, 2))

    B, T = done.shape
    time_us = (np.arange(T) + 1) * t.slice_us
    fct99 = np.empty(B)
    fct_mean = np.empty(B)
    tput = np.empty(B)
    slices_run = np.empty(B, np.int64)
    finished = done / np.maximum(totals, 1.0)[:, None]
    for b in range(B):
        hit = done[b] >= totals[b] * 0.99999
        k = int(np.argmax(hit)) if hit.any() else T - 1
        slices_run[b] = k + 1
        fin = finished[b, : k + 1]
        tms = time_us[: k + 1] / 1e3
        fct99[b] = (
            float(tms[np.searchsorted(fin, 0.99)])
            if fin[-1] >= 0.99
            else float("inf")
        )
        fct_mean[b] = float(np.interp(0.5, fin, tms))
        dur_s = time_us[k] * 1e-6
        tput[b] = done[b, k] * 8 / dur_s / 1e9

    rows = np.arange(B)
    at_end = (slices_run - 1).clip(0, T - 1)
    return RotorBatchResult(
        finished_frac=finished,
        time_us=time_us,
        fct_99_ms=fct99,
        fct_mean_ms=fct_mean,
        throughput_gbps=tput,
        wire_bytes=wire[rows, at_end],
        goodput_bytes=done[rows, at_end],
        residual_bytes=residual,
        total_bytes=totals,
        slices_run=slices_run,
        blackholed_bytes=blackholed,
    )


def simulate_rotor_bulk_torch(
    cfg: OperaNetConfig,
    demand: np.ndarray,
    vlb: bool = True,
    max_cycles: int = 400,
    topo: Optional[OperaTopology] = None,
    seed: int = 0,
    faults=None,
    paced_cycles: int = 0,
    engine: str = "auto",
    device: DeviceLike = None,
) -> RotorFluidResult:
    """Single-scenario API (a batch of one), the counterpart of
    `fluid_jax.simulate_rotor_bulk_jax`."""
    r = simulate_rotor_bulk_batch(
        cfg, demand, vlb=vlb, max_cycles=max_cycles, topo=topo, seed=seed,
        faults=faults, paced_cycles=paced_cycles, engine=engine,
        device=device,
    )
    return r.scenario(0)
