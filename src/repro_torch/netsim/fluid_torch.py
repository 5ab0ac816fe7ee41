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
sparse at N >= `SPARSE_AUTO_RACKS`.  Fault injection and paced demand
(Fig. 11) are not ported yet.
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
from repro_torch.netsim.fluid import RotorFluidResult

# engine="auto" switches to the sparse engine at this rack count: the JAX
# package's crossover on its own backend, kept so that "auto" resolves as
# there.  On the H100 the faster engine depends on the batch and on VLB
# as well as on N (chip_smoke.py's crossover phase; PERF.md).
SPARSE_AUTO_RACKS = 192

_NOT_PORTED = ("fault injection and paced demand are not ported yet "
               "(ROADMAP: faulted fluid engines)")


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
    faults=None,
    paced_cycles: int = 0,
    engine: str = "auto",          # auto | dense | sparse
    device: DeviceLike = None,
) -> RotorBatchResult:
    """Simulate a batch of bulk-demand scenarios over one topology.

    The batch axis is the scenario grid (workloads, load levels, demand
    seeds).  ``device=None`` runs on the CUDA card and raises without
    one; ``device="cpu"`` runs the plain PyTorch path.  `faults` and
    `paced_cycles` raise `NotImplementedError` until the faulted
    engines are ported."""
    if faults is not None or paced_cycles:
        raise NotImplementedError(_NOT_PORTED)
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
    if engine == "sparse":
        dst = torch.as_tensor(topo.matching_index_tensor(), device=dev)
        done_t, wire_t, residual = _run_batch_sparse(
            dst, own0, bool(vlb), int(max_cycles))
    else:
        adj = torch.as_tensor(topo.matching_tensor(), dtype=dtype, device=dev)
        done_t, wire_t, residual = _run_batch(
            adj, own0, bool(vlb), int(max_cycles))

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
