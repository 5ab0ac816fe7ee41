"""Batched PyTorch flow-level engine (Figs. 7, 9, 10, 11): the dense half.

Port of the dense engine of `repro.netsim.flows_jax`.  A batch of flow
scenarios (`flows.FlowScenario`) runs the fixed-dt processor-sharing
recurrence of `flows._oracle_steps` (kept in the JAX package) with the
flow state held as (B, n_max) tensors for the whole horizon: a Python
loop over steps, each step a handful of elementwise ops and per-row
reductions on the device, with no host sync until the run ends.  Exact
per-flow completion steps come back to the host, where `flows.finalize`
turns them into results; `trace=True` also keeps every step's
remaining bytes (test-sized grids).

Byte quantities are normalized to one NIC-step of service
(``nic_Bps * dt``) so float32 keeps ample mantissa headroom; activation
steps are int32, precomputed on the host.  Completions are counted into
per-class log-spaced FCT histograms (`_hist_accumulate`) with an int32
``index_add_``, so the counts are exact.  Scenarios with fewer flows than
the batch maximum are padded with never-active flows, and the deficit
snapshots come back as per-flow vectors summed on the host at float64
over real flows only, so padding is bitwise invisible.

Rows carrying a fault projection (`faults.apply_flow_faults`) route the
whole batch through the faulted step: frozen flows leave the share,
blackholed flows use their share without progress, and each pool is
scaled by the step's surviving capacity.  Fault-free batches run the
unfaulted step.

The streaming tiled engine is not ported yet (ROADMAP Queue 1 item 3):
``engine="tiled"``, and ``"auto"`` at `TILED_AUTO_FLOWS` flows or more,
raise `NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.netsim.faults import NEVER
from repro_torch.netsim.flows import (
    FCT_BIN_LOG2_WIDTH,
    FCT_HIST_BINS,
    FCT_HIST_LO_LOG2,
    NUM_FCT_CLASSES,
    FlowScenario,
    FlowSimResult,
    build_scenario,
    fct_class_id,
    finalize,
)

# engine="auto" stays dense below this many flows (largest scenario in
# the batch), as in the JAX package.
TILED_AUTO_FLOWS = 65536
# trace=True materializes a (B, steps, n_max) float stack; refuse
# clearly above this many elements.
TRACE_MAX_ELEMS = 1 << 26
# The JAX package's tiled-engine geometry defaults, kept for the tiled
# engine's port.
DEFAULT_TILE = 1024
DEFAULT_WINDOW_TILES = 16
DEFAULT_CHUNK_STEPS = 128

_TILED_NOT_PORTED = ("the tiled flow engine is not ported yet (ROADMAP "
                     "Queue 1 item 3); use engine='dense' below "
                     f"{TILED_AUTO_FLOWS} flows")


def resolve_flow_engine(engine: str, n_max: int, trace: bool = False) -> str:
    """'auto' -> 'dense'|'tiled' by scenario size (trace forces dense)."""
    if engine == "auto":
        return "dense" if (trace or n_max < TILED_AUTO_FLOWS) else "tiled"
    if engine not in ("dense", "tiled"):
        raise ValueError(f"engine must be auto|dense|tiled, got {engine!r}")
    return engine


def dense_state_bytes(num_flows: int, batch: int = 1) -> int:
    """Device-resident per-flow state of the fault-free dense engine, as
    the JAX package counts it: f32 remaining/allow_mid/allow_end/arr_ms
    plus the two deficit-snapshot vectors, int32 start/class/done_step,
    bool is_bulk — 37 B per flow slot."""
    return batch * num_flows * 37


def _hist_accumulate(hist, fct_sum, newly, bins0, step: int, arr_ms, dt_ms,
                     ln2):
    """Count newly-finished flows into the (B, classes * bins) int32
    histogram (`flows.fct_bin`'s device twin) and add their completion
    times to the (B,) sum.  `bins0` is each flow's first bin in the flat
    view of `hist` (its row's and its class's).  log2 is log(x) / log(2),
    as ``jnp.log2`` computes it, with log(2) a float32 tensor on the
    device (a Python divisor becomes a multiply by its reciprocal on
    CUDA)."""
    fct_ms = dt_ms * (step + 1) - arr_ms
    safe = torch.where(newly, fct_ms, 1.0)
    b = torch.floor((torch.log(safe) / ln2 - FCT_HIST_LO_LOG2)
                    * (1.0 / FCT_BIN_LOG2_WIDTH))
    b = b.clamp(0, FCT_HIST_BINS - 1).to(torch.int32)
    hist.view(-1).index_add_(0, (bins0 + b).reshape(-1),
                             newly.reshape(-1).to(hist.dtype))
    return fct_sum + torch.where(newly, fct_ms, 0.0).sum(1)


@dataclasses.dataclass
class _Ops:
    """The staged (B, n_max) scenario tensors of one batch, on the device."""

    start: torch.Tensor        # int32 first servable step
    is_bulk: torch.Tensor      # bool
    lat_u: torch.Tensor        # (B, 1) latency pool, NIC units
    bulk_u: torch.Tensor       # (B, 1) bulk pool, NIC units
    allow_mid: torch.Tensor
    allow_end: torch.Tensor
    mid_step: torch.Tensor     # (B, 1) int32
    end_step: torch.Tensor     # (B, 1) int32
    class_id: torch.Tensor     # int32
    arr_ms: torch.Tensor
    dt_ms: torch.Tensor        # (B, 1)
    # fault projection: (B, n_max) int32 windows, (B, steps) pool scales
    blk_start: Optional[torch.Tensor] = None
    blk_end: Optional[torch.Tensor] = None
    frz_start: Optional[torch.Tensor] = None
    frz_end: Optional[torch.Tensor] = None
    lat_scale: Optional[torch.Tensor] = None
    bulk_scale: Optional[torch.Tensor] = None

    @property
    def faulted(self) -> bool:
        return self.blk_start is not None


def _flow_step(remaining, done_step, rem_mid, rem_end, step: int,
               ops: _Ops):
    """One fixed-dt step over the batch: `flows_jax._flow_step` and, for a
    faulted batch, `_flow_step_faulted`, with a leading batch axis.
    Mirrors `flows._oracle_steps` (normalized units: every flow's
    per-step NIC budget is 1.0); change them together.  Returns the new
    (remaining, done_step, rem_mid, rem_end) and the flows that finished
    in this step."""
    active = (step >= ops.start) & (remaining > 0)
    # Deficit snapshots stay per-flow vectors, summed on the host.
    rem_mid = torch.where(step == ops.mid_step,
                          (remaining - ops.allow_mid).clamp(min=0.0), rem_mid)
    rem_end = torch.where(step == ops.end_step,
                          (remaining - ops.allow_end).clamp(min=0.0), rem_end)
    lat_u, bulk_u = ops.lat_u, ops.bulk_u
    sharing = active
    if ops.faulted:
        # frozen: behind a detected-dead ToR, out of the share until
        # recovery; blackholed: uses its share, makes no progress
        frozen = (step >= ops.frz_start) & (step < ops.frz_end)
        blackhole = (step >= ops.blk_start) & (step < ops.blk_end)
        sharing = active & ~frozen
        lat_u = lat_u * ops.lat_scale[:, step:step + 1]
        bulk_u = bulk_u * ops.bulk_scale[:, step:step + 1]
    newly_any = torch.zeros_like(active)
    for pool_u, mask in ((lat_u, sharing & ~ops.is_bulk),
                         (bulk_u, sharing & ops.is_bulk)):
        m = mask.to(remaining.dtype)
        k = m.sum(1, keepdim=True)
        share = (pool_u / k.clamp(min=1.0)).clamp(max=1.0)
        share = torch.where(pool_u > 0, share, 0.0)
        if ops.faulted:
            m = (mask & ~blackhole).to(remaining.dtype)
        remaining = remaining - torch.minimum(remaining, share) * m
        newly = mask & (remaining <= 0) & (done_step < 0)
        done_step = torch.where(newly, step + 1, done_step)
        newly_any = newly_any | newly
    return remaining, done_step, rem_mid, rem_end, newly_any


def _run_batch(remaining0, ops: _Ops, num_steps: int, trace: bool):
    """The dense step loop: `num_steps` steps of `_flow_step`, state on the
    device.  Returns (remaining, done_step, rem_mid, rem_end, hist,
    fct_sum, trace) with trace (B, steps, n_max) or None."""
    bsz = remaining0.shape[0]
    remaining = remaining0
    done_step = torch.full_like(ops.start, -1)
    rem_mid = torch.zeros_like(remaining0)
    rem_end = torch.zeros_like(remaining0)
    hist = torch.zeros((bsz, NUM_FCT_CLASSES * FCT_HIST_BINS),
                       dtype=torch.int32, device=remaining0.device)
    fct_sum = remaining0.new_zeros(bsz)
    ln2 = torch.log(torch.full((), 2.0, dtype=remaining0.dtype,
                               device=remaining0.device))
    rows = torch.arange(bsz, dtype=torch.int32, device=remaining0.device)
    bins0 = rows[:, None] * hist.shape[1] + ops.class_id * FCT_HIST_BINS
    ys = (remaining0.new_empty((bsz, num_steps, remaining0.shape[1]))
          if trace else None)
    for step in range(num_steps):
        remaining, done_step, rem_mid, rem_end, newly = _flow_step(
            remaining, done_step, rem_mid, rem_end, step, ops)
        fct_sum = _hist_accumulate(hist, fct_sum, newly, bins0, step,
                                   ops.arr_ms, ops.dt_ms, ln2)
        if trace:
            ys[:, step] = remaining
    return remaining, done_step, rem_mid, rem_end, hist, fct_sum, ys


@dataclasses.dataclass
class FlowBatchResult:
    """Batched engine output: one `FlowSimResult` per scenario
    (`flows.finalize` on exact completion steps), the per-flow remaining
    bytes at the end of the run, each scenario's (classes, bins)
    completion-time histogram, and, in trace mode, each scenario's
    (steps, n) remaining-bytes trajectory."""

    results: List[FlowSimResult]
    remaining_bytes: List[np.ndarray]       # (n_b,) per scenario
    traces: Optional[List[np.ndarray]] = None
    hists: Optional[List[np.ndarray]] = None


def _stage(scenarios: Sequence[FlowScenario], num_steps: int, n_max: int,
           dtype: torch.dtype, dev: torch.device):
    """Host float64 staging, cast once at the device boundary: the
    initial (B, n_max) remaining bytes in NIC units, the scenario
    tensors, and each row's NIC unit in bytes."""
    B = len(scenarios)
    remaining0 = np.zeros((B, n_max))
    start = np.full((B, n_max), num_steps + 1, np.int32)
    is_bulk = np.zeros((B, n_max), bool)
    allow_mid = np.zeros((B, n_max))
    allow_end = np.zeros((B, n_max))
    class_id = np.zeros((B, n_max), np.int32)
    arr_ms = np.zeros((B, n_max))
    lat_u, bulk_u, dt_ms, units = (np.zeros((B, 1)) for _ in range(4))
    mid_step = np.zeros((B, 1), np.int32)
    end_step = np.zeros((B, 1), np.int32)
    faulted = any(s.has_faults for s in scenarios)
    if faulted:
        # NEVER windows for fault-free rows and pad flows, unit scales
        # for fault-free rows: the faulted step is then the plain one.
        windows = [np.full((B, n_max), NEVER, np.int32) for _ in range(4)]
        scales = [np.ones((B, num_steps)) for _ in range(2)]
    for b, s in enumerate(scenarios):
        n = s.num_flows
        unit = s.nic_Bps * s.dt_s          # bytes one NIC serves per step
        units[b] = unit
        remaining0[b, :n] = s.sizes / unit
        start[b, :n] = s.start_step
        is_bulk[b, :n] = s.is_bulk
        allow_mid[b, :n] = s.deficit_allowance(s.mid_step) / unit
        allow_end[b, :n] = s.deficit_allowance(s.end_step) / unit
        class_id[b, :n] = fct_class_id(s.sizes)
        arr_ms[b, :n] = s.arr * 1e3
        lat_u[b] = s.lat_pool_Bps / s.nic_Bps
        bulk_u[b] = s.bulk_pool_Bps / s.nic_Bps
        dt_ms[b] = s.dt_s * 1e3
        mid_step[b] = s.mid_step
        end_step[b] = s.end_step
        if faulted and s.has_faults:
            for w, v in zip(windows, (s.blk_start, s.blk_end,
                                      s.frz_start, s.frz_end)):
                w[b, :n] = v
            scales[0][b] = s.lat_scale[:num_steps]
            scales[1][b] = s.bulk_scale[:num_steps]

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def i(a):
        return torch.as_tensor(a, device=dev)

    ops = _Ops(start=i(start), is_bulk=i(is_bulk), lat_u=f(lat_u),
               bulk_u=f(bulk_u), allow_mid=f(allow_mid),
               allow_end=f(allow_end), mid_step=i(mid_step),
               end_step=i(end_step), class_id=i(class_id), arr_ms=f(arr_ms),
               dt_ms=f(dt_ms))
    if faulted:
        (ops.blk_start, ops.blk_end, ops.frz_start,
         ops.frz_end) = map(i, windows)
        ops.lat_scale, ops.bulk_scale = map(f, scales)
    return f(remaining0), ops, units[:, 0]


def simulate_flows_batch(
    scenarios: Sequence[FlowScenario],
    dtype: torch.dtype = torch.float32,
    trace: bool = False,
    engine: str = "auto",
    device: DeviceLike = None,
) -> FlowBatchResult:
    """Simulate a batch of flow scenarios on the dense engine.

    All scenarios must share dt/horizon/tail (one step count); flow
    counts may differ, and shorter rows are padded with never-active
    flows.  Rows carrying a fault projection route the whole batch
    through the faulted step; fault-free batches run the unfaulted one.
    ``device=None`` runs on the CUDA card and raises without one;
    ``device="cpu"`` runs on the CPU.  The tiled engine is not ported:
    ``engine="tiled"``, or ``"auto"`` at `TILED_AUTO_FLOWS` flows or
    more, raises `NotImplementedError`."""
    dev = resolve_device(device)
    if not scenarios:
        return FlowBatchResult([], [])
    steps = {s.steps for s in scenarios}
    if len(steps) != 1:
        raise ValueError(f"scenarios disagree on step count: {sorted(steps)}")
    num_steps = steps.pop()
    n_max = max(s.num_flows for s in scenarios)
    B = len(scenarios)
    if resolve_flow_engine(engine, n_max, trace) == "tiled":
        raise NotImplementedError(_TILED_NOT_PORTED)
    if trace:
        elems = B * num_steps * n_max
        if elems > TRACE_MAX_ELEMS:
            raise ValueError(
                f"trace=True would materialize a ({B}, {num_steps}, "
                f"{n_max}) remaining-bytes stack ({elems:,} elements > "
                f"TRACE_MAX_ELEMS={TRACE_MAX_ELEMS:,}); trace mode is for "
                "test-sized grids — drop trace or shrink the scenario")

    remaining0, ops, units = _stage(scenarios, num_steps, n_max, dtype, dev)
    remaining, done_step, rem_mid, rem_end, hist, _, ys = _run_batch(
        remaining0, ops, num_steps, bool(trace))

    # De-normalized on the host at float64, as the oracle's finalize()
    # inputs.  The deficit snapshots are summed over real flows only, so
    # never-active pad flows are bitwise invisible.
    done_step = done_step.cpu().numpy()
    remaining = remaining.cpu().numpy().astype(np.float64)
    rem_mid = rem_mid.cpu().numpy().astype(np.float64)
    rem_end = rem_end.cpu().numpy().astype(np.float64)
    hist = hist.cpu().numpy().astype(np.int64).reshape(
        B, NUM_FCT_CLASSES, FCT_HIST_BINS)

    def _deficit(vec, b, s):
        real = s.sizes > 0
        return float(vec[b, : s.num_flows][real].sum()) * units[b]

    results = [
        finalize(s, done_step[b, : s.num_flows],
                 _deficit(rem_mid, b, s), _deficit(rem_end, b, s))
        for b, s in enumerate(scenarios)
    ]
    remaining_bytes = [remaining[b, : s.num_flows] * units[b]
                       for b, s in enumerate(scenarios)]
    traces = None
    if trace:
        ys = ys.cpu().numpy().astype(np.float64)
        traces = [ys[b, :, : s.num_flows] * units[b]
                  for b, s in enumerate(scenarios)]
    return FlowBatchResult(results, remaining_bytes, traces,
                           hists=[hist[b] for b in range(B)])


def simulate_grid(
    networks: Sequence[str],
    workloads: Sequence[str],
    loads: Sequence[float],
    seeds: Sequence[int] = (0,),
    engine: str = "auto",
    device: DeviceLike = None,
    **kw,
) -> List[Dict]:
    """The full (network x workload x load x seed) grid in one batched
    run.  Returns one flat row per scenario: the grid coordinates plus
    every `FlowSimResult` field."""
    grid = list(itertools.product(networks, workloads, loads, seeds))
    scenarios = [build_scenario(net, w, load, seed=seed, **kw)
                 for net, w, load, seed in grid]
    batch = simulate_flows_batch(scenarios, engine=engine, device=device)
    rows = []
    for (net, w, load, seed), r in zip(grid, batch.results):
        row = dict(network=net, workload=w, load=float(load), seed=int(seed))
        row.update(dataclasses.asdict(r))
        rows.append(row)
    return rows


def saturation_ladder(
    network: str,
    workload: str,
    loads: Sequence[float],
    seeds: Sequence[int] = (0,),
    engine: str = "auto",
    device: DeviceLike = None,
    **kw,
) -> List[Dict]:
    """A load ladder (loads x seeds) in one batched run; one row per load
    with the seed-majority admission verdict.  `flows.saturation_load`
    stacks two of these into a bisection.  Rows are grouped by grid
    position (loads-major over seeds), never by load value."""
    rows = simulate_grid([network], [workload], loads, seeds=seeds,
                         engine=engine, device=device, **kw)
    n_seeds = len(seeds)
    out = []
    for i, load in enumerate(loads):
        mine = rows[i * n_seeds:(i + 1) * n_seeds]
        out.append(dict(
            load=float(load),
            admitted_frac=float(np.mean([r["admitted"] for r in mine])),
            backlog_frac=float(np.mean([r["backlog_frac"] for r in mine])),
            finished_frac=float(np.mean([r["finished_frac"] for r in mine])),
        ))
    return out
