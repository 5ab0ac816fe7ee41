"""Batched PyTorch flow-level engines (Figs. 7, 9, 10, 11): dense and tiled.

Port of `repro.netsim.flows_jax`.  A batch of flow scenarios
(`flows.FlowScenario`) runs the fixed-dt processor-sharing recurrence of
`flows._oracle_steps` (kept in the JAX package) as a Python loop over
steps, each step a handful of elementwise ops and per-row reductions on
the device (`_serve`, shared by both engines):

  dense  — flow state held as (B, n_max) tensors for the whole horizon,
           with no host sync until the run ends.  Exact per-flow
           completion steps come back to the host, where
           `flows.finalize` turns them into results; `trace=True` also
           keeps every step's remaining bytes (test-sized grids).
  tiled  — each row's flows sorted stably by start step and padded to
           whole tiles, staged once as (B, P) tensors on the device.
           Each chunk of `chunk_steps` steps gathers the (B, W, T)
           window of tiles that are not yet drained and have arrivals,
           runs the steps over it alone and scatters the remaining bytes
           back; drained tiles retire on the device, and the host reads
           back only each row's first live tile once a chunk.  Per-step
           work tracks the concurrently active flows, not the scenario's
           whole lifetime.  Results come out through
           `flows.finalize_streamed` from the device histograms.

Byte quantities are normalized to one NIC-step of service
(``nic_Bps * dt``) so float32 keeps ample mantissa headroom; activation
steps are int32, precomputed on the host.  Completions are counted into
per-class log-spaced FCT histograms (`_hist_accumulate`) with an int32
``index_add_``, so the counts are exact, and both engines bin the same
per-flow values, so their histograms agree bitwise.  Scenarios with
fewer flows than the batch maximum are padded with never-active flows.
The deficit snapshots at the half-horizon and horizon steps are per-flow
vectors against host-staged allowances (`FlowScenario.deficit_allowance`)
in both engines, summed on the host at float64 over real flows in the
scenario's own order, and the tiled engine keeps each flow's completion
time the same way: so padding, the window's width and the engine leave
`backlog_frac` bitwise unchanged (the JAX tiled engine sums the deficit
over its window on the device, whose grouping changes with the width:
ROADMAP Queue 3, R2).

Rows carrying a fault projection (`faults.apply_flow_faults`) route the
whole batch through the faulted step: frozen flows leave the share,
blackholed flows use their share without progress, and each pool is
scaled by the step's surviving capacity.  Fault-free batches run the
unfaulted step.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.netsim.faults import flow_fault_arrays
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
    finalize_streamed,
)

# engine="auto" stays dense below this many flows (largest scenario in
# the batch), as in the JAX package.
TILED_AUTO_FLOWS = 65536
# trace=True materializes a (B, steps, n_max) float stack; refuse
# clearly above this many elements.
TRACE_MAX_ELEMS = 1 << 26
# Tiled-engine geometry defaults, as in the JAX package: tiles of 1024
# flows, a window that starts at 16 tiles and grows by powers of two on
# demand, and 128 steps a chunk between host reads.
DEFAULT_TILE = 1024
DEFAULT_WINDOW_TILES = 16
DEFAULT_CHUNK_STEPS = 128


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


def tiled_state_bytes(window_tiles: int, tile_size: int,
                      batch: int = 1) -> int:
    """Per-step working set of the fault-free tiled engine, as the JAX
    package counts it: f32 rem/rem0/arr_ms, int32 start/class, bool
    is_bulk — 21 B per window slot, whatever the flow count.  (The port
    also keeps every flow staged on the device, ~37 B a flow slot, so
    that no chunk's window crosses the host.)"""
    return batch * window_tiles * tile_size * 21


@dataclasses.dataclass
class _Ops:
    """The staged per-flow tensors of one batch on the device, (B, n)
    (dense: n = n_max; tiled: the sorted rows and a pad column, or one
    chunk's window gathered from them), and the per-row scalars."""

    start: torch.Tensor        # int32 first servable step
    is_bulk: torch.Tensor      # bool
    not_bulk: torch.Tensor     # bool, ~is_bulk
    bins0: torch.Tensor        # int32 first flat histogram bin (row, class)
    arr_ms: torch.Tensor
    allow_mid: Optional[torch.Tensor]   # deficit allowances, NIC units
    allow_end: Optional[torch.Tensor]
    lat_u: torch.Tensor        # (B, 1) latency pool, NIC units
    bulk_u: torch.Tensor       # (B, 1) bulk pool, NIC units
    dt_ms: torch.Tensor        # (B, 1)
    mid_step: np.ndarray       # (B,) host int: deficit snapshot steps
    end_step: np.ndarray
    # fault projection: (B, n) int32 windows, (B, steps) pool scales
    blk_start: Optional[torch.Tensor] = None
    blk_end: Optional[torch.Tensor] = None
    frz_start: Optional[torch.Tensor] = None
    frz_end: Optional[torch.Tensor] = None
    lat_scale: Optional[torch.Tensor] = None
    bulk_scale: Optional[torch.Tensor] = None

    @property
    def faulted(self) -> bool:
        return self.blk_start is not None


# per-flow fields a tiled chunk gathers into its window
_WINDOW_FIELDS = ("start", "is_bulk", "not_bulk", "bins0", "arr_ms")
_FAULT_FIELDS = ("blk_start", "blk_end", "frz_start", "frz_end")


def _serve(rem, step: int, ops: _Ops):
    """One fixed-dt step of processor sharing over (B, n) flows, the step
    of both engines: `flows_jax._flow_step` / `_tiled_step` and, for a
    faulted batch, `_flow_step_faulted` / `_tiled_step_faulted`, with a
    leading batch axis.  Mirrors `flows._oracle_steps` (normalized units:
    every flow's per-step NIC budget is 1.0); change them together.
    Each pool's share is its capacity over its active count, a sum of
    exact small integers, so any grouping of the flows gives the same
    bits.  Returns the new remaining bytes and the flows that finished
    in this step (a flow is active only while it has bytes, and never
    goes below 0, so it finishes once)."""
    active = (step >= ops.start) & (rem > 0)
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
    newly = None
    for pool_u, mask in ((lat_u, sharing & ops.not_bulk),
                         (bulk_u, sharing & ops.is_bulk)):
        m = mask.to(rem.dtype)
        k = m.sum(1, keepdim=True)
        # an empty pool's share is 0 / k = 0, as the reference's
        # where(pool > 0, share, 0) makes it
        share = (pool_u / k.clamp(min=1.0)).clamp(max=1.0)
        if ops.faulted:
            m = (mask & ~blackhole).to(rem.dtype)
        rem = rem - torch.minimum(rem, share) * m
        done = mask & (rem <= 0)
        newly = done if newly is None else newly | done
    return rem, newly


def _hist_accumulate(hist, newly, bins0, step: int, arr_ms, dt_ms, ln2):
    """Count newly-finished flows into the (B, classes * bins) int32
    histogram (`flows.fct_bin`'s device twin) and return every flow's
    completion time if it finished now.  `bins0` is each flow's first
    bin in the flat view of `hist` (its row's and its class's).  log2 is
    log(x) / log(2), as ``jnp.log2`` computes it, with log(2) a float32
    tensor on the device (a Python divisor becomes a multiply by its
    reciprocal on CUDA)."""
    fct_ms = dt_ms * (step + 1) - arr_ms
    safe = torch.where(newly, fct_ms, 1.0)
    b = torch.floor((torch.log(safe) / ln2 - FCT_HIST_LO_LOG2)
                    * (1.0 / FCT_BIN_LOG2_WIDTH))
    b = b.clamp(0, FCT_HIST_BINS - 1).to(torch.int32)
    hist.view(-1).index_add_(0, (bins0 + b).reshape(-1),
                             newly.reshape(-1).to(hist.dtype))
    return fct_ms


def _snapshot_rows(steps: np.ndarray, step: int, dev: torch.device):
    """Rows whose deficit snapshot falls on `step`: None for none, True
    for all, else a (B, 1) bool mask on the device."""
    hit = steps == step
    if not hit.any():
        return None
    if hit.all():
        return True
    return torch.as_tensor(hit, device=dev)[:, None]


def _new_hist(bsz: int, dev: torch.device):
    return torch.zeros((bsz, NUM_FCT_CLASSES * FCT_HIST_BINS),
                       dtype=torch.int32, device=dev)


def _ln2(like: torch.Tensor):
    return torch.log(torch.full((), 2.0, dtype=like.dtype,
                                device=like.device))


def _run_batch(remaining0, ops: _Ops, num_steps: int, trace: bool):
    """The dense step loop: `num_steps` steps of `_serve`, state on the
    device.  Returns (remaining, done_step, rem_mid, rem_end, hist,
    trace) with trace (B, steps, n_max) or None; rem_mid and rem_end are
    the per-flow deficits at each row's snapshot steps."""
    bsz, dev = remaining0.shape[0], remaining0.device
    remaining = remaining0
    done_step = torch.full_like(ops.start, -1)
    snaps = [torch.zeros_like(remaining0), torch.zeros_like(remaining0)]
    hist = _new_hist(bsz, dev)
    ln2 = _ln2(remaining0)
    ys = (remaining0.new_empty((bsz, num_steps, remaining0.shape[1]))
          if trace else None)
    for step in range(num_steps):
        for i, (at, allow) in enumerate(((ops.mid_step, ops.allow_mid),
                                         (ops.end_step, ops.allow_end))):
            rows = _snapshot_rows(at, step, dev)
            if rows is not None:
                d = (remaining - allow).clamp(min=0.0)
                snaps[i] = d if rows is True else torch.where(rows, d,
                                                              snaps[i])
        remaining, newly = _serve(remaining, step, ops)
        done_step = torch.where(newly, step + 1, done_step)
        _hist_accumulate(hist, newly, ops.bins0, step, ops.arr_ms,
                         ops.dt_ms, ln2)
        if trace:
            ys[:, step] = remaining
    return remaining, done_step, snaps[0], snaps[1], hist, ys


@dataclasses.dataclass
class FlowBatchResult:
    """Batched engine output: one `FlowSimResult` per scenario (dense:
    `flows.finalize` on exact completion steps; tiled:
    `flows.finalize_streamed` on the device histograms), the per-flow
    remaining bytes at the end of the run, each scenario's (classes,
    bins) completion-time histogram, in trace mode each scenario's
    (steps, n) remaining-bytes trajectory, and the tiled engine's
    largest window in tiles."""

    results: List[FlowSimResult]
    remaining_bytes: List[np.ndarray]       # (n_b,) per scenario
    traces: Optional[List[np.ndarray]] = None
    hists: Optional[List[np.ndarray]] = None
    peak_window_tiles: Optional[int] = None  # tiled engine only


def _stage(scenarios: Sequence[FlowScenario], num_steps: int, width: int,
           dtype: torch.dtype, dev: torch.device, orders=None):
    """Host float64 staging, cast once at the device boundary: the
    initial (B, width) remaining bytes in NIC units, the scenario
    tensors, and each row's NIC unit in bytes.  `orders` permutes each
    row's flows (the tiled engine's sort); slots past a row's flows are
    pads: no bytes, start "never", NEVER fault windows."""
    B = len(scenarios)
    H = NUM_FCT_CLASSES * FCT_HIST_BINS
    remaining0 = np.zeros((B, width))
    start = np.full((B, width), num_steps + 1, np.int32)
    is_bulk = np.zeros((B, width), bool)
    allow_mid = np.zeros((B, width))
    allow_end = np.zeros((B, width))
    bins0 = np.repeat(np.arange(B, dtype=np.int32)[:, None] * H, width, 1)
    arr_ms = np.zeros((B, width))
    lat_u, bulk_u, dt_ms = (np.zeros((B, 1)) for _ in range(3))
    units = np.zeros(B)
    faulted = any(s.has_faults for s in scenarios)
    if faulted:
        # NEVER windows for fault-free rows and pad flows, unit scales
        # for fault-free rows: the faulted step is then the plain one.
        windows = [np.empty((B, width), np.int32) for _ in range(4)]
        scales = [np.empty((B, num_steps), np.float32) for _ in range(2)]
    for b, s in enumerate(scenarios):
        n = s.num_flows
        o = slice(None) if orders is None else orders[b]
        unit = s.nic_Bps * s.dt_s          # bytes one NIC serves per step
        units[b] = unit
        remaining0[b, :n] = s.sizes[o] / unit
        start[b, :n] = s.start_step[o]
        is_bulk[b, :n] = s.is_bulk[o]
        allow_mid[b, :n] = s.deficit_allowance(s.mid_step)[o] / unit
        allow_end[b, :n] = s.deficit_allowance(s.end_step)[o] / unit
        bins0[b, :n] += fct_class_id(s.sizes[o]) * FCT_HIST_BINS
        arr_ms[b, :n] = s.arr[o] * 1e3
        lat_u[b] = s.lat_pool_Bps / s.nic_Bps
        bulk_u[b] = s.bulk_pool_Bps / s.nic_Bps
        dt_ms[b] = s.dt_s * 1e3
        if faulted:
            *wins, lat, blk = flow_fault_arrays(
                s, num_steps, order=None if orders is None else orders[b],
                pad_to=width)
            for w, v in zip(windows, wins):
                w[b] = v
            scales[0][b], scales[1][b] = lat, blk

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def i(a):
        return torch.as_tensor(a, device=dev)

    bulk = i(is_bulk)
    ops = _Ops(start=i(start), is_bulk=bulk, not_bulk=~bulk, bins0=i(bins0),
               arr_ms=f(arr_ms), allow_mid=f(allow_mid),
               allow_end=f(allow_end), lat_u=f(lat_u), bulk_u=f(bulk_u),
               dt_ms=f(dt_ms),
               mid_step=np.array([s.mid_step for s in scenarios]),
               end_step=np.array([s.end_step for s in scenarios]))
    if faulted:
        (ops.blk_start, ops.blk_end, ops.frz_start,
         ops.frz_end) = map(i, windows)
        ops.lat_scale, ops.bulk_scale = map(f, scales)
    return f(remaining0), ops, units


def _deficit(vec: np.ndarray, s: FlowScenario, unit: float) -> float:
    """A row's per-flow deficit vector (the scenario's own flow order)
    summed at float64 over real flows, in bytes."""
    return float(vec[: s.num_flows][s.sizes > 0].sum()) * unit


def _window(ops: _Ops, idx: torch.Tensor) -> _Ops:
    """One chunk's (B, W * T) window of the staged flows: row b's slots
    `idx[b]` (its live tiles, then the pad column)."""
    names = _WINDOW_FIELDS + (_FAULT_FIELDS if ops.faulted else ())
    return dataclasses.replace(ops, allow_mid=None, allow_end=None, **{
        name: getattr(ops, name).gather(1, idx) for name in names})


def _simulate_flows_tiled(scenarios: Sequence[FlowScenario], num_steps: int,
                          dtype: torch.dtype, dev: torch.device,
                          tile_size: int, window_tiles: int,
                          chunk_steps: int) -> FlowBatchResult:
    """The tiled streaming engine (`flows_jax._simulate_flows_tiled`), its
    window kept on the device.

    Each row's flows are staged once, sorted stably by start step into
    tiles of T, as (B, P + 1) tensors: P is the largest row's tiles
    times T, and the last column is a pad slot.  Before each chunk the
    host picks each row's window: its tiles from `lo[b]`, the first not
    yet drained, up to the last tile with an arrival before the chunk
    ends (a searchsorted over the tiles' first start steps, which are
    static).  The window's capacity W grows by powers of two when a row
    outgrows it; slots past a row's own width read and write the pad
    slot, which stays at no bytes.  The chunk gathers the window, runs
    its steps, and scatters the remaining bytes and completion times
    back; then a drained flag per tile advances `lo` over each row's
    drained prefix on the device, and the host reads back only `lo`.
    Chunks where every window is empty are skipped."""
    B, T, C = len(scenarios), int(tile_size), int(chunk_steps)
    orders = [np.argsort(s.start_step, kind="stable") for s in scenarios]
    ntiles = np.array([max(-(-s.num_flows // T), 1) for s in scenarios])
    P = int(ntiles.max()) * T
    first_start = []               # per row: each tile's first start step
    for s, o in zip(scenarios, orders):
        st = s.start_step[o][::T].astype(np.int64)
        first_start.append(np.concatenate(
            [st, np.full(int(ntiles.max()) - len(st), num_steps + 1)]))
    rem, ops, units = _stage(scenarios, num_steps, P + 1, dtype, dev, orders)
    fct = torch.zeros_like(rem)                 # completion times, ms
    snaps = [torch.zeros_like(rem), torch.zeros_like(rem)]
    hist = _new_hist(B, dev)
    ln2 = _ln2(rem)
    ntiles_dev = torch.as_tensor(ntiles, device=dev)
    lo = np.zeros(B, np.int64)
    lo_dev = torch.zeros(B, dtype=torch.int64, device=dev)
    W, peak_w, c0 = int(window_tiles), 0, 0
    while c0 < num_steps:
        chunk_end = min(c0 + C, num_steps)
        ws = np.maximum([np.searchsorted(fs, chunk_end, "left")
                         for fs in first_start] - lo, 0)
        peak_w = max(peak_w, int(ws.max()))
        if ws.max() == 0:
            if (lo >= ntiles).all():
                break
            c0 += C
            continue
        while ws.max() > W:
            W *= 2
        slot = torch.arange(W * T, device=dev)
        live = (slot // T)[None, :] < torch.as_tensor(ws, device=dev)[:, None]
        idx = torch.where(live, lo_dev[:, None] * T + slot, P)
        win = _window(ops, idx)
        r, f = rem.gather(1, idx), fct.gather(1, idx)
        for step in range(c0, chunk_end):
            for i, (at, allow) in enumerate(((ops.mid_step, ops.allow_mid),
                                             (ops.end_step, ops.allow_end))):
                rows = _snapshot_rows(at, step, dev)
                if rows is not None:
                    d = (r - allow.gather(1, idx)).clamp(min=0.0)
                    if rows is not True:
                        d = torch.where(rows, d, snaps[i].gather(1, idx))
                    snaps[i].scatter_(1, idx, d)
            r, newly = _serve(r, step, win)
            f = torch.where(newly, _hist_accumulate(
                hist, newly, win.bins0, step, win.arr_ms, win.dt_ms, ln2), f)
        rem.scatter_(1, idx, r)
        fct.scatter_(1, idx, f)
        drained = (rem[:, :P].unflatten(1, (-1, T)) == 0).all(2)
        lo_dev = torch.minimum(drained.int().cumprod(1).sum(1), ntiles_dev)
        lo = lo_dev.cpu().numpy()
        c0 += C

    # Back to each scenario's own flow order on the host, at float64.
    hists = hist.cpu().numpy().astype(np.int64).reshape(
        B, NUM_FCT_CLASSES, FCT_HIST_BINS)
    host = [t[:, :P].cpu().numpy().astype(np.float64)
            for t in (rem, fct, snaps[0], snaps[1])]
    results, remaining_bytes = [], []
    for b, (s, o) in enumerate(zip(scenarios, orders)):
        n = s.num_flows
        rem_b, fct_b, mid_b, end_b = (np.empty(n) for _ in range(4))
        for out, t in zip((rem_b, fct_b, mid_b, end_b), host):
            out[o] = t[b, :n]
        results.append(finalize_streamed(
            s, hists[b], float(fct_b[s.sizes > 0].sum()),
            _deficit(mid_b, s, units[b]), _deficit(end_b, s, units[b])))
        remaining_bytes.append(rem_b * units[b])
    return FlowBatchResult(results, remaining_bytes, traces=None,
                           hists=[hists[b] for b in range(B)],
                           peak_window_tiles=peak_w)


def simulate_flows_batch(
    scenarios: Sequence[FlowScenario],
    dtype: torch.dtype = torch.float32,
    trace: bool = False,
    engine: str = "auto",
    device: DeviceLike = None,
    tile_size: int = DEFAULT_TILE,
    window_tiles: int = DEFAULT_WINDOW_TILES,
    chunk_steps: int = DEFAULT_CHUNK_STEPS,
) -> FlowBatchResult:
    """Simulate a batch of flow scenarios on the dense or tiled engine.

    All scenarios must share dt/horizon/tail (one step count); flow
    counts may differ, and shorter rows are padded with never-active
    flows.  Rows carrying a fault projection route the whole batch
    through the faulted step; fault-free batches run the unfaulted one.
    ``engine="auto"`` picks tiled once the largest scenario reaches
    `TILED_AUTO_FLOWS` flows (trace mode forces dense and is size-gated
    by `TRACE_MAX_ELEMS`).  ``tile_size``, ``window_tiles`` and
    ``chunk_steps`` shape the tiled engine only.  ``device=None`` runs
    on the CUDA card and raises without one; ``device="cpu"`` runs on
    the CPU."""
    dev = resolve_device(device)
    if not scenarios:
        return FlowBatchResult([], [])
    steps = {s.steps for s in scenarios}
    if len(steps) != 1:
        raise ValueError(f"scenarios disagree on step count: {sorted(steps)}")
    num_steps = steps.pop()
    n_max = max(s.num_flows for s in scenarios)
    B = len(scenarios)
    resolved = resolve_flow_engine(engine, n_max, trace)
    if trace:
        if resolved != "dense":
            raise ValueError("trace=True is dense-only: the tiled engine "
                             "never materializes per-flow trajectories")
        elems = B * num_steps * n_max
        if elems > TRACE_MAX_ELEMS:
            raise ValueError(
                f"trace=True would materialize a ({B}, {num_steps}, "
                f"{n_max}) remaining-bytes stack ({elems:,} elements > "
                f"TRACE_MAX_ELEMS={TRACE_MAX_ELEMS:,}); trace mode is for "
                "test-sized grids — drop trace or shrink the scenario")
    if resolved == "tiled":
        return _simulate_flows_tiled(scenarios, num_steps, dtype, dev,
                                     tile_size, window_tiles, chunk_steps)

    remaining0, ops, units = _stage(scenarios, num_steps, n_max, dtype, dev)
    remaining, done_step, rem_mid, rem_end, hist, ys = _run_batch(
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
    results = [
        finalize(s, done_step[b, : s.num_flows],
                 _deficit(rem_mid[b], s, units[b]),
                 _deficit(rem_end[b], s, units[b]))
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
    tile_size: int = DEFAULT_TILE,
    window_tiles: int = DEFAULT_WINDOW_TILES,
    chunk_steps: int = DEFAULT_CHUNK_STEPS,
    **kw,
) -> List[Dict]:
    """The full (network x workload x load x seed) grid in one batched
    run (dense: one step loop; tiled: one chunk loop whose every chunk
    covers the grid).  Returns one flat row per scenario: the grid
    coordinates plus every `FlowSimResult` field."""
    grid = list(itertools.product(networks, workloads, loads, seeds))
    scenarios = [build_scenario(net, w, load, seed=seed, **kw)
                 for net, w, load, seed in grid]
    batch = simulate_flows_batch(
        scenarios, engine=engine, device=device, tile_size=tile_size,
        window_tiles=window_tiles, chunk_steps=chunk_steps)
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
