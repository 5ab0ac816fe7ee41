"""Flow-level scenarios and results (Figs. 7, 9, 10, 11).

Copy of the framework-free half of `repro.netsim.flows`; keep the two
in step.  Flows arrive Poisson at a target load (fraction of aggregate
host-link capacity), draw sizes from a published distribution, and are
served by per-class capacity pools:

  Opera:   <15 MB -> latency pool (immediate, multi-hop, taxed);
           >=15 MB -> bulk pool (direct circuits, tax-free) after a
           uniform wait for the right slice (<= one cycle).
  static:  a single pool (expander: taxed multi-hop; Clos: direct but
           core-capacity-bound).

`build_scenario` freezes a scenario's arrivals, sizes and pools into a
`FlowScenario`; `flows_torch` runs the fixed-dt processor-sharing
recurrence on it, and `finalize` turns raw completion steps into a
`FlowSimResult` (`finalize_streamed` does the same from log-binned
completion histograms).  The float64 numpy oracle of the recurrence
(`_oracle_steps`, `simulate`) stays in the JAX package, where the
parity tests use it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import DeviceLike
from repro_torch.netsim import capacity as C
from repro_torch.netsim.workloads import mean_flow_size, sample_flow_sizes

BULK_CUTOFF = 15e6
NETWORKS = ("opera", "expander", "clos", "rotornet")

# ---------------- streamed FCT histograms ------------------------------
# Log-spaced completion-time bins shared by the engines' on-device
# accumulators and the host-side quantile reconstruction.  96 bins over
# [0.01 ms, 100 s] is ~1.19x per bin, so a histogram-derived percentile
# is within one bin (< 19% relative) of the exact order statistic —
# the resolution the paper's log-scale FCT figures plot at.  Flows
# outside the range land in the edge bins (clipped, never dropped), so
# per-class counts stay exact.
FCT_HIST_LO_MS = 1e-2
FCT_HIST_HI_MS = 1e5
FCT_HIST_BINS = 96
NUM_FCT_CLASSES = 3            # small (<100 KB) / mid / large (>= cutoff)
FCT_HIST_LO_LOG2 = float(np.log2(FCT_HIST_LO_MS))
FCT_BIN_LOG2_WIDTH = float(
    (np.log2(FCT_HIST_HI_MS) - np.log2(FCT_HIST_LO_MS)) / FCT_HIST_BINS
)


def fct_hist_edges() -> np.ndarray:
    """(FCT_HIST_BINS + 1,) bin edges in ms."""
    return 2.0 ** (
        FCT_HIST_LO_LOG2 + np.arange(FCT_HIST_BINS + 1) * FCT_BIN_LOG2_WIDTH
    )


def fct_class_id(sizes: np.ndarray) -> np.ndarray:
    """(n,) int32 size-class index: 0 small, 1 mid, 2 large."""
    return np.where(
        sizes >= BULK_CUTOFF, 2, np.where(sizes >= 100e3, 1, 0)
    ).astype(np.int32)


def fct_bin(fct_ms: np.ndarray) -> np.ndarray:
    """(n,) histogram bin index per completion time — the host reference
    for the device-side binning in `flows_torch._hist_accumulate`."""
    with np.errstate(divide="ignore"):
        b = np.floor(
            (np.log2(np.asarray(fct_ms, np.float64)) - FCT_HIST_LO_LOG2)
            / FCT_BIN_LOG2_WIDTH
        )
    return np.clip(b, 0, FCT_HIST_BINS - 1).astype(np.int64)


@dataclasses.dataclass
class FlowSimResult:
    load: float
    fct_p99_ms_small: float      # flows < 100 KB
    fct_p99_ms_mid: float        # 100 KB .. 15 MB
    fct_p99_ms_large: float      # >= 15 MB
    fct_mean_ms: float
    admitted: bool               # backlog stable at this load?
    finished_frac: float
    backlog_frac: float = 0.0    # unserved fraction at end of arrivals


@dataclasses.dataclass
class FlowScenario:
    """One frozen (network, workload, load, seed) draw: everything the
    fixed-dt recurrence needs, with times pre-discretized to step
    indices so the numpy oracle and the engines see bit-identical
    activation schedules."""

    network: str
    workload: str
    load: float
    seed: int
    horizon_s: float
    dt_s: float
    tail_s: float
    num_hosts: int
    link_gbps: float
    arr: np.ndarray              # (n,) arrival time [s]
    sizes: np.ndarray            # (n,) flow size [bytes]
    start_step: np.ndarray       # (n,) first step the flow is servable
    is_bulk: np.ndarray          # (n,) bool: bulk-pool class
    lat_pool_Bps: float          # latency-class pool [bytes/s]
    bulk_pool_Bps: float         # bulk-class pool [bytes/s]
    # Optional fault projection (faults.apply_flow_faults) — all six are
    # set together.  Windows are [start, end) step intervals per flow:
    # a *blackholed* flow keeps consuming its pool share with zero
    # progress (retransmits into a dead circuit, pre-detection); a
    # *frozen* flow (behind a detected-dead ToR) gets no share and no
    # progress until recovery, then retries.  Scales are (steps,)
    # per-step pool-capacity multipliers for detected capacity loss.
    blk_start: Optional[np.ndarray] = None   # (n,) int32
    blk_end: Optional[np.ndarray] = None     # (n,) int32
    frz_start: Optional[np.ndarray] = None   # (n,) int32
    frz_end: Optional[np.ndarray] = None     # (n,) int32
    lat_scale: Optional[np.ndarray] = None   # (steps,) float64
    bulk_scale: Optional[np.ndarray] = None  # (steps,) float64

    @property
    def has_faults(self) -> bool:
        return self.blk_start is not None

    @property
    def num_flows(self) -> int:
        return int(self.arr.size)

    @property
    def nic_Bps(self) -> float:
        return self.link_gbps * 1e9 / 8.0

    @property
    def steps(self) -> int:
        return int(self.horizon_s / self.dt_s) + int(self.tail_s / self.dt_s)

    @property
    def mid_step(self) -> int:
        """First step at which t >= horizon/2 (backlog snapshot)."""
        return int(np.ceil(self.horizon_s / 2 / self.dt_s))

    @property
    def end_step(self) -> int:
        """First step at which t >= horizon (backlog snapshot)."""
        return int(np.ceil(self.horizon_s / self.dt_s))

    def arrived_mask(self, step: int) -> np.ndarray:
        return self.arr <= step * self.dt_s

    def deficit_allowance(self, step: int) -> np.ndarray:
        """Per-flow remaining bytes a *dedicated NIC* would still have at
        `step`: sizes - nic * time-since-start (clipped).  Backlog above
        this floor is a genuine service deficit; backlog below it is
        just bytes no network could have moved yet (e.g. a 1 GB flow
        that arrived moments before the snapshot), which must not count
        against admission."""
        elapsed_s = np.maximum(step - self.start_step, 0) * self.dt_s
        return self.sizes - np.minimum(self.sizes, self.nic_Bps * elapsed_s)


def build_scenario(
    network: str,                 # opera | expander | clos | rotornet
    workload: str,                # datamining | websearch | hadoop
    load: float,
    num_hosts: int = 648,
    link_gbps: float = 10.0,
    horizon_s: float = 2.0,
    dt_s: float = 2e-4,
    base_rtt_us: float = 20.0,
    cycle_ms: float = 10.7,
    seed: int = 0,
    tail_s: float = 0.5,
) -> FlowScenario:
    rng = np.random.default_rng(seed)
    agg_bps = num_hosts * link_gbps * 1e9
    mean_sz = mean_flow_size(workload)
    lam = load * agg_bps / 8.0 / mean_sz  # flows / s

    n = max(int(lam * horizon_s), 1)
    arr = np.sort(rng.uniform(0, horizon_s, n))
    sizes = sample_flow_sizes(workload, n, rng)

    op = C.OPERA_648_PT
    ex = C.EXPANDER_650_PT
    if network == "opera":
        lat_pool = C.latency_capacity(op) * agg_bps / 8.0
        bulk_pool = C.bulk_capacity_opera(op) * agg_bps / 8.0
        is_bulk = sizes >= BULK_CUTOFF
        start_delay = np.where(
            is_bulk, rng.uniform(0, cycle_ms / 1e3, n), base_rtt_us * 1e-6
        )
    elif network == "rotornet":
        # non-hybrid RotorNet: EVERYTHING waits for direct circuits
        lat_pool = 0.0
        bulk_pool = C.bulk_capacity_opera(op) * agg_bps / 8.0
        is_bulk = np.ones(n, bool)
        start_delay = rng.uniform(0, cycle_ms / 1e3, n)
    elif network == "expander":
        lat_pool = C.latency_capacity(ex) * agg_bps / 8.0
        bulk_pool = 0.0
        is_bulk = np.zeros(n, bool)
        start_delay = np.full(n, base_rtt_us * 1e-6)
    elif network == "clos":
        lat_pool = C.clos_capacity(3.0) * agg_bps / 8.0
        bulk_pool = 0.0
        is_bulk = np.zeros(n, bool)
        start_delay = np.full(n, base_rtt_us * 1e-6)
    else:
        raise ValueError(network)

    return FlowScenario(
        network=network,
        workload=workload,
        load=load,
        seed=seed,
        horizon_s=horizon_s,
        dt_s=dt_s,
        tail_s=tail_s,
        num_hosts=num_hosts,
        link_gbps=link_gbps,
        arr=arr,
        sizes=sizes,
        start_step=np.ceil((arr + start_delay) / dt_s).astype(np.int32),
        is_bulk=is_bulk,
        lat_pool_Bps=float(lat_pool),
        bulk_pool_Bps=float(bulk_pool),
    )


def build_mixed_scenario(
    ws_load: float,
    bulk_load: float,
    num_hosts: int = 648,
    link_gbps: float = 10.0,
    horizon_s: float = 1.0,
    dt_s: float = 2e-4,
    base_rtt_us: float = 20.0,
    cycle_ms: float = 10.7,
    bulk_flow_bytes: float = 64e6,
    seed: int = 0,
    tail_s: float = 0.0,
) -> FlowScenario:
    """Fig. 10's mixed offering on Opera pools: Websearch flows at
    `ws_load` on the latency path plus fixed-size (>= cutoff) bulk flows
    offering `bulk_load` of host bandwidth on the direct-circuit path.

    The bulk pool only gets the fabric slots the latency class leaves:
    admitted latency load x consumes x * avg_hops link-slots (the
    wire-byte tax), exactly the accounting of fig10's analytic column —
    so the flow-measured aggregate throughput is an end-to-end
    cross-check of that model."""
    rng = np.random.default_rng(seed)
    agg_Bps = num_hosts * link_gbps * 1e9 / 8.0

    n_ws = max(int(ws_load * agg_Bps / mean_flow_size("websearch") * horizon_s), 0)
    arr_ws = np.sort(rng.uniform(0, horizon_s, n_ws))
    sz_ws = sample_flow_sizes("websearch", n_ws, rng)

    n_bk = max(int(bulk_load * agg_Bps / bulk_flow_bytes * horizon_s), 1)
    arr_bk = np.sort(rng.uniform(0, horizon_s, n_bk))
    sz_bk = np.full(n_bk, bulk_flow_bytes)

    arr = np.concatenate([arr_ws, arr_bk])
    sizes = np.concatenate([sz_ws, sz_bk])
    is_bulk = np.concatenate([np.zeros(n_ws, bool), np.ones(n_bk, bool)])
    delay = np.concatenate(
        [np.full(n_ws, base_rtt_us * 1e-6),
         rng.uniform(0, cycle_ms / 1e3, n_bk)]
    )
    op = C.OPERA_648_PT
    ws_adm = min(ws_load, C.latency_capacity(op))
    slots = op.duty * op.u / op.d
    bulk_frac = max(C.ETA_DIRECT * (slots - ws_adm * op.avg_hops), 0.0)
    return FlowScenario(
        network="opera",
        workload="mixed-ws-bulk",
        load=ws_load + bulk_load,
        seed=seed,
        horizon_s=horizon_s,
        dt_s=dt_s,
        tail_s=tail_s,
        num_hosts=num_hosts,
        link_gbps=link_gbps,
        arr=arr,
        sizes=sizes,
        start_step=np.ceil((arr + delay) / dt_s).astype(np.int32),
        is_bulk=is_bulk,
        lat_pool_Bps=float(C.latency_capacity(op) * agg_Bps),
        bulk_pool_Bps=float(bulk_frac * agg_Bps),
    )


def percentile_fct(fct_ms: np.ndarray, sel: np.ndarray, ok: np.ndarray) -> float:
    """99th-percentile FCT of the selected class, robust to small n.

    - empty class (no flows sampled): 0.0 — a documented sentinel that
      keeps benchmark JSON and `summarize` means finite;
    - unfinished flows present and <5 finished: +inf (overload signal);
    - otherwise: the finite empirical percentile over finished flows,
      however few there are.
    """
    if not sel.any():
        return 0.0
    done = sel & ok
    if done.sum() == 0:
        return float("inf")
    if (sel & ~ok).any() and done.sum() < 5:
        return float("inf")
    return float(np.percentile(fct_ms[done], 99))


def hist_percentile(hist: np.ndarray, q: float) -> float:
    """Quantile of a log-binned FCT histogram, numpy.percentile-
    compatible: the rank is interpolated between the two bracketing
    order statistics exactly as np.percentile's linear rule, but each
    order statistic is represented by its bin's geometric center — so
    the result is within one bin of the exact empirical percentile."""
    hist = np.asarray(hist, np.int64)
    k = int(hist.sum())
    if k == 0:
        return float("nan")
    edges = fct_hist_edges()
    centers = np.sqrt(edges[:-1] * edges[1:])
    cum = np.cumsum(hist)
    p = (k - 1) * (q / 100.0)
    lo_rank = int(np.floor(p)) + 1            # 1-indexed order statistic
    frac = p - np.floor(p)
    v_lo = centers[np.searchsorted(cum, lo_rank)]
    v_hi = centers[np.searchsorted(cum, min(lo_rank + 1, k))]
    return float(v_lo * (v_hi / v_lo) ** frac)


def percentile_fct_streamed(
    hist_class: np.ndarray, n_class: int, done_class: int
) -> float:
    """`percentile_fct`'s sentinel semantics on a streamed histogram:
    0.0 for an empty class, +inf for the overload signals, else the
    histogram-quantile 99th percentile."""
    if n_class == 0:
        return 0.0
    if done_class == 0:
        return float("inf")
    if n_class > done_class and done_class < 5:
        return float("inf")
    return hist_percentile(hist_class, 99.0)


def _stability(scn: FlowScenario, rem_mid: float, rem_end: float) -> float:
    """Deficit-growth fraction over the second half of the arrival
    window.  Stable systems hold the NIC-bound service deficit
    ~stationary; overloaded ones grow it by (1 - capacity/load) of the
    newly offered work.  (Raw backlog would flag heavy-tailed low
    loads: one 1 GB flow arriving just before the snapshot IS backlog,
    but no network could have served it yet.)

    Zero-size pad flows are masked out *before* the sums (not just as
    zero addends): numpy's pairwise summation regroups with array
    length, so padded and unpadded scenarios would otherwise differ in
    the last ulp."""
    sizes = scn.sizes
    real = sizes > 0
    arrived_mid = float(sizes[real & scn.arrived_mask(scn.mid_step)].sum())
    arrived_end = float(sizes[real & scn.arrived_mask(scn.end_step)].sum())
    newly_offered = max(arrived_end - arrived_mid, 1.0)
    return max(rem_end - rem_mid, 0.0) / newly_offered


def finalize(
    scn: FlowScenario,
    done_step: np.ndarray,
    rem_mid: float,
    rem_end: float,
) -> FlowSimResult:
    """Raw completion steps -> FlowSimResult.  Shared verbatim by the
    numpy oracle and the batched engines.  Zero-size flows are
    padding (never servable, never finished) and are excluded from
    every class mask and fraction, so padded and unpadded scenarios
    finalize identically."""
    ok = done_step >= 0
    fct_ms = np.where(ok, done_step * scn.dt_s - scn.arr, np.inf) * 1e3
    sizes = scn.sizes
    real = sizes > 0
    small = real & (sizes < 100e3)
    mid = real & (sizes >= 100e3) & (sizes < BULK_CUTOFF)
    large = sizes >= BULK_CUTOFF
    growth = _stability(scn, rem_mid, rem_end)
    return FlowSimResult(
        load=scn.load,
        fct_p99_ms_small=percentile_fct(fct_ms, small, ok),
        fct_p99_ms_mid=percentile_fct(fct_ms, mid, ok),
        fct_p99_ms_large=percentile_fct(fct_ms, large, ok),
        fct_mean_ms=float(np.mean(fct_ms[ok])) if ok.any() else float("inf"),
        admitted=growth < 0.08,
        finished_frac=float(ok[real].mean()) if real.any() else 1.0,
        backlog_frac=growth,
    )


def finalize_streamed(
    scn: FlowScenario,
    hist: np.ndarray,
    fct_sum_ms: float,
    rem_mid: float,
    rem_end: float,
) -> FlowSimResult:
    """`finalize` from streamed accumulators instead of per-flow
    completion steps: a (NUM_FCT_CLASSES, FCT_HIST_BINS) completion
    histogram and the summed completion time.  Every finished flow
    lands in exactly one (clipped) bin, so per-class finished counts
    are the exact histogram row sums; percentiles are histogram
    quantiles (within one bin of the exact statistic)."""
    hist = np.asarray(hist, np.int64).reshape(NUM_FCT_CLASSES, FCT_HIST_BINS)
    sizes = scn.sizes
    real = sizes > 0
    cls = fct_class_id(sizes)
    n_cls = [int((real & (cls == c)).sum()) for c in range(NUM_FCT_CLASSES)]
    done_cls = hist.sum(axis=1)
    done_total = int(done_cls.sum())
    n_real = int(real.sum())
    growth = _stability(scn, rem_mid, rem_end)
    return FlowSimResult(
        load=scn.load,
        fct_p99_ms_small=percentile_fct_streamed(hist[0], n_cls[0], int(done_cls[0])),
        fct_p99_ms_mid=percentile_fct_streamed(hist[1], n_cls[1], int(done_cls[1])),
        fct_p99_ms_large=percentile_fct_streamed(hist[2], n_cls[2], int(done_cls[2])),
        fct_mean_ms=(
            float(fct_sum_ms) / done_total if done_total else float("inf")
        ),
        admitted=growth < 0.08,
        finished_frac=done_total / n_real if n_real else 1.0,
        backlog_frac=growth,
    )


# ---------------- saturation knee --------------------------------------


@dataclasses.dataclass
class SaturationResult:
    """Knee of the admission curve.  `beyond_grid` is True when the
    network still admits the configured ceiling — the knee is a lower
    bound, not a measurement (the old coarse grid silently clipped at
    0.45 and made this case indistinguishable from a real knee)."""

    load: float
    beyond_grid: bool
    ladder: List[Dict]

    def __float__(self) -> float:
        return self.load


def saturation_load(
    network: str,
    workload: str,
    ceiling: float = 0.60,
    floor: float = 0.02,
    coarse_points: int = 8,
    refine_points: int = 5,
    seeds: Sequence[int] = (0,),
    engine: str = "auto",
    device: DeviceLike = None,
    **kw,
) -> SaturationResult:
    """Admission knee by batched bisection up to a configurable ceiling.

    Two rounds of load ladders (`flows_torch.saturation_ladder`, each
    one batched run): a coarse grid on [floor, ceiling], then a fine
    grid inside the bracket where admission flips.  A load is admitted
    when the majority of seeds admit it."""
    from repro_torch.netsim.flows_torch import saturation_ladder

    kw.setdefault("horizon_s", 1.0)

    def knee(loads: np.ndarray) -> Tuple[float, Optional[float], List[Dict]]:
        rows = saturation_ladder(network, workload, loads, seeds=seeds,
                                 engine=engine, device=device, **kw)
        last_ok, first_bad = 0.0, None
        for r in rows:
            if r["admitted_frac"] > 0.5:
                last_ok = r["load"]
            elif first_bad is None:
                first_bad = r["load"]
        return last_ok, first_bad, rows

    coarse = np.linspace(floor, ceiling, coarse_points)
    last_ok, first_bad, ladder = knee(coarse)
    if first_bad is None:
        return SaturationResult(load=ceiling, beyond_grid=True, ladder=ladder)
    if refine_points > 0 and first_bad > last_ok and last_ok > 0.0:
        fine = np.linspace(last_ok, first_bad, refine_points + 2)[1:-1]
        fine_ok, _, fine_rows = knee(fine)
        ladder = sorted(ladder + fine_rows, key=lambda r: r["load"])
        last_ok = max(last_ok, fine_ok)
    return SaturationResult(load=last_ok, beyond_grid=False, ladder=ladder)
