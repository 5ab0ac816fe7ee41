"""Scenario-sweep runners over the batched PyTorch engines.

Port of `repro.netsim.sweep`.  `run_sweep` fans a grid of Opera design
points (k, num_racks, groups) x workloads x load levels x demand seeds
through `fluid_torch.simulate_rotor_bulk_batch`, one batched call per
design point.  Loads are offered as a fraction of aggregate host NIC
bandwidth over one topology cycle: at load x, every host sources
x * link_rate * cycle bytes, placed by the workload's spatial pattern.
`run_flow_sweep` runs a (network x workload x load x seed) flow grid
through `flows_torch` in one batched call (dense, or tiled at
`flows_torch.TILED_AUTO_FLOWS` flows under ``engine="auto"``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch import DeviceLike
from repro_torch.configs.opera_paper import OperaNetConfig
from repro_torch.core.schedule import cycle_timing
from repro_torch.core.topology import (
    build_lifted_opera_topology,
    build_opera_topology,
)
from repro_torch.netsim.fluid_torch import (
    RotorBatchResult,
    simulate_rotor_bulk_batch,
)
from repro_torch.netsim.workloads import (
    demand_all_to_all,
    demand_hotrack,
    demand_permutation,
    demand_skew,
)

# Above this rack count `run_design` builds the topology as a lift of a
# small base schedule instead of drawing N random perfect matchings.
LIFTED_TOPO_RACKS = 128

WORKLOADS = ("shuffle", "permutation", "skew", "hotrack")


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One Opera fabric design: k-radix ToRs split 50/50, u = k/2 rotor
    switches, `groups` switches reconfiguring simultaneously (App. B)."""

    k: int
    num_racks: int
    groups: int = 1
    link_rate_gbps: float = 10.0
    topo_seed: int = 0

    @property
    def name(self) -> str:
        return f"k{self.k}-n{self.num_racks}-g{self.groups}"

    def to_config(self) -> OperaNetConfig:
        return OperaNetConfig(
            name=self.name,
            k=self.k,
            num_racks=self.num_racks,
            hosts_per_rack=self.k // 2,
            num_circuit_switches=self.k // 2,
            link_rate_gbps=self.link_rate_gbps,
            groups=self.groups,
        )


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    designs: Tuple[DesignPoint, ...]
    workloads: Tuple[str, ...] = ("shuffle", "permutation")
    loads: Tuple[float, ...] = (0.1, 0.3)
    seeds: Tuple[int, ...] = (0,)
    skew_frac: float = 0.2          # active-rack fraction for `skew`
    vlb: bool = True
    max_cycles: int = 120
    engine: str = "auto"            # fluid_torch engine: auto | dense | sparse

    @property
    def scenarios_per_design(self) -> int:
        return len(self.workloads) * len(self.loads) * len(self.seeds)


def appendix_b_grid() -> Tuple[DesignPoint, ...]:
    """The full Appendix-B expansion grid, k = 8 .. 64."""
    return (
        DesignPoint(k=8, num_racks=16, groups=1),
        DesignPoint(k=8, num_racks=16, groups=2),
        DesignPoint(k=12, num_racks=108, groups=1),
        DesignPoint(k=12, num_racks=108, groups=2),
        DesignPoint(k=16, num_racks=128, groups=1),
        DesignPoint(k=24, num_racks=240, groups=2),
        DesignPoint(k=32, num_racks=432, groups=1),
        DesignPoint(k=32, num_racks=512, groups=2),
        DesignPoint(k=64, num_racks=1024, groups=4),
    )


def scenario_demand(
    workload: str,
    cfg: OperaNetConfig,
    load: float,
    seed: int,
    skew_frac: float = 0.2,
) -> np.ndarray:
    """Rack-level demand matrix offering `load` x host NIC x one cycle."""
    cyc_s = cycle_timing(cfg).cycle_ms * 1e-3
    per_host = load * cfg.link_rate_gbps * 1e9 / 8 * cyc_s
    n, d = cfg.num_racks, cfg.hosts_per_rack
    if workload == "shuffle":
        return demand_all_to_all(n, d, per_host / max((n - 1) * d, 1))
    if workload == "permutation":
        return demand_permutation(n, d, per_host, seed=seed)
    if workload == "skew":
        return demand_skew(n, d, per_host, active_frac=skew_frac, seed=seed)
    if workload == "hotrack":
        return demand_hotrack(n, d, per_host)
    raise ValueError(f"unknown workload {workload!r} (one of {WORKLOADS})")


def run_design(
    spec: SweepSpec, dp: DesignPoint, device: DeviceLike = None,
) -> Tuple[List[Dict], RotorBatchResult]:
    """All of one design point's scenarios in a single batched call."""
    cfg = dp.to_config()
    if cfg.num_racks > LIFTED_TOPO_RACKS:
        topo = build_lifted_opera_topology(
            cfg.num_racks, cfg.u, seed=dp.topo_seed, groups=cfg.groups
        )
    else:
        topo = build_opera_topology(
            cfg.num_racks, cfg.u, seed=dp.topo_seed, groups=cfg.groups
        )
    grid = list(itertools.product(spec.workloads, spec.loads, spec.seeds))
    demands = np.stack(
        [
            scenario_demand(w, cfg, load, seed, spec.skew_frac)
            for w, load, seed in grid
        ]
    )
    res = simulate_rotor_bulk_batch(
        cfg, demands, vlb=spec.vlb, max_cycles=spec.max_cycles, topo=topo,
        engine=spec.engine, device=device,
    )
    t = cycle_timing(cfg)
    host_bw_gbps = cfg.num_hosts * cfg.link_rate_gbps
    rows = []
    for i, (w, load, seed) in enumerate(grid):
        rows.append(
            dict(
                design=dp.name,
                k=dp.k,
                num_racks=dp.num_racks,
                groups=dp.groups,
                workload=w,
                load=load,
                seed=seed,
                fct_99_ms=float(res.fct_99_ms[i]),
                fct_mean_ms=float(res.fct_mean_ms[i]),
                throughput_gbps=float(res.throughput_gbps[i]),
                throughput_frac=float(res.throughput_gbps[i]) / host_bw_gbps,
                bandwidth_tax=float(res.bandwidth_tax[i]),
                finished_frac=float(res.finished_frac[i, -1]),
                slices_run=int(res.slices_run[i]),
                cycle_ms=t.cycle_ms,
                total_bytes=float(res.total_bytes[i]),
            )
        )
    return rows, res


def run_sweep(spec: SweepSpec, device: DeviceLike = None) -> List[Dict]:
    rows: List[Dict] = []
    for dp in spec.designs:
        r, _ = run_design(spec, dp, device=device)
        rows.extend(r)
    return rows


@dataclasses.dataclass(frozen=True)
class FlowSweepSpec:
    """Flow-level analogue of `SweepSpec`: the (network x workload x load
    x seed) grids Figs. 7, 9 and 10 sweep through the batched flow
    engine, with `flows_torch`'s auto/dense/tiled dispatch."""

    networks: Tuple[str, ...]
    workloads: Tuple[str, ...] = ("websearch",)
    loads: Tuple[float, ...] = (0.05, 0.2)
    seeds: Tuple[int, ...] = (0,)
    engine: str = "auto"            # flows_torch engine: auto | dense | tiled

    @property
    def num_scenarios(self) -> int:
        return (len(self.networks) * len(self.workloads)
                * len(self.loads) * len(self.seeds))


def run_flow_sweep(spec: FlowSweepSpec, device: DeviceLike = None,
                   **sim_kw) -> List[Dict]:
    """The whole flow grid in one batched run (dense: one step loop;
    tiled: one chunk loop whose every chunk covers the grid).  `sim_kw`
    goes to `flows.build_scenario` (horizon_s, dt_s, num_hosts, ...) or
    to the tiled geometry (tile_size, window_tiles, chunk_steps); rows
    are `summarize`-ready."""
    from repro_torch.netsim.flows_torch import simulate_grid

    return simulate_grid(
        spec.networks, spec.workloads, spec.loads, seeds=spec.seeds,
        engine=spec.engine, device=device, **sim_kw)


def summarize(
    rows: Sequence[Dict],
    by: Tuple[str, ...] = ("design", "workload", "load"),
    stats: Tuple[str, ...] = (
        "fct_99_ms", "fct_mean_ms", "throughput_frac", "bandwidth_tax",
        "finished_frac",
    ),
) -> List[Dict]:
    """Mean over everything not in `by` (i.e. over demand seeds)."""
    groups: Dict[Tuple, List[Dict]] = {}
    for r in rows:
        groups.setdefault(tuple(r[k] for k in by), []).append(r)
    out = []
    for key, members in sorted(groups.items()):
        row = dict(zip(by, key), n=len(members))
        for s in stats:
            row[s] = float(np.mean([m[s] for m in members]))
        out.append(row)
    return out
