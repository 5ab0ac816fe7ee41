"""Cycle-time model (§4.1, §3.5, Appendix B).

Copy of the timing half of `repro.core.schedule`; keep the two in step.

  epsilon  = worst-case end-to-end delay under worst-case queuing
  slice    = epsilon + r                      (r = reconfiguration delay)
  per-switch period = (u/groups) * slice
  duty cycle = 1 - r / per-switch period
  cycle    = num_slices * slice
  bulk cutoff ~ link_rate * cycle
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.opera_paper import OperaNetConfig


@dataclasses.dataclass(frozen=True)
class CycleTiming:
    epsilon_us: float
    reconfig_us: float
    slice_us: float
    per_switch_period_us: float
    duty_cycle: float
    num_slices: int
    cycle_ms: float
    bulk_cutoff_mb: float
    ll_capacity_loss_per_guard_us: float
    bulk_capacity_loss_per_guard_us: float


def epsilon_us(
    worst_hops: int,
    queue_bytes: int,
    link_rate_gbps: float,
    prop_delay_us: float,
    mtu: int = 1500,
) -> float:
    """Worst-case end-to-end delay: at each of `worst_hops` ToR-to-ToR hops
    a packet may wait behind a full shallow queue, plus serialization and
    propagation (§4.1: 24 KB queue, 5 hops, 500 ns, 10 Gb/s -> 90 us)."""
    drain_us = queue_bytes * 8 / (link_rate_gbps * 1e3)  # us
    ser_us = mtu * 8 / (link_rate_gbps * 1e3)
    per_hop = drain_us - ser_us + prop_delay_us + ser_us
    return worst_hops * per_hop


def cycle_timing(cfg: OperaNetConfig, worst_hops: int = 5) -> CycleTiming:
    eps = epsilon_us(
        worst_hops, cfg.queue_bytes, cfg.link_rate_gbps, cfg.prop_delay_us, cfg.mtu
    )
    slice_us = eps + cfg.reconfig_delay_us
    rounds = cfg.u // cfg.groups
    per_switch = rounds * slice_us
    duty = 1.0 - cfg.reconfig_delay_us / per_switch
    num_slices = cfg.num_racks // cfg.groups
    cycle_ms = num_slices * slice_us / 1e3
    # a bulk flow must amortize waiting <= one cycle for its direct slice
    cutoff_mb = cfg.link_rate_gbps * 1e9 / 8 * (cycle_ms / 1e3) / 2**20
    return CycleTiming(
        epsilon_us=eps,
        reconfig_us=cfg.reconfig_delay_us,
        slice_us=slice_us,
        per_switch_period_us=per_switch,
        duty_cycle=duty,
        num_slices=num_slices,
        cycle_ms=cycle_ms,
        bulk_cutoff_mb=cutoff_mb,
        ll_capacity_loss_per_guard_us=1.0 / slice_us,
        bulk_capacity_loss_per_guard_us=1.0 / per_switch,
    )


def slice_capacity_bytes(cfg: OperaNetConfig, timing: CycleTiming = None) -> float:
    """Byte budget of one live circuit during one slice (duty-derated).

    A plain python float: the fluid engines normalize every byte count
    by it, so the device state stays in units of one slice-link."""
    t = timing or cycle_timing(cfg)
    return cfg.link_rate_gbps * 1e9 / 8 * (t.slice_us * 1e-6) * t.duty_cycle
