"""Analytic capacity model (§2, §5.3, §5.6, Appendix A).

Copy of `repro.netsim.capacity` (numpy only); keep the two in step.

Per-host-link normalized capacities for each cost-equivalent network.
One transport-efficiency constant eta_indirect is calibrated so the
u=7 expander saturates at the paper's ~25 % Websearch load; everything
else (Opera's ~10 %, the 60 %-capacity/41 %-more-tax decomposition,
Fig. 12's alpha crossovers) then follows from the model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

# transport efficiency of multi-hop traffic (NDP over expander paths):
# calibrated once against the expander's published 25 % saturation.
ETA_INDIRECT = 0.42
ETA_DIRECT = 0.90


@dataclasses.dataclass(frozen=True)
class NetPoint:
    name: str
    u: float              # uplinks per ToR
    d: float              # hosts per ToR
    avg_hops: float       # mean ToR-to-ToR path length
    duty: float = 1.0


OPERA_648_PT = NetPoint("opera-648", u=5.0, d=6.0, avg_hops=3.34, duty=0.985)
# while one of 6 switches reconfigures, 5 uplinks are usable
EXPANDER_650_PT = NetPoint("expander-650", u=7.0, d=5.0, avg_hops=2.36)
CLOS_648_PT = NetPoint("clos-3to1", u=4.0, d=12.0, avg_hops=1.0)  # logical


def latency_capacity(p: NetPoint) -> float:
    """Admissible low-latency (multi-hop) load as a fraction of host rate."""
    return ETA_INDIRECT * p.duty * p.u / (p.d * p.avg_hops)


def bulk_capacity_opera(p: NetPoint) -> float:
    """Tax-free direct capacity per host for bulk (one-hop circuits)."""
    return ETA_DIRECT * p.duty * p.u / p.d


def clos_capacity(oversub: float) -> float:
    return ETA_DIRECT / oversub


def summary_648() -> Dict[str, float]:
    op, ex = OPERA_648_PT, EXPANDER_650_PT
    return dict(
        opera_latency_load=latency_capacity(op),
        expander_load=latency_capacity(ex),
        clos_load=clos_capacity(3.0),
        opera_bulk_load=bulk_capacity_opera(op),
        # §5.3 decomposition: Opera has (5/6)/(7/5)=0.60 of the expander's
        # in-fabric capacity and consumes avg_hops-ratio more wire bytes
        # per delivered byte ("an additional 41% bandwidth tax")
        capacity_ratio=(op.u / op.d) / (ex.u / ex.d),
        extra_tax=op.avg_hops / ex.avg_hops - 1.0,
    )


# ---------------- Fig. 12: cost-normalized throughput vs alpha -------------


def fig12_model(alpha: float, workload: str, k: int = 24) -> Dict[str, float]:
    """Throughput (fraction of host rate) for Opera vs cost-equivalent
    static networks at Opera-port relative cost `alpha`.

    Cost normalization (Appendix A): at cost parity a static network can
    deploy `alpha` x the core ports of Opera; we scale the expander's
    uplinks and the Clos's effective over-subscription accordingly.
    """
    u0, d0 = k / 2.0, k / 2.0
    op = NetPoint("opera", u=u0 - 1, d=d0, avg_hops=3.3, duty=0.985)
    # Appendix A at cost parity: the expander re-splits its k-radix ToR so
    # that u/d ~ alpha (vs Opera's 1:1); the folded Clos's
    # over-subscription is F = 4/alpha (alpha = 2(T-1)/F at T = 3 tiers).
    u_exp = alpha * k / (1.0 + alpha)
    ex = NetPoint("expander", u=u_exp, d=max(k - u_exp, 1.0), avg_hops=2.4)
    clos = clos_capacity(max(4.0 / alpha, 1.0))
    # bulk over taxed expander paths runs at the fluid (congested) transport
    # efficiency — between the latency-pool calibration and ideal.
    ETA_BULK_INDIRECT = 0.6
    exp_taxed = ETA_BULK_INDIRECT * ex.u / (ex.d * ex.avg_hops)

    if workload == "shuffle":
        opera = bulk_capacity_opera(op)          # all-to-all: every pair's
        exp = exp_taxed                          # circuit used every cycle
    elif workload == "hotrack":
        # one rack pair: direct circuits alone give u/N of a link; RotorLB
        # VLB floods all uplinks at 100 % tax instead.
        opera = ETA_DIRECT * op.duty * op.u / (2.0 * op.d)
        exp = ETA_BULK_INDIRECT * ex.u / (ex.d * 2.0)  # VLB there too
    elif workload == "skew":
        # 20 % of racks active: substantial direct time + VLB remainder
        opera = ETA_DIRECT * op.duty * op.u / (1.3 * op.d)
        exp = exp_taxed
    elif workload == "permutation":
        # one destination per rack -> its direct circuit is live only u/N
        # of the cycle: VLB carries the load (the paper's RotorLB skew case)
        opera = ETA_DIRECT * op.duty * op.u / (2.0 * op.d)
        exp = exp_taxed
    else:
        raise ValueError(workload)
    return dict(alpha=alpha, opera=min(opera, 1.0), expander=min(exp, 1.0),
                clos=min(clos, 1.0))


def crossover_alpha(workload: str, k: int = 24) -> float:
    """Smallest alpha at which a static network beats Opera."""
    for a in np.arange(1.0, 4.01, 0.05):
        r = fig12_model(float(a), workload, k)
        if max(r["expander"], r["clos"]) > r["opera"]:
            return float(a)
    return 4.0
