"""Traffic classification (§2.1, §3.4, §4.1).

Opera is agnostic to *how* traffic is classified; the default is a flow-size
threshold (flows that can amortize one cycle of waiting ride direct paths),
with application-based tagging as an override (e.g. shuffle flows are bulk
regardless of size).  The same notions drive the framework's collectives:
gradient/expert payloads are `BULK`, control-plane tensors are `LATENCY`.

Copy of `repro.core.classify`; keep the two in step.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional


class TrafficClass(enum.Enum):
    LATENCY = "latency"  # forwarded immediately over the expander (taxed)
    BULK = "bulk"        # buffered for the direct circuit (tax-free)


@dataclass(frozen=True)
class Classifier:
    bulk_cutoff_bytes: int = 15 * 2**20

    def classify(
        self, size_bytes: int, app_tag: Optional[TrafficClass] = None
    ) -> TrafficClass:
        if app_tag is not None:
            return app_tag
        return (
            TrafficClass.BULK
            if size_bytes >= self.bulk_cutoff_bytes
            else TrafficClass.LATENCY
        )


def bandwidth_tax(path_hops: int) -> float:
    """x bytes over k hops consume k*x of fabric capacity: tax = k-1."""
    return max(path_hops - 1, 0)


def effective_tax_rate(
    frac_bytes_indirect: float, avg_indirect_hops: float
) -> float:
    """Aggregate tax rate for a workload split between direct (1 hop,
    tax 0) and indirect traffic (§5.1: 4 % of bytes at L~3.1 -> 8.4 %)."""
    return frac_bytes_indirect * bandwidth_tax(avg_indirect_hops)
