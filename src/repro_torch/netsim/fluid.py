"""Result type of the rotor bulk fluid engines.

Copy of `repro.netsim.fluid.RotorFluidResult`.  The float64 numpy
oracle of that module is not copied: it stays in the JAX package, and
only the parity tests use it.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class RotorFluidResult:
    finished_frac: List[float]          # per slice-step, fraction of bytes done
    time_us: List[float]
    fct_99_ms: float
    fct_mean_ms: float
    throughput_gbps: float              # aggregate goodput
    wire_bytes: float                   # total bytes that crossed links
    goodput_bytes: float                # demand bytes delivered
    slices_run: int
    blackholed_bytes: float = 0.0       # sent into undetected-dead circuits

    @property
    def bandwidth_tax(self) -> float:
        return self.wire_bytes / max(self.goodput_bytes, 1.0) - 1.0
