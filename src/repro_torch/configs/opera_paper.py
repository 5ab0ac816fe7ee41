"""The paper's own network design points (§4, §5, Appendices A-B).

Copy of `repro.configs.opera_paper` (the port imports nothing of the
JAX package); keep the two in step.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class OperaNetConfig:
    name: str
    k: int                    # ToR radix
    num_racks: int
    hosts_per_rack: int
    num_circuit_switches: int  # u = k/2 uplinks, one per switch
    link_rate_gbps: float = 10.0
    prop_delay_us: float = 0.5     # 100 m fiber between ToRs
    reconfig_delay_us: float = 10.0  # r, state-of-the-art optical switch
    epsilon_us: float = 90.0       # worst-case end-to-end delay (§4.1)
    queue_bytes: int = 24 * 1024   # shallow ToR queue (§4.1)
    mtu: int = 1500
    bulk_cutoff_bytes: int = 15 * 2**20  # flows >= 15 MB default to direct
    groups: int = 1                # switches reconfiguring simultaneously (App. B)

    @property
    def u(self) -> int:
        return self.num_circuit_switches

    @property
    def d(self) -> int:
        return self.hosts_per_rack

    @property
    def num_hosts(self) -> int:
        return self.num_racks * self.hosts_per_rack


# The 648-host design point of §4-§5: k = 12, d = u = 6, 108 racks,
# 6 rotor switches, 108 disjoint matchings (N/u = 18 per switch).
OPERA_648 = OperaNetConfig(
    name="opera-648",
    k=12,
    num_racks=108,
    hosts_per_rack=6,
    num_circuit_switches=6,
)

# The 5184-host scale point (§5.6): k = 24, d = u = 12.
OPERA_5184 = OperaNetConfig(
    name="opera-5184",
    k=24,
    num_racks=432,
    hosts_per_rack=12,
    num_circuit_switches=12,
)
