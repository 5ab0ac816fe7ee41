"""Rack-level spatial traffic patterns (§5.2, §5.6).

Copy of the demand builders of `repro.netsim.workloads`; keep the two
in step.  Demands are float64 numpy matrices of rack->rack bytes.
"""
from __future__ import annotations

import numpy as np


def demand_all_to_all(num_racks: int, hosts_per_rack: int,
                      flow_bytes: float) -> np.ndarray:
    """Shuffle: every host sends `flow_bytes` to every other host."""
    d = np.full((num_racks, num_racks),
                hosts_per_rack * hosts_per_rack * flow_bytes)
    # intra-rack traffic never enters the fabric
    np.fill_diagonal(d, 0.0)
    return d


def demand_hotrack(num_racks: int, hosts_per_rack: int,
                   bytes_per_host: float) -> np.ndarray:
    d = np.zeros((num_racks, num_racks))
    d[0, 1] = hosts_per_rack * bytes_per_host
    return d


def demand_skew(num_racks: int, hosts_per_rack: int, bytes_per_host: float,
                active_frac: float = 0.2, seed: int = 0) -> np.ndarray:
    """skew[f,1]: a fraction f of racks are active, uniform among the
    active set."""
    rng = np.random.default_rng(seed)
    k = max(2, int(round(active_frac * num_racks)))
    act = rng.choice(num_racks, k, replace=False)
    d = np.zeros((num_racks, num_racks))
    per = hosts_per_rack * bytes_per_host / (k - 1)
    for i in act:
        for j in act:
            if i != j:
                d[i, j] = per
    return d


def demand_permutation(num_racks: int, hosts_per_rack: int,
                       bytes_per_host: float, seed: int = 0) -> np.ndarray:
    """Host permutation: each host sends to one non-rack-local host."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_racks)
    # Repair self-maps into a derangement.  Two or more fixed points are
    # cycled among themselves; a single fixed point i is swapped with its
    # neighbour j, which leaves neither position fixed.
    fixed = np.flatnonzero(perm == np.arange(num_racks))
    if fixed.size > 1:
        perm[fixed] = np.roll(perm[fixed], 1)
    elif fixed.size == 1:
        i = int(fixed[0])
        j = (i + 1) % num_racks
        perm[i], perm[j] = perm[j], perm[i]
    d = np.zeros((num_racks, num_racks))
    d[np.arange(num_racks), perm] = hosts_per_rack * bytes_per_host
    return d
