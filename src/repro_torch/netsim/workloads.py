"""Published flow-size distributions (Fig. 1) and rack-level spatial
traffic patterns (§5.2, §5.6).

Copy of `repro.netsim.workloads`; keep the two in step.  CDFs are
piecewise log-linear encodings of the published curves (Websearch:
DCTCP; Datamining: VL2; Hadoop: Facebook), so a numpy generator draws
the same flow sizes as the JAX package.  Demands are float64 numpy
matrices of rack->rack bytes.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# (size_bytes, P[size <= s]) — piecewise log-linear between points
WEBSEARCH_CDF: List[Tuple[float, float]] = [
    (6e3, 0.15), (13e3, 0.20), (19e3, 0.30), (33e3, 0.40), (53e3, 0.53),
    (133e3, 0.60), (667e3, 0.70), (1.3e6, 0.80), (3e6, 0.90),
    (6e6, 0.96), (10e6, 0.99), (14e6, 1.00),
]
DATAMINING_CDF: List[Tuple[float, float]] = [
    (100, 0.03), (300, 0.2), (1e3, 0.50), (3e3, 0.68), (10e3, 0.80),
    (100e3, 0.90), (1e6, 0.95), (10e6, 0.973), (100e6, 0.99),
    (250e6, 0.995), (1e9, 1.00),
]
HADOOP_CDF: List[Tuple[float, float]] = [
    (150, 0.1), (1e3, 0.4), (10e3, 0.55), (100e3, 0.70), (300e3, 0.85),
    (1e6, 0.95), (10e6, 0.99), (100e6, 1.00),
]

CDFS: Dict[str, List[Tuple[float, float]]] = {
    "websearch": WEBSEARCH_CDF,
    "datamining": DATAMINING_CDF,
    "hadoop": HADOOP_CDF,
}


def sample_flow_sizes(name: str, n: int, rng: np.random.Generator) -> np.ndarray:
    """Inverse-CDF sampler.  The distribution has an atom of mass p0 at
    the first CDF point (P[S <= s0] = p0, conventionally all at s0) and
    is log-linear between points; u is drawn on the full [0, 1) so the
    atom carries exactly p0 of the samples."""
    cdf = CDFS[name]
    sizes = np.array([s for s, _ in cdf])
    probs = np.array([p for _, p in cdf])
    u = rng.uniform(0.0, 1.0, n)
    idx = np.searchsorted(probs, u)
    idx = np.clip(idx, 1, len(cdf) - 1)
    s0, s1 = sizes[idx - 1], sizes[idx]
    p0, p1 = probs[idx - 1], probs[idx]
    frac = np.clip((u - p0) / np.maximum(p1 - p0, 1e-12), 0.0, 1.0)
    return np.exp(np.log(s0) + frac * (np.log(s1) - np.log(s0)))


def _byte_mass_below(cdf: List[Tuple[float, float]], cutoff: float) -> float:
    """E[S * 1{S < cutoff}] in closed form.

    Between points the CDF is linear in ln s, so the byte mass of a bin
    (s0, s1] is  (p1 - p0) * (s1 - s0) / ln(s1 / s0)  — the integral of
    s dF — truncated at the cutoff; the first point carries an atom of
    p0 * s0 (matching the sampler's convention above)."""
    s_first, p_first = cdf[0]
    total = p_first * s_first if s_first < cutoff else 0.0
    for (s0, p0), (s1, p1) in zip(cdf, cdf[1:]):
        hi = min(cutoff, s1)
        if hi <= s0:
            break
        total += (p1 - p0) * (hi - s0) / np.log(s1 / s0)
    return total


def mean_flow_size(name: str) -> float:
    return float(_byte_mass_below(CDFS[name], np.inf))


def byte_fraction_below(name: str, cutoff: float) -> float:
    """Fraction of bytes carried by flows smaller than `cutoff` — exact
    integral over the piecewise log-linear CDF (no Monte-Carlo)."""
    cdf = CDFS[name]
    return float(_byte_mass_below(cdf, cutoff) / _byte_mass_below(cdf, np.inf))


# ---------------- spatial patterns (§5.2, §5.6) ----------------------------



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
