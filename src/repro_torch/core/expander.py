"""Expander-graph diagnostics (Fig. 4, Appendix D).

Spectral gap, path-length distributions, and connectivity checks for the
time-varying slices of an Opera topology and for static comparison
networks.  Pure numpy; sizes here are O(100s) of racks so dense linear
algebra is fine.

Copy of `repro.core.expander` (numpy only); keep the two in step.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.topology import OperaTopology


def degree(adj: np.ndarray) -> np.ndarray:
    return adj.sum(axis=1)


def spectral_gap(adj: np.ndarray) -> float:
    """Gap of the degree-normalized adjacency: 1 - max(|lambda_2|, |lambda_n|).

    Larger is better; a d-regular Ramanujan graph achieves
    1 - 2*sqrt(d-1)/d, the optimum (Appendix D / [25]).
    """
    d = degree(adj).astype(np.float64)
    if (d == 0).any():
        return 0.0
    # symmetric normalization D^-1/2 A D^-1/2
    dinv = 1.0 / np.sqrt(d)
    norm = adj * dinv[:, None] * dinv[None, :]
    ev = np.linalg.eigvalsh(norm)
    # ev[-1] == 1 (Perron); gap to the next-largest magnitude eigenvalue
    second = max(abs(ev[0]), abs(ev[-2]))
    return float(1.0 - second)


def ramanujan_bound(d: int) -> float:
    return float(1.0 - 2.0 * np.sqrt(max(d - 1, 0)) / max(d, 1))


def hop_distances(adj: np.ndarray, max_hops: int = 32) -> np.ndarray:
    """All-pairs hop counts by boolean matrix powers.  -1 = unreachable."""
    n = adj.shape[0]
    dist = np.full((n, n), -1, dtype=np.int64)
    np.fill_diagonal(dist, 0)
    reach = np.eye(n, dtype=bool)
    frontier_adj = adj | np.eye(n, dtype=bool)
    cur = np.eye(n, dtype=bool)
    for h in range(1, max_hops + 1):
        cur = cur @ frontier_adj
        newly = cur & ~reach
        if not newly.any():
            break
        dist[newly] = h
        reach |= newly
    return dist


def path_length_cdf(adj: np.ndarray) -> Dict[int, float]:
    """CDF over ToR-pair hop counts (off-diagonal, reachable pairs)."""
    d = hop_distances(adj)
    n = d.shape[0]
    off = d[~np.eye(n, dtype=bool)]
    off = off[off > 0]
    out: Dict[int, float] = {}
    if off.size == 0:
        return out
    for h in range(1, int(off.max()) + 1):
        out[h] = float((off <= h).mean())
    return out


def mean_max_path(adj: np.ndarray) -> Tuple[float, int, int]:
    """(mean hops, max hops, #disconnected ordered pairs)."""
    d = hop_distances(adj)
    n = d.shape[0]
    off = d[~np.eye(n, dtype=bool)]
    disc = int((off < 0).sum())
    fin = off[off > 0]
    if fin.size == 0:
        return float("inf"), 0, disc
    return float(fin.mean()), int(fin.max()), disc


def slice_report(topo: OperaTopology, slices: Sequence[int] | None = None):
    """Per-slice expander diagnostics (Appendix D reproduction)."""
    if slices is None:
        slices = range(topo.num_slices)
    rows = []
    for t in slices:
        adj = topo.adjacency(t)
        mean_h, max_h, disc = mean_max_path(adj)
        rows.append(
            dict(
                slice=int(t),
                live_degree=int(degree(adj).max()),
                spectral_gap=spectral_gap(adj),
                mean_path=mean_h,
                max_path=max_h,
                disconnected_pairs=disc,
            )
        )
    return rows


# ---------------- static comparison topologies ----------------------------


def random_regular_expander(
    num_nodes: int, u: int, seed: int = 0
) -> np.ndarray:
    """Static expander as the union of u random matchings (Jellyfish-style,
    the paper's u=7 comparison network)."""
    from repro_torch.core.topology import random_matchings

    adj = np.zeros((num_nodes, num_nodes), dtype=bool)
    i = np.arange(num_nodes)
    ms = random_matchings(num_nodes, seed)
    # skip the identity-heavy matchings first if any; take u non-trivial ones
    taken = 0
    for p in ms:
        if taken == u:
            break
        mask = p != i
        if not mask.any():
            continue
        adj[i[mask], p[mask]] = True
        taken += 1
    return adj


def folded_clos_tor_hops(num_racks: int) -> Dict[int, float]:
    """ToR-to-ToR hop CDF for a 3-tier folded Clos: any two distinct ToRs
    are (logically) 'ToR-agg-ToR' = 2 ToR-to-ToR hops if under one agg
    block, else 4 via core.  We model the common 648-host k=12 build: 12
    pods of 9 ToRs.  (Used only for the Fig. 4 comparison plot.)"""
    pods = max(1, int(round(num_racks ** 0.5 / 1.0)) // 3 * 3) or 1
    racks_per_pod = max(1, num_racks // 12)
    same_pod_pairs = 0
    cross_pairs = 0
    for _ in range(12):
        same_pod_pairs += racks_per_pod * (racks_per_pod - 1)
    total = num_racks * (num_racks - 1)
    cross_pairs = total - same_pod_pairs
    return {
        2: same_pod_pairs / total,
        4: 1.0,
        "_mix": (same_pod_pairs / total, cross_pairs / total),
    }
