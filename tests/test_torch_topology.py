"""The port's topology code with no `networkx`, and its import policy.

`repro_torch.core.topology` replaces the reference's `networkx` blossom
fallback with an exact matching search of its own.  Its builders must
produce exact factorizations with involutive index tensors and
connected slices with `networkx` unimportable, up to the lifted
k64-n1024-g4 point.  The port (and `chip_smoke.py`) may import neither
`jax`, `networkx` nor anything of `repro`.
"""
import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.topology import build_opera_topology as jax_build
from repro_torch import resolve_device
from repro_torch.core import topology as T

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "repro", "networkx")


@pytest.fixture
def no_networkx(monkeypatch):
    monkeypatch.setitem(sys.modules, "networkx", None)
    with pytest.raises(ImportError):
        import networkx  # noqa: F401


def _check_index_tensor(topo):
    n = topo.num_racks
    dst = topo.matching_index_tensor()
    assert dst.dtype == np.int32
    assert dst.shape == (topo.num_slices, n, topo.num_switches)
    i = np.arange(n)
    for t in range(dst.shape[0]):
        for s in range(dst.shape[2]):
            col = dst[t, :, s]
            live = col < n
            assert np.array_equal(col[col[live]], i[live])
            assert not np.any(col[live] == i[live])
        assert int((dst[t] == n).all(axis=0).sum()) >= topo.groups
    return dst


@pytest.mark.parametrize("n,u,g", [(16, 4, 1), (108, 6, 1)])
def test_builder_without_networkx(no_networkx, n, u, g):
    topo = T.build_opera_topology(n, u, seed=0, groups=g)
    T.verify_factorization([m for sw in topo.switch_matchings for m in sw])
    dst = _check_index_tensor(topo)
    dense = topo.matching_tensor()
    rebuilt = np.zeros_like(dense)
    t, i, s = np.nonzero(dst < n)
    rebuilt[t, i, dst[t, i, s]] = 1.0
    np.testing.assert_array_equal(rebuilt, dense)
    assert T._slices_robust(topo, 0)


def test_lifted_k64_without_networkx(no_networkx):
    topo = T.build_lifted_opera_topology(1024, 32, seed=0, groups=4)
    assert topo.num_slices == 256 and topo.matchings_per_switch == 32
    T.verify_factorization([m for sw in topo.switch_matchings for m in sw])
    _check_index_tensor(topo)


def test_exact_matching_is_maximum():
    """The blossom search against a brute-force maximum on small random
    graphs (odd cycles included)."""
    import itertools

    rng = np.random.default_rng(3)
    for _ in range(60):
        n = int(rng.integers(2, 9))
        a = np.triu(rng.random((n, n)) < rng.uniform(0.2, 0.7), 1)
        a = a | a.T
        m = T._max_cardinality_matching(a)
        for v in np.nonzero(m >= 0)[0]:
            assert m[m[v]] == v and a[v, m[v]]
        edges = list(zip(*np.nonzero(np.triu(a, 1))))
        best = 0
        for k in range(len(edges), 0, -1):
            if any(len({x for e in c for x in e}) == 2 * k
                   for c in itertools.combinations(edges, k)):
                best = k
                break
        assert int((m >= 0).sum()) // 2 == best


def test_exact_matching_completes_a_hard_tail():
    """A 2-regular remainder made of even cycles, where a greedy walk can
    strand vertices, still gets a perfect matching."""
    n = 12
    a = np.zeros((n, n), dtype=bool)
    for cyc in (range(0, 6), range(6, 12)):
        c = list(cyc)
        for x, y in zip(c, c[1:] + c[:1]):
            a[x, y] = a[y, x] = True
    p = T._random_perfect_matching(a, np.random.default_rng(0))
    assert p is not None and np.array_equal(p[p], np.arange(n))
    assert a[np.arange(n), p].all()


def test_topology_from_arrays_round_trip():
    ref = jax_build(108, 6, seed=0, groups=2)
    got = T.topology_from_arrays(108, 6, np.asarray(ref.switch_matchings), 2)
    np.testing.assert_array_equal(got.matching_index_tensor(),
                                  ref.matching_index_tensor())
    np.testing.assert_array_equal(got.matching_tensor(), ref.matching_tensor())
    bad = np.asarray(ref.switch_matchings).copy()
    bad[0, 0, :2] = bad[0, 0, 1::-1]
    with pytest.raises(ValueError):
        T.topology_from_arrays(108, 6, bad, 2)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix()
     for p in (ROOT / "src" / "repro_torch").rglob("*.py")]
    + ["chip_smoke.py", "scripts/chip_ab.py"]))
def test_port_imports_no_jax_or_reference(path):
    bad = [m for m in _imports(ROOT / path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda:0")
