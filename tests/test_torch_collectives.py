"""The port's rotor collectives against the JAX package's, on the CPU.

Every function of `repro.core.collectives` runs in the port's gloo
worlds (`core.comm.spawn_world`) of 2 and 3 ranks on `data`, 4 on `data`
and 4 as `pod` 2 x `data` 2, and in the JAX package on as many fake CPU
devices, in a subprocess (``XLA_FLAGS=--xla_force_host_platform_
device_count=8`` must be set before JAX is imported, as
tests/test_collectives_distributed.py runs it), over the same seeded
inputs (tests/torch_dist_cases.py).  Each output is held to the JAX
package's at atol/rtol 1e-5 (tests/distributed/check_collectives.py) and
to a float64 reference; the compressed path's totals and carried errors
to the JAX package's, its int8 payload and scale too, and its totals
within a relative 0.05 of the exact sum.  `schedule_stats`,
`_expander_routing`, `rotor_schedule` and `expander_union` equal the
JAX package's for N 2-16; `ppermute` gives zeros to a rank nothing is
sent to; each rank sends the bytes `schedule_stats` says.
"""
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":   # the JAX side, on fake CPU devices
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_cases as K
from repro.core import collectives as JC
from repro.core import topology as JT
from repro_torch.core import collectives as C
from repro_torch.core import topology as T
from repro_torch.core.comm import spawn_world

TOL = dict(atol=1e-5, rtol=1e-5)
NS = range(2, 17)


# ---------------- the JAX package, in a subprocess ----------------------------


def jax_outputs(path: str) -> None:
    """Every case of every layout through the JAX package on fake CPU
    devices, stacked over the ranks, to an npz at `path`."""
    from jax.sharding import PartitionSpec as P

    from repro import compat

    out = {}
    for layout, (shape, axes) in K.LAYOUTS.items():
        mesh = compat.make_mesh(shape, axes,
                                devices=jax.devices()[:K.world_of(layout)])
        spec = P(axes if len(axes) > 1 else axes[0])

        def run(fn, *xs):
            f = compat.shard_map(fn, mesh=mesh, in_specs=(spec,) * len(xs),
                                 out_specs=spec, check_vma=False)
            return jax.tree.map(np.asarray, jax.jit(f)(*xs))

        for name, fn, axis, kw, _ in K.cases(layout):
            x = K.inputs(layout, name, _)
            if fn == "compressed_rotor_all_reduce":
                def comp(a, b):
                    t1, e1 = JC.compressed_rotor_all_reduce(a[0], axis)
                    # the payload of the second step, by the formula of
                    # src/repro/core/collectives.py:320-322
                    y = b[0] + e1
                    scale = jnp.maximum(jnp.max(jnp.abs(y)), 1e-30) / 127.0
                    q = jnp.clip(jnp.round(y / scale), -127, 127).astype(
                        jnp.int8)
                    t2, e2 = JC.compressed_rotor_all_reduce(b[0], axis, e1)
                    return {k: v[None] for k, v in dict(
                        total1=t1, err1=e1, total2=t2, err2=e2, q2=q,
                        scale2=scale).items()}
                got = run(comp, x[0], x[1])
            elif fn == "rotor_psum_tree":
                got = run(lambda a: jax.tree.map(
                    lambda v: v[None], JC.rotor_psum_tree(
                        K.tree_inputs(a[0]), *axis)), x)
            elif fn == "hierarchical_rotor_all_reduce":
                got = run(lambda a: JC.hierarchical_rotor_all_reduce(
                    a[0], *axis)[None], x)
            else:
                got = run(lambda a, fn=fn, axis=axis, kw=kw: getattr(JC, fn)(
                    a[0], axis, **kw)[None], x)
            for k, v in _flat(got, f"{layout}/{name}").items():
                out[k] = v
    np.savez(path, **out)


def _flat(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "collectives.npz"
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=root)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port_out():
    """{layout: [each rank's {case: (output, bytes sent)}]}."""
    out = {}
    for size, layouts in ((2, ["w2"]), (3, ["w3"]), (4, ["w4", "p2d2"])):
        ranks = spawn_world(K.collective_rank, size, layouts, device="cpu",
                            timeout_s=120)
        assert all(r["backend"] == "gloo" for r in ranks)
        for lay in layouts:
            out[lay] = [r[lay] for r in ranks]
    return out


def _stacked(port_out, layout: str, name: str) -> dict:
    """The port's outputs of a case stacked over the ranks, flattened as
    the JAX side's."""
    ranks = [_flat(r[name][0], f"{layout}/{name}") for r in port_out[layout]]
    return {k: np.stack([r[k] for r in ranks]) for k in ranks[0]}


CASES = [(lay, name) for lay in K.LAYOUTS for name in K.case_names(lay)]


# ---------------- the collectives ----------------------------------------------


@pytest.mark.parametrize("layout,name", CASES)
def test_collective_equals_jax(jax_out, port_out, layout, name):
    got = _stacked(port_out, layout, name)
    assert got, name
    for k, v in got.items():
        want = jax_out[k]
        if k.endswith("/q2"):
            np.testing.assert_array_equal(v, want, err_msg=k)
        else:
            np.testing.assert_allclose(v, want, err_msg=k, **TOL)


@pytest.mark.parametrize("layout,name", [c for c in CASES if c[1] != "comp"])
def test_collective_equals_exact_sum(port_out, layout, name):
    got = _stacked(port_out, layout, name)
    for rank in range(K.world_of(layout)):
        want = _flat(K.exact(layout, name, rank), f"{layout}/{name}")
        for k, w in want.items():
            np.testing.assert_allclose(got[k][rank], w, err_msg=k, **TOL)


@pytest.mark.parametrize("layout", list(K.LAYOUTS))
def test_compressed_within_int8_of_the_sum(port_out, layout):
    """check_collectives.py's bound: max error / max |sum| < 0.05; the
    carried error plus the dequantized payload give back the input."""
    got = _stacked(port_out, layout, "comp")
    x = K.inputs(layout, "comp", K.SHAPE)
    for rank in range(K.world_of(layout)):
        ranks = K.line(layout, rank, "data")
        want = x[0][ranks].astype(np.float64).sum(0)
        err = np.abs(got[f"{layout}/comp/total1"][rank] - want).max()
        assert err / np.abs(want).max() < 0.05
        y = x[1][rank] + got[f"{layout}/comp/err1"][rank]
        q = got[f"{layout}/comp/q2"][rank].astype(np.float32)
        np.testing.assert_allclose(
            q * got[f"{layout}/comp/scale2"][rank]
            + got[f"{layout}/comp/err2"][rank], y, atol=1e-6)


@pytest.mark.parametrize("layout", list(K.LAYOUTS))
def test_wire_bytes_are_the_schedules(port_out, layout):
    """rs_ag sends 2(N-1)/N of the input's bytes from every rank, direct
    N-1 times them; and the cases' counts, as `schedule_stats` says."""
    n = K.LAYOUTS[layout][0][-1]
    stats = C.schedule_stats(n)
    for r in port_out[layout]:
        assert r["wire"]["rs_ag"] == pytest.approx(stats["rotor_ar_bytes"])
        assert r["wire"]["direct"] == stats["rotor_ar_direct_bytes"]
        x_bytes = int(np.prod((n, 3, 2))) * 4
        assert r["a2a@data"][1] == pytest.approx(
            stats["rotor_a2a_bytes"] * x_bytes)
        assert r["a2a_vlb@data"][1] == pytest.approx(
            stats["rotor_a2a_vlb_bytes"] * x_bytes)


def test_ppermute_gives_zeros_where_nothing_is_sent(port_out):
    one = [r["ppermute"]["one_pair"] for r in port_out["w3"]]
    np.testing.assert_array_equal(one, [[0] * 3, [1] * 3, [0] * 3])
    cycle = [r["ppermute"]["cycle"] for r in port_out["w3"]]
    np.testing.assert_array_equal(cycle, [[3] * 3, [1] * 3, [2] * 3])


# ---------------- the schedules ------------------------------------------------


@pytest.mark.parametrize("n", NS)
def test_schedule_stats_equal_jax(n):
    assert C.schedule_stats(n) == JC.schedule_stats(n)


@pytest.mark.parametrize("n", NS)
def test_expander_routing_equals_jax(n):
    for u in (2, 3):
        u = min(u, n - 1)
        live, diam = C._expander_routing(n, u)
        jlive, jdiam = JC._expander_routing(n, u)
        assert diam == jdiam
        assert len(live) == len(jlive)
        for a, b in zip(live, jlive):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", NS)
def test_rotor_schedule_and_expander_union_equal_jax(n):
    assert T.rotor_schedule(n) == JT.rotor_schedule(n)
    for degree in (1, 3):
        np.testing.assert_array_equal(T.expander_union(n, degree, seed=2),
                                      JT.expander_union(n, degree, seed=2))


if __name__ == "__main__":
    jax_outputs(sys.argv[1])
