"""`repro_torch.kernels.rotor_slice` on the CPU against the JAX op.

The port's `rotor_slice_step` runs its plain PyTorch version for CPU
tensors; it is held to the JAX package's op run through the Pallas
kernel in interpret mode (``force_pallas=True``, as
tests/test_rotor_slice.py runs it) and to the float64 numpy oracle, with
that file's tolerances: state atol 1e-5, totals atol 1e-4.  The CUDA
kernel itself is held to this plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.topology import build_opera_topology
from repro.kernels.rotor_slice import rotor_slice_step as jax_step
from repro.kernels.rotor_slice.ref import apply_edges as jax_apply_edges
from repro.netsim.fluid import rotor_slice_step as oracle_step
from repro_torch.kernels import launch_counts, pick
from repro_torch.kernels.rotor_slice import rotor_slice_step
from repro_torch.kernels.rotor_slice.kernel import rotor_slice_fwd
from repro_torch.kernels.rotor_slice.ref import apply_edges, rotor_slice_ref


def _state(n, bsz=3, seed=0):
    rng = np.random.default_rng(seed)
    own = rng.uniform(0.0, 2.0, (bsz, n, n)).astype(np.float32)
    relay = rng.uniform(0.0, 1.0, (bsz, n, n)).astype(np.float32)
    for a in (own, relay):
        a[:, np.arange(n), np.arange(n)] = 0.0
    return own, relay


@pytest.fixture(scope="module")
def k8():
    topo = build_opera_topology(16, 4, seed=0)
    return topo.matching_index_tensor(), topo.matching_tensor(), *_state(16)


@pytest.mark.parametrize("vlb", [False, True])
@pytest.mark.parametrize("t", [0, 3, 7])
def test_op_matches_jax_pallas(k8, t, vlb):
    dst, _, own, relay = k8
    ref = jax_step(jnp.asarray(own), jnp.asarray(relay), jnp.asarray(dst[t]),
                   vlb=vlb, force_pallas=True)
    got = rotor_slice_step(torch.from_numpy(own), torch.from_numpy(relay),
                           torch.from_numpy(dst[t]), vlb=vlb)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g.shape == tuple(r.shape) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=1e-5 if i < 2 else 1e-4)


@pytest.mark.parametrize("vlb", [False, True])
@pytest.mark.parametrize("t", [0, 3, 7])
def test_op_matches_numpy_oracle(k8, t, vlb):
    dst, dense, own, relay = k8
    o2, r2, deliv, moved = rotor_slice_step(
        torch.from_numpy(own), torch.from_numpy(relay),
        torch.from_numpy(dst[t]), vlb=vlb)
    for b in range(own.shape[0]):
        eo, er, ed, em = oracle_step(
            own[b].astype(np.float64), relay[b].astype(np.float64),
            dense[t].astype(np.float64), vlb=vlb)
        np.testing.assert_allclose(o2[b].numpy(), eo, atol=1e-5)
        np.testing.assert_allclose(r2[b].numpy(), er, atol=1e-5)
        assert np.isclose(float(deliv[b]), ed, atol=1e-4)
        assert np.isclose(float(moved[b]), em, atol=1e-4)


@pytest.mark.parametrize("groups", [1, 2])
def test_apply_edges_matches_jax_select_tree(groups):
    """Dark columns (grouped reconfiguration) and partial sentinels
    (self-loops in live matchings) scatter nothing, bit for bit."""
    topo = build_opera_topology(16, 4, seed=0, groups=groups)
    dst = topo.matching_index_tensor()
    rng = np.random.default_rng(1)
    dense = rng.uniform(0, 3, (2, 16, 16)).astype(np.float32)
    vals = rng.uniform(-1, 1, (2, 16, 4)).astype(np.float32)
    for t in range(dst.shape[0]):
        ref = jax_apply_edges(jnp.asarray(dense), jnp.asarray(dst[t]),
                              jnp.asarray(vals))
        got = apply_edges(torch.from_numpy(dense), torch.from_numpy(dst[t]),
                          torch.from_numpy(vals))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_lifted_slice_matches_jax():
    """A wider, lifted design point (k16-n128-g2 shapes: u = 8 with
    dark columns), the plain version against the JAX ref path."""
    from repro.core.topology import build_lifted_opera_topology

    topo = build_lifted_opera_topology(128, 8, seed=0, groups=2, max_base=64)
    dst = topo.matching_index_tensor()
    own, relay = _state(128, bsz=2, seed=2)
    for t in (0, 5):
        ref = jax_step(jnp.asarray(own), jnp.asarray(relay),
                       jnp.asarray(dst[t]), vlb=True)
        got = rotor_slice_ref(torch.from_numpy(own), torch.from_numpy(relay),
                              torch.from_numpy(dst[t]), vlb=True)
        for i, (r, g) in enumerate(zip(ref, got)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       atol=1e-5 if i < 2 else 1e-4)


def test_cpu_tensors_take_the_plain_version_and_count_nothing(k8):
    dst, _, own, relay = k8
    before = launch_counts["rotor_slice"]
    args = (torch.from_numpy(own), torch.from_numpy(relay),
            torch.from_numpy(dst[0]))
    assert pick(args[0], rotor_slice_fwd, rotor_slice_ref) is rotor_slice_ref
    a = rotor_slice_step(*args, vlb=True)
    b = rotor_slice_ref(*args, vlb=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert launch_counts["rotor_slice"] == before


def test_kernel_wrapper_refuses_cpu_tensors(k8):
    """The CUDA wrapper never runs the plain version: CPU input raises
    before anything is built."""
    dst, _, own, relay = k8
    with pytest.raises(ValueError, match="CUDA"):
        rotor_slice_fwd(torch.from_numpy(own), torch.from_numpy(relay),
                        torch.from_numpy(dst[0]), vlb=True)


def test_pick_rejects_other_devices():
    with pytest.raises(ValueError, match="meta"):
        pick(torch.empty(1, device="meta"), rotor_slice_fwd, rotor_slice_ref)
