"""The CUDA rotor slice kernel against its plain version, on the card.

Imports no JAX, so it runs where only the port is installed:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
Without a card every test skips.  Tolerances are chip_smoke.py's:
state atol 1e-5, totals rtol 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.topology import build_opera_topology
from repro_torch.kernels import launch_counts
from repro_torch.kernels.rotor_slice.kernel import rotor_slice_fwd
from repro_torch.kernels.rotor_slice.ref import rotor_slice_ref
from repro_torch.netsim import fluid_torch
from repro_torch.netsim.sweep import DesignPoint, scenario_demand

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _state(n, bsz, seed, device):
    rng = np.random.default_rng(seed)
    own = rng.uniform(0.0, 2.0, (bsz, n, n)).astype(np.float32)
    relay = rng.uniform(0.0, 1.0, (bsz, n, n)).astype(np.float32)
    for a in (own, relay):
        a[:, np.arange(n), np.arange(n)] = 0.0
    return torch.from_numpy(own).to(device), torch.from_numpy(relay).to(device)


@pytest.mark.parametrize("vlb", [False, True])
@pytest.mark.parametrize("n,u,g", [(16, 4, 1), (16, 4, 2), (108, 6, 1)])
def test_kernel_matches_plain_version(card, n, u, g, vlb):
    dst = torch.as_tensor(
        build_opera_topology(n, u, seed=0, groups=g).matching_index_tensor(),
        device=card)
    own, relay = _state(n, 4, 0, card)
    for t in range(0, dst.shape[0], max(1, dst.shape[0] // 5)):
        got = rotor_slice_fwd(own, relay, dst[t], vlb)
        ref = rotor_slice_ref(own, relay, dst[t], vlb)
        torch.cuda.synchronize()
        for x, y in zip(got[:2], ref[:2]):
            torch.testing.assert_close(x, y, atol=1e-5, rtol=0)
        for x, y in zip(got[2:], ref[2:]):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_kernel_is_deterministic(card):
    dst = torch.as_tensor(
        build_opera_topology(108, 6, seed=0).matching_index_tensor()[3],
        device=card)
    own, relay = _state(108, 8, 1, card)
    a = rotor_slice_fwd(own, relay, dst, True)
    b = rotor_slice_fwd(own, relay, dst, True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_wrapper_checks_its_inputs(card):
    dst = torch.full((16, 4), 16, dtype=torch.int32, device=card)
    own, relay = _state(16, 2, 0, card)
    with pytest.raises(TypeError):
        rotor_slice_fwd(own.double(), relay.double(), dst)
    with pytest.raises(ValueError):
        rotor_slice_fwd(own, relay, dst.cpu())
    with pytest.raises(ValueError):
        rotor_slice_fwd(own.transpose(1, 2), relay, dst)


def test_sparse_engine_counts_one_launch_per_slice(card):
    dp = DesignPoint(k=8, num_racks=16)
    cfg = dp.to_config()
    topo = build_opera_topology(16, 4, seed=0)
    dem = scenario_demand("permutation", cfg, 0.5, 0)
    launch_counts.clear()
    got = fluid_torch.simulate_rotor_bulk_batch(
        cfg, dem, max_cycles=5, topo=topo, engine="sparse")
    assert launch_counts["rotor_slice"] == 5 * topo.num_slices
    ref = fluid_torch.simulate_rotor_bulk_batch(
        cfg, dem, max_cycles=5, topo=topo, engine="sparse", device="cpu")
    np.testing.assert_array_equal(got.slices_run, ref.slices_run)
    np.testing.assert_allclose(got.finished_frac, ref.finished_frac, atol=1e-5)
