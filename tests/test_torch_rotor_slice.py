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
from repro.kernels.rotor_slice.ref import rotor_slice_ref as jax_ref
from repro.netsim.fluid import rotor_slice_step as oracle_step
from repro_torch.kernels import launch_counts, pick
from repro_torch.kernels.rotor_slice import rotor_slice_step
from repro_torch.kernels.rotor_slice.kernel import (
    MAX_RACKS,
    rotor_slice_fwd,
    strip_width,
)
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


def _two_pass(own, relay, dst, vlb, strip):
    """The CUDA kernel's arithmetic in plain torch, pass by pass.

    Pass A (rows): the edge sends, q off the live columns, frac, and the
    spread weight scattered to the partner's slot, W[b, dst[i, s], s] =
    share[b, i, s] where frac[b, i] != 0, else 0 (dark slots of the
    partner row are never written, and never read).  Pass B (column
    strips of `strip`): take restaged from own * frac with the columns
    live in each row zeroed through dst[c, s], and each row's relay plus
    the contributing slots' W * take, summed in slot order."""
    bsz, n, u = own.shape[0], own.shape[1], dst.shape[1]
    rows = torch.arange(n)
    valid = dst < n
    dstc = torch.where(valid, dst, 0).long()
    vf = valid.float()[None]
    own_e = own[:, rows[:, None], dstc] * vf
    so = torch.minimum(own_e, vf)
    room = vf - so
    sr = torch.minimum(relay[:, rows[:, None], dstc] * vf, room)
    room = room - sr
    live_col = torch.zeros(n, n, dtype=torch.bool)
    live_col[rows[:, None].expand(n, u)[valid], dst[valid].long()] = True
    q = torch.where(live_col[None], 0.0, own).sum(2)
    r = room.sum(2)
    t = torch.minimum(q, r) if vlb else torch.zeros_like(q)
    frac = torch.where(q > 0, t / q.clamp(min=1e-30), 0.0) if vlb else t
    share = room * torch.where(r > 0, 1.0 / r.clamp(min=1e-30), 0.0)[..., None]
    w = torch.full((bsz, n, u), float("nan"))
    for i in range(n):
        for s in range(u):
            if valid[i, s]:
                w[:, dst[i, s], s] = torch.where(frac[:, i] != 0, share[:, i, s], 0.0)
    own_out = torch.where(live_col[None], own, own - own * frac[..., None])
    own_out[:, rows[:, None].expand(n, u)[valid], dst[valid].long()] = (
        own_e - so)[:, valid]
    relay_out = torch.empty_like(relay)
    for c0 in range(0, n, strip):
        cols = torch.arange(c0, min(c0 + strip, n))
        take = own[:, :, cols] * frac[..., None]
        for c in cols.tolist():
            for s in range(u):
                if valid[c, s]:
                    take[:, dst[c, s], c - c0] = 0.0
        v = relay[:, :, cols].clone()
        acc = torch.zeros_like(v)
        for s in range(u):
            hit = valid[:, s, None] & (dstc[:, s, None] == cols[None])
            v = torch.where(hit[None], v - sr[:, :, s, None], v)
            ws = torch.where(valid[None, :, s], w[:, :, s], 0.0)
            if vlb:
                acc = torch.where((ws != 0)[..., None],
                                  acc + ws[..., None] * take[:, dstc[:, s]], acc)
        relay_out[:, :, cols] = v + acc
    delivered = so.sum((1, 2)) + sr.sum((1, 2))
    return own_out, relay_out, delivered, t.sum(1)


def _topology_point(name):
    if name == "k16-n128-g2":
        from repro.core.topology import build_lifted_opera_topology

        topo = build_lifted_opera_topology(128, 8, seed=0, groups=2,
                                           max_base=64)
        return topo.matching_index_tensor(), (0, 5)
    n, u, g = {"k8-n16-g1": (16, 4, 1), "k8-n16-g2": (16, 4, 2),
               "k12-n108-g1": (108, 6, 1)}[name]
    return build_opera_topology(n, u, seed=0, groups=g).matching_index_tensor(), (0, 3)


@pytest.mark.parametrize("vlb", [False, True])
@pytest.mark.parametrize("name,strip", [
    ("k8-n16-g1", strip_width(16)), ("k8-n16-g2", strip_width(16)),
    ("k16-n128-g2", strip_width(128)),
    ("k12-n108-g1", 32),   # 108 = 3 x 32 + 12: a ragged last strip
])
def test_two_pass_arithmetic_matches_jax_kernel_and_refs(name, strip, vlb):
    """The kernel's two passes (W scattered to the partner slot, take
    restaged strip by strip, slots summed in order) against the JAX
    Pallas kernel in interpret mode, JAX's rotor_slice_ref and the
    port's, at state atol 1e-5 and totals atol 1e-4."""
    dst_all, slices = _topology_point(name)
    n = dst_all.shape[1]
    own, relay = _state(n, bsz=2, seed=3)
    for t in slices:
        dst = dst_all[t]
        got = _two_pass(torch.from_numpy(own), torch.from_numpy(relay),
                        torch.from_numpy(dst), vlb, strip)
        args = (jnp.asarray(own), jnp.asarray(relay), jnp.asarray(dst))
        wants = (jax_step(*args, vlb=vlb, force_pallas=True),
                 jax_ref(*args, vlb=vlb),
                 rotor_slice_ref(torch.from_numpy(own), torch.from_numpy(relay),
                                 torch.from_numpy(dst), vlb))
        for want in wants:
            for i, (g, r) in enumerate(zip(got, want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           atol=1e-5 if i < 2 else 1e-4)


def test_strip_width_fits_shared_memory():
    assert [strip_width(n) for n in (16, 108, 1024, 2048, 4096, MAX_RACKS)] == [
        32, 32, 32, 16, 8, 8]
    with pytest.raises(ValueError):
        strip_width(8192)
