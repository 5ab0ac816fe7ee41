"""The port's selective scan (plain version and dispatch) against the
JAX package, on the CPU.

The same seeded numpy inputs go through the JAX Pallas kernel in
interpret mode, the JAX plain version and the port's `ops` / `ref`, at
the sweep of tests/test_kernels.py:47-53 and its tolerances (f32 1e-4,
bf16 2e-2, :69).  The final state ``h_S``, which the port's kernel and
plain version return and the JAX kernel does not, is held to the last
step of a sequential float64 loop in numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import mamba_scan as j_scan
from repro.kernels.mamba_scan import mamba_scan_ref as j_ref
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SWEEP = [(1, 16, 8, 4, 8, 8), (2, 32, 16, 4, 8, 16), (1, 24, 12, 2, 4, 8),
         (2, 16, 8, 8, 8, 4)]   # B, S, D, N, bd, bs


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(
        atol=1e-4, rtol=1e-4)


def _inputs(B, S, D, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, D)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(B, S, D)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            -np.exp(rng.normal(size=(D, N))).astype(np.float32),
            rng.normal(size=(D,)).astype(np.float32))


def _sequential(x, dt, Bm, Cm, A, D):
    """The recurrence step by step in float64: (y, h_S)."""
    x, dt, Bm, Cm, A, D = (np.asarray(a, np.float64) for a in
                           (x, dt, Bm, Cm, A, D))
    h = np.zeros((x.shape[0], x.shape[2], A.shape[1]))
    ys = []
    for t in range(x.shape[1]):
        h = (np.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :])
        ys.append(np.einsum("bdn,bn->bd", h, Cm[:, t]) + D * x[:, t])
    return np.stack(ys, axis=1), h


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SWEEP)
def test_matches_jax_kernel_and_ref(case, dtype):
    B, S, D, N, bd, bs = case
    jdt, tdt = DTYPES[dtype]
    arrs = _inputs(B, S, D, N, seed=B * S + D + N)
    # x, dt, B, C in the sweep's type; A and D float32 (test_kernels.py:58-60)
    ts = [torch.from_numpy(a).to(tdt) for a in arrs[:4]] + [
        torch.from_numpy(a) for a in arrs[4:]]
    js = [jnp.asarray(a, jdt) for a in arrs[:4]] + [
        jnp.asarray(a) for a in arrs[4:]]
    y, h = mamba_scan(*ts)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, D) and h.shape == (B, D, N)
    ry, rh = mamba_scan_ref(*ts)
    torch.testing.assert_close(y, ry, atol=0, rtol=0)
    torch.testing.assert_close(h, rh, atol=0, rtol=0)
    kern = j_scan(*js, block_d=bd, block_s=bs, interpret=True)
    for ref in (kern, j_ref(*js)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ref), **_tol(dtype))
    # h_S against a sequential loop on the same (rounded) inputs
    seq_y, seq_h = _sequential(*[t.float().numpy() for t in ts])
    np.testing.assert_allclose(h.numpy(), seq_h, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(y.numpy(), seq_y, atol=1e-4, rtol=1e-4)


def test_model_dtypes_match_jax_ref():
    """x in bf16 beside f32 dt, B, C (ssm.py:54-55), as the model passes
    them: the port takes each type as it comes."""
    arrs = _inputs(2, 20, 12, 4, seed=7)
    ts = [torch.from_numpy(arrs[0]).bfloat16()] + [
        torch.from_numpy(a) for a in arrs[1:]]
    js = [jnp.asarray(arrs[0], jnp.bfloat16)] + [jnp.asarray(a)
                                                  for a in arrs[1:]]
    y, h = mamba_scan(*ts)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_ref(*js)),
                               atol=1e-4, rtol=1e-4)
    _, seq_h = _sequential(*[t.float().numpy() for t in ts])
    np.testing.assert_allclose(h.numpy(), seq_h, atol=1e-4, rtol=1e-4)


def test_state_carries_the_sequence():
    """Scanning a sequence in two halves, the second from the first's
    h_S, is the whole scan: h_S is the carried state decode needs."""
    x, dt, Bm, Cm, A, D = [torch.from_numpy(a) for a in
                           _inputs(1, 16, 8, 4, seed=9)]
    y, h = mamba_scan(x, dt, Bm, Cm, A, D)
    _, h1 = mamba_scan(x[:, :9], dt[:, :9], Bm[:, :9], Cm[:, :9], A, D)
    # the second half from h1 by the recurrence in float64
    h2 = h1.double()
    for t in range(9, 16):
        h2 = (torch.exp(dt[:, t, :, None].double() * A.double()) * h2
              + (dt[:, t] * x[:, t]).double()[..., None]
              * Bm[:, t, None, :].double())
    torch.testing.assert_close(h.double(), h2, atol=1e-5, rtol=1e-5)
