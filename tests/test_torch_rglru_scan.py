"""The port's RG-LRU scan (plain version and dispatch) against the JAX
package, on the CPU.

The same seeded numpy inputs go through the JAX Pallas kernel in
interpret mode, the JAX plain version and the port's `ops` / `ref`, at
the sweep of tests/test_kernels.py:73-75 and its tolerances (f32 1e-4,
bf16 2e-2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import rglru_scan as j_scan
from repro.kernels.rglru_scan import rglru_scan_ref as j_ref
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(
        atol=1e-4, rtol=1e-4)


def _inputs(B, S, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.7, 0.999, size=(B, S, D)).astype(np.float32),
            rng.normal(size=(B, S, D)).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,D,bd,bs",
                         [(1, 32, 16, 8, 8), (2, 64, 8, 8, 32),
                          (1, 48, 24, 12, 16)])
def test_matches_jax_kernel_and_ref(B, S, D, bd, bs, dtype):
    jdt, tdt = DTYPES[dtype]
    a, bx, h0 = _inputs(B, S, D, seed=B * S + D)
    ta, tb = (torch.from_numpy(v).to(tdt) for v in (a, bx))
    th0 = torch.from_numpy(h0)
    ja, jb = (jnp.asarray(v, jdt) for v in (a, bx))
    got = rglru_scan(ta, tb, th0)
    assert got.dtype == torch.float32 and got.shape == (B, S, D)
    torch.testing.assert_close(got, rglru_scan_ref(ta, tb, th0), atol=0,
                               rtol=0)
    kern = j_scan(ja, jb, jnp.asarray(h0), block_d=bd, block_s=bs,
                  interpret=True)
    for ref in (kern, j_ref(ja, jb, jnp.asarray(h0))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   **_tol(dtype))


def test_h0_is_the_folded_first_input():
    """Passing h0 equals the JAX model's fold of h0 into bx[:, 0] from a
    zero state (rglru.py:58)."""
    a, bx, h0 = (torch.from_numpy(v) for v in _inputs(2, 12, 6, seed=5))
    folded = bx.clone()
    folded[:, 0] += a[:, 0] * h0
    torch.testing.assert_close(rglru_scan(a, bx, h0),
                               rglru_scan(a, folded, torch.zeros_like(h0)),
                               atol=1e-6, rtol=1e-6)
