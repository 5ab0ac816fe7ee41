"""The port's grouped expert FFN (plain version and dispatch) against the
JAX package, on the CPU.

The same seeded numpy inputs go through the JAX Pallas kernel in
interpret mode, the JAX plain version and the port's `ops` / `ref`, at
the sweep of tests/test_kernels.py:89-92 and its tolerances (f32 2e-5,
bf16 2e-2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm import moe_gmm as j_gmm
from repro.kernels.moe_gmm import moe_gmm_ref as j_ref
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "E,C,D,F,bc,bf",
    [(2, 16, 16, 32, 8, 16), (4, 8, 32, 64, 8, 32), (3, 12, 8, 24, 4, 8)],
)
def test_matches_jax_kernel_and_ref(E, C, D, F, bc, bf, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(E * C + D)
    arrs = [rng.normal(size=(E, C, D)).astype(np.float32),
            (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32),
            (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32),
            (rng.normal(size=(E, F, D)) * 0.1).astype(np.float32)]
    ts = [torch.from_numpy(a).to(tdt) for a in arrs]
    js = [jnp.asarray(a, jdt) for a in arrs]
    got = moe_gmm(*ts)
    assert got.dtype == tdt and got.shape == (E, C, D)
    torch.testing.assert_close(got, moe_gmm_ref(*ts), atol=0, rtol=0)
    kern = j_gmm(*js, block_c=bc, block_f=bf, interpret=True)
    for ref in (kern, j_ref(*js)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), **_tol(dtype))
