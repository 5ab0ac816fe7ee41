"""The port's grouped expert FFN (plain version and dispatch) against the
JAX package, on the CPU.

The same seeded numpy inputs go through the JAX Pallas kernel in
interpret mode, the JAX plain version and the port's `ops` / `ref`, at
the sweep of tests/test_kernels.py:89-92 and its tolerances (f32 2e-5,
bf16 2e-2).  The card's kernel sums in another order than the plain
version (D and F cut into interleaved slices, added in a fixed order);
that order, written out here in plain torch, is held to the same
references at the same tolerances, and `kernel.plan`, which picks the
kernel's rows per block and load width, is checked at the model's
shapes.  The backward's source includes its wgmma header, which keys its
library.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm import moe_gmm as j_gmm
from repro.kernels.moe_gmm import moe_gmm_ref as j_ref
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ref
from repro_torch.kernels import library_path
from repro_torch.kernels.moe_gmm.kernel import (
    BWD_SOURCE,
    LANES_X,
    WARPS,
    plan,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(E, C, D, F, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(E, C, D)).astype(np.float32),
            (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32),
            (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32),
            (rng.normal(size=(E, F, D)) * 0.1).astype(np.float32)]


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
    arrs = _inputs(E, C, D, F, seed=E * C + D)
    ts = [torch.from_numpy(a).to(tdt) for a in arrs]
    js = [jnp.asarray(a, jdt) for a in arrs]
    got = moe_gmm(*ts)
    assert got.dtype == tdt and got.shape == (E, C, D)
    torch.testing.assert_close(got, moe_gmm_ref(*ts), atol=0, rtol=0)
    kern = j_gmm(*js, block_c=bc, block_f=bf, interpret=True)
    for ref in (kern, j_ref(*js)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), **_tol(dtype))


def _sliced_sum(x, w, warps):
    """x (E, C, K) @ w (E, K, N) as the kernel sums it over `warps`
    warps: with 32 / LANES_X slices a warp, row k of the summed dimension
    goes to slice k % slices, each slice summed in order with one
    rounding per step (fmaf: the product and the sum in f64, rounded to
    f32), then a warp's slices added pairwise ((0 + 1) + (2 + 3) ...),
    then the warps in order."""
    E, C, K = x.shape
    N = w.shape[2]
    per_warp = 32 // LANES_X
    slices = warps * per_warp
    part = torch.zeros((E, C, slices, N), dtype=torch.float32)
    for k in range(K):
        s = k % slices
        part[:, :, s] = (part[:, :, s].double() + x[:, :, k, None].double()
                         * w[:, None, k, :].double()).float()
    grp = part.reshape(E, C, warps, per_warp, N)
    while grp.shape[3] > 1:
        grp = grp[:, :, :, 0::2] + grp[:, :, :, 1::2]
    total = torch.zeros((E, C, N), dtype=torch.float32)
    for warp in range(warps):
        total = total + grp[:, :, warp, 0]
    return total


def _kernel_order(h, wg, wu, wd):
    """The card kernel's arithmetic in plain torch: g and u each over
    half the warps, silu as g / (1 + exp(-g)), the down pass over all
    warps, all in f32, the output rounded once."""
    h32 = h.float()
    g = _sliced_sum(h32, wg.float(), WARPS // 2)
    u = _sliced_sum(h32, wu.float(), WARPS // 2)
    act = g / (1.0 + torch.exp(-g)) * u
    return _sliced_sum(act, wd.float(), WARPS).to(h.dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "E,C,D,F,bc,bf",
    [(2, 16, 16, 32, 8, 16), (4, 8, 32, 64, 8, 32), (3, 12, 8, 24, 4, 8),
     (2, 5, 200, 72, 5, 24), (2, 9, 70, 130, 3, 26)],
)
def test_kernel_summation_order_matches_jax_kernel_and_ref(
        E, C, D, F, bc, bf, dtype):
    jdt, tdt = DTYPES[dtype]
    arrs = _inputs(E, C, D, F, seed=E + C * D)
    ts = [torch.from_numpy(a).to(tdt) for a in arrs]
    js = [jnp.asarray(a, jdt) for a in arrs]
    got = _kernel_order(*ts)
    assert got.dtype == tdt and got.shape == (E, C, D)
    torch.testing.assert_close(got.float(), moe_gmm_ref(*ts).float(),
                               **_tol(dtype))
    kern = j_gmm(*js, block_c=bc, block_f=bf, interpret=True)
    for ref in (kern, j_ref(*js)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), **_tol(dtype))


@pytest.mark.parametrize("case,want", [
    # qwen3-moe decode (4 slots) and prefills: serve_full's capacities run
    # from 12 to 36, a 512-token prompt gives 40
    ((128, 4, 2048, 768, torch.bfloat16), (4, 1, True, True, 768, 2048)),
    ((128, 12, 2048, 768, torch.bfloat16), (4, 3, True, True, 2304, 6144)),
    ((128, 16, 2048, 768, torch.bfloat16), (8, 2, True, True, 1536, 4096)),
    ((128, 36, 2048, 768, torch.bfloat16), (4, 9, True, True, 6912, 18432)),
    ((128, 40, 2048, 768, torch.bfloat16), (8, 5, True, True, 3840, 10240)),
    ((128, 4, 2048, 768, torch.float32), (4, 1, True, True, 1536, 4096)),
    ((16, 1, 2048, 768, torch.bfloat16), (4, 1, True, True, 96, 256)),
    ((16, 8, 2048, 768, torch.bfloat16), (8, 1, True, True, 96, 256)),
    ((16, 9, 2048, 768, torch.bfloat16), (4, 3, True, True, 288, 768)),
    # rows not a whole number of 16-byte loads take the scalar loads
    ((3, 3, 300, 260, torch.bfloat16), (4, 1, False, False, 9, 9)),
    ((3, 3, 300, 260, torch.float32), (4, 1, True, True, 15, 15)),
    ((2, 14, 301, 259, torch.float32), (8, 2, False, False, 20, 20)),
    ((2, 9, 2304, 96, torch.bfloat16), (4, 3, True, True, 6, 108)),
])
def test_plan(case, want):
    assert tuple(plan(*case)) == want


def test_backward_source_includes_its_wgmma_header(tmp_path):
    """The backward's source includes the header of wgmma pieces beside
    it, whose bytes key the backward's library (nvcc is not given it)."""
    header = BWD_SOURCE.with_name("moe_wgmma.cuh")
    assert '#include "moe_wgmma.cuh"' in BWD_SOURCE.read_text()
    src = tmp_path / BWD_SOURCE.name
    src.write_bytes(BWD_SOURCE.read_bytes())
    (tmp_path / header.name).write_bytes(header.read_bytes())
    first = library_path("moe_gmm_bwd", [src])
    (tmp_path / header.name).write_bytes(header.read_bytes() + b"\n")
    assert library_path("moe_gmm_bwd", [src]) != first
