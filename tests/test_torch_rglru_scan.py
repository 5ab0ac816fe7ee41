"""The port's RG-LRU scan (plain version and dispatch) against the JAX
package, on the CPU.

The same seeded numpy inputs go through the JAX Pallas kernel in
interpret mode, the JAX plain version and the port's `ops` / `ref`, at
the sweep of tests/test_kernels.py:73-75 and its tolerances (f32 1e-4,
bf16 2e-2).  `_chunked` repeats the CUDA kernel's arithmetic
(csrc/rglru_scan.cu: chunk ends from zero, the carries in chunk order
from h0, each chunk scanned from its carry) in plain torch, and is held to the same
references and to a float64 sequential loop.
"""
import functools

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


SWEEP = [(1, 32, 16, 8, 8), (2, 64, 8, 8, 32), (1, 48, 24, 12, 16)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,D,bd,bs", SWEEP)
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


def _chunked(a, bx, h0, chunk):
    """rglru_scan.cu's arithmetic in plain torch, pass by pass.

    Pass 1 (`rglru_chunk_ends`): each chunk of `chunk` steps scanned from
    a zero state, its end state e_c and the product P_c of its a's.  Pass
    2 (`rglru_chunk_carry`): the carries H_c = P_c * H_{c-1} + e_c in
    chunk order from h0.  Pass 3 (`rglru_chunk_scan`): chunk c scanned
    from H_{c-1} (h0 for the first) step by step as the plain version
    does."""
    a32, b32 = a.float(), bx.float()
    bsz, s, d = a.shape
    starts = range(0, s, chunk)
    ends = []
    for s0 in starts:
        p, e = torch.ones(bsz, d), torch.zeros(bsz, d)
        for t in range(s0, min(s, s0 + chunk)):
            e = a32[:, t] * e + b32[:, t]
            p = p * a32[:, t]
        ends.append((p, e))
    carries = [h0.float()]
    for p, e in ends[:-1]:
        carries.append(p * carries[-1] + e)
    out = torch.empty(bsz, s, d)
    for h, s0 in zip(carries, starts):
        for t in range(s0, min(s, s0 + chunk)):
            h = a32[:, t] * h + b32[:, t]
            out[:, t] = h
    return out


@functools.lru_cache(maxsize=None)
def _jax_outputs(B, S, D, bd, bs, dtype):
    """The JAX Pallas kernel (interpret mode) and the JAX ref on the
    sweep's seeded inputs, once per case."""
    jdt, _ = DTYPES[dtype]
    a, bx, h0 = _inputs(B, S, D, seed=B * S + D)
    ja, jb = (jnp.asarray(v, jdt) for v in (a, bx))
    kern = j_scan(ja, jb, jnp.asarray(h0), block_d=bd, block_s=bs,
                  interpret=True)
    return np.asarray(kern), np.asarray(j_ref(ja, jb, jnp.asarray(h0)))


@pytest.mark.parametrize("chunk", [8, 20, 64, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,D,bd,bs", SWEEP)
def test_chunked_arithmetic_matches_jax_kernel_and_refs(B, S, D, bd, bs,
                                                        dtype, chunk):
    """Chunks that divide S (8; 64 at S 64), that leave a ragged last
    chunk (20; 64 at S 48) and that hold all of S (128; 64 at S 32)."""
    _, tdt = DTYPES[dtype]
    a, bx, h0 = _inputs(B, S, D, seed=B * S + D)
    ta, tb = (torch.from_numpy(v).to(tdt) for v in (a, bx))
    got = _chunked(ta, tb, torch.from_numpy(h0), chunk)
    for ref in _jax_outputs(B, S, D, bd, bs, dtype):
        np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype))
    # every h_t, h_S the last, against float64 on the same rounded inputs
    a64, b64 = ta.double().numpy(), tb.double().numpy()
    h = h0.astype(np.float64)
    seq = np.empty((B, S, D))
    for t in range(S):
        h = a64[:, t] * h + b64[:, t]
        seq[:, t] = h
    np.testing.assert_allclose(got[:, -1].numpy(), h, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), seq, atol=1e-4, rtol=1e-4)
    if chunk >= S:   # one chunk: the plain version's order, bit for bit
        assert torch.equal(got, rglru_scan_ref(ta, tb, torch.from_numpy(h0)))
