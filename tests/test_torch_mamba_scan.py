"""The port's selective scan (plain version and dispatch) against the
JAX package, on the CPU.

The same seeded numpy inputs go through the JAX Pallas kernel in
interpret mode, the JAX plain version and the port's `ops` / `ref`, at
the sweep of tests/test_kernels.py:47-53 and its tolerances (f32 1e-4,
bf16 2e-2, :69).  The final state ``h_S``, which the port's kernel and
plain version return and the JAX kernel does not, is held to the last
step of a sequential float64 loop in numpy.  `_lane_split` repeats the
CUDA kernel's arithmetic (csrc/mamba_scan.cu: N split over lanes, the
exponential as a power of two of a pre-scaled A, the sum over n in the
lane by fused multiply-adds and then a fixed xor butterfly across lanes,
S run in zero-padded chunks) in plain torch, all but the approximate
exponential's rounding, and is held to the same references.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


def _split(n):
    """The kernel's split of N (Split<NP> in csrc/mamba_scan.cu): NP, N
    rounded up to a power of two, as L lanes of K states; (NP, K, L)."""
    np_ = 1 << (n - 1).bit_length()
    k = min(np_, 2)
    return np_, k, np_ // k


def _lane_split(x, dt, Bm, Cm, A, D, chunk):
    """mamba_scan.cu's arithmetic in plain torch: (y, h_S).

    S is run in chunks of `chunk` steps, the last zero-padded (dt = x = B
    = C = 0 leaves h as it is); N in NP states, those past N on zeros.
    exp(dt A) is 2^(dt (A log2 e)) with A log2 e rounded to f32 first,
    by torch.exp2: the kernel's ex2.approx.ftz is not repeated bit for
    bit, and the card tests hold its error.  Each lane sums its K states'
    C h in order by fused multiply-adds, each a float64 product (exact)
    and sum rounded once to f32, then the L lanes add their sums in an xor
    butterfly (offsets L/2, ..., 1), after which every lane holds the
    same bits."""
    bsz, s, d = x.shape
    n = A.shape[1]
    np_, k, lanes = _split(n)
    pad = -(-s // chunk) * chunk - s
    x32, dt32 = (F.pad(v.float(), (0, 0, 0, pad)) for v in (x, dt))
    b32, c32 = (F.pad(v.float(), (0, np_ - n, 0, pad)) for v in (Bm, Cm))
    a2 = F.pad(A.float(), (0, np_ - n)) * 1.4426950408889634
    lane = torch.arange(lanes)
    h = torch.zeros(bsz, d, np_)
    ys = []
    for t in range(s + pad):
        dbx = (dt32[:, t] * x32[:, t])[..., None]
        h = torch.exp2(dt32[:, t, :, None] * a2) * h + dbx * b32[:, t, None]
        hc = (h.double() * c32[:, t, None].double()).view(bsz, d, lanes, k)
        p = torch.zeros(bsz, d, lanes)
        for i in range(k):
            p = (hc[..., i] + p.double()).float()
        off = lanes // 2
        while off:
            p = p + p[..., lane ^ off]
            off //= 2
        assert torch.equal(p, p[..., :1].expand_as(p))
        ys.append(p[..., 0] + x32[:, t] * D.float())
    return torch.stack(ys[:s], dim=1), h[..., :n]


# the sweep, and N 3, 16 and 32 (B, S, D, N, bd, bs)
SPLIT_CASES = SWEEP + [(1, 20, 12, 3, 4, 10), (1, 16, 8, 16, 8, 8),
                       (1, 12, 4, 32, 4, 4)]


@functools.lru_cache(maxsize=None)
def _jax_outputs(case, dtype):
    """The JAX Pallas kernel (interpret mode) and the JAX ref on the
    case's seeded inputs, once per case."""
    B, S, D, N, bd, bs = case
    jdt, _ = DTYPES[dtype]
    arrs = _inputs(B, S, D, N, seed=B * S + D + N)
    js = [jnp.asarray(a, jdt) for a in arrs[:4]] + [
        jnp.asarray(a) for a in arrs[4:]]
    return (np.asarray(j_scan(*js, block_d=bd, block_s=bs, interpret=True)),
            np.asarray(j_ref(*js)))


@pytest.mark.parametrize("chunk", [8, 10, 16, 64])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_lane_split_arithmetic_matches_jax_kernel_and_refs(case, dtype,
                                                           chunk):
    """Chunks that divide S, that leave a ragged last chunk and that hold
    all of S (64; 16 is the kernel's own); N 2, 3, 4, 8, 16 and 32, so
    one lane (N <= 2), padded states (N 3) and 2-16 lanes."""
    B, S, D, N, bd, bs = case
    _, tdt = DTYPES[dtype]
    arrs = _inputs(B, S, D, N, seed=B * S + D + N)
    ts = [torch.from_numpy(a).to(tdt) for a in arrs[:4]] + [
        torch.from_numpy(a) for a in arrs[4:]]
    y, h = _lane_split(*ts, chunk)
    assert y.shape == (B, S, D) and h.shape == (B, D, N)
    for ref in _jax_outputs(case, dtype):
        np.testing.assert_allclose(y.numpy(), ref, **_tol(dtype))
    seq_y, seq_h = _sequential(*[t.float().numpy() for t in ts])
    np.testing.assert_allclose(h.numpy(), seq_h, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(y.numpy(), seq_y, atol=1e-4, rtol=1e-4)
