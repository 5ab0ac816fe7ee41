"""The plain backward versions of the port's moe_gmm, rglru_scan and
mamba_scan kernels against the JAX package, on the CPU.

Each `*_bwd_ref` (the explicit backward the CUDA kernel in
``csrc/*_bwd.cu`` is held to on the card) is checked against `jax.vjp` of
the JAX package's plain function (`repro.kernels.*.ref`, which its models
differentiate in training) and against torch autograd through the port's
`ref.py`, on the same seeded numpy inputs: f32 within 2e-5 (atol = rtol,
tests/test_kernels.py:15-18), the atol relative to each gradient's
largest value (the sums run in other orders); bf16 inputs within 2e-2.
The bf16 moe_gmm backward kernel's own rounding (A, dG and dU rounded to
bf16 between its f32 sums, ROADMAP Queue 3 B6) is held, as a plain
function, to `jax.vjp` of the JAX package's f32 reference within 2e-2
of each gradient's largest value.  The cases take ragged shapes, mamba's
gradient of h_S (which the JAX
function does not return, so only autograd holds it), rglru's dh0 and
empty MoE capacity rows (zero h rows give zero dh rows whatever their
output gradient).

Each `torch.autograd.Function` is also run here with the plain forward
and the plain backward put in the place of its kernels: its gradients
equal autograd through `ref.py`, and its backward gives None for the
arguments that are not tensors; mamba's saves the forward's chunk
states.  That holds the wiring the card alone would otherwise see.
The rglru backward kernel's order of operations in plain torch
(`rglru_scan_bwd_chunked_ref`) is held to the same `jax.vjp` and plain
backward, and kernel.py's tiling constants to the CUDA source's.
The plain mamba forward's chunk states are the walk's own states at
each chunk start, and the plain backward gives the same bits from them
as without them; the backward kernel's three passes, written as a plain
function, agree with the plain backward.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ref import mamba_scan_ref as j_mamba_ref
from repro.kernels.moe_gmm.ref import moe_gmm_ref as j_moe_gmm_ref
from repro.kernels.rglru_scan.ref import rglru_scan_ref as j_rglru_ref
from repro_torch.kernels.mamba_scan import kernel as mamba_kernel
from repro_torch.kernels.mamba_scan.ops import MambaScanFn
from repro_torch.kernels.mamba_scan.ref import (
    STATE_CHUNK,
    mamba_scan_bwd_ref,
    mamba_scan_ref,
)
from repro_torch.kernels.moe_gmm.ops import MoeGmmFn
from repro_torch.kernels.moe_gmm.ref import moe_gmm_bwd_ref, moe_gmm_ref
from repro_torch.kernels.rglru_scan import kernel as rglru_kernel
from repro_torch.kernels.rglru_scan.ops import RglruScanFn
from repro_torch.kernels.rglru_scan.ref import (
    rglru_scan_bwd_chunked_ref,
    rglru_scan_bwd_ref,
    rglru_scan_ref,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _close(got, want, dtype: str, what: str) -> None:
    """Within tol |want| + tol max|want|."""
    g, w = (np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                       else t, np.float32) for t in (got, want))
    tol = TOL[dtype]
    np.testing.assert_allclose(g, w, rtol=tol,
                               atol=tol * max(float(np.abs(w).max()), 1e-30),
                               err_msg=what)


def _pair(a: np.ndarray, dtype: str):
    """(torch, jax) of the same values, rounded to `dtype` once."""
    jdt, tdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _jax_vjp(fn, primals, cotangent):
    """`jax.vjp` of `fn` at `primals` applied to `cotangent`, jitted."""
    return jax.jit(lambda p, c: jax.vjp(fn, *p)[1](c))(primals, cotangent)


def _autograd(fn, inputs, grads_out):
    leaves = [t.detach().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    used = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
    return torch.autograd.grad([o for o, _ in used], leaves,
                               [g for _, g in used])


# ---------------- moe_gmm ---------------------------------------------------

# E, C, D, F (ragged against the kernel's 64 x 64 tiles and its 16-row steps)
GMM_CASES = [(2, 8, 16, 32), (3, 12, 8, 24), (2, 67, 20, 70), (1, 5, 33, 17)]


def _gmm_inputs(E, C, D, F, seed, empty: int = 0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(E, C, D)).astype(np.float32)
    if empty:   # the dispatch leaves a full expert's last rows empty
        h[:, C - empty:] = 0
    ws = [(rng.normal(size=s) * s[1] ** -0.5).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    dout = rng.normal(size=(E, C, D)).astype(np.float32)
    return [h, *ws], dout


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", GMM_CASES)
def test_moe_gmm_bwd_ref_equals_jax_vjp_and_autograd(case, dtype):
    E, C, D, F = case
    ins, dout = _gmm_inputs(*case, seed=sum(case), empty=C // 4)
    pairs = [_pair(a, dtype) for a in ins]
    tdout, jdout = _pair(dout, dtype)
    got = moe_gmm_bwd_ref(*(t for t, _ in pairs), tdout)
    for g, t in zip(got, (t for t, _ in pairs)):
        assert g.dtype == t.dtype and g.shape == t.shape
    want = _jax_vjp(j_moe_gmm_ref, [j for _, j in pairs], jdout)
    plain = _autograd(moe_gmm_ref, [t for t, _ in pairs], [tdout])
    for name, g, w, p in zip(("dh", "dwg", "dwu", "dwd"), got, want, plain):
        _close(g, w, dtype, f"{name} vs jax.vjp")
        _close(g, p, dtype, f"{name} vs autograd")
    # empty capacity rows: zero dh, though their dout is not zero
    assert not got[0][:, C - C // 4:].any()
    assert np.abs(dout[:, C - C // 4:]).max() > 0


_J_ACTS = {"gelu": jax.nn.gelu, "relu": jax.nn.relu}


def _j_gmm_act(act):
    """The JAX package's expert FFN with the config's activation, as its
    einsum trio computes it (models/moe.py:128-131), in f32 like its
    `moe_gmm_ref`."""
    f = _J_ACTS[act]

    def fn(h, wg, wu, wd):
        h32 = h.astype(jnp.float32)
        g = jnp.einsum("ecd,edf->ecf", h32, wg.astype(jnp.float32))
        u = jnp.einsum("ecd,edf->ecf", h32, wu.astype(jnp.float32))
        return jnp.einsum("ecf,efd->ecd", f(g) * u,
                          wd.astype(jnp.float32)).astype(h.dtype)
    return fn


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", list(_J_ACTS))
@pytest.mark.parametrize("case", GMM_CASES[:3])
def test_moe_gmm_act_refs_equal_jax(case, act, dtype):
    """gelu (tanh form) and relu: `moe_gmm_ref` against the JAX einsum
    trio with `jax.nn.gelu` / `jax.nn.relu`, and `moe_gmm_bwd_ref` (each
    activation's derivative, relu's 0 at 0) against its `jax.vjp` and
    autograd through `moe_gmm_ref`; empty capacity rows give zero dh."""
    E, C, D, F = case
    ins, dout = _gmm_inputs(*case, seed=sum(case) + 7, empty=C // 4)
    pairs = [_pair(a, dtype) for a in ins]
    tdout, jdout = _pair(dout, dtype)
    tins, jins = [t for t, _ in pairs], [j for _, j in pairs]
    jfn = _j_gmm_act(act)
    _close(moe_gmm_ref(*tins, act=act), jfn(*jins), dtype, "forward")
    got = moe_gmm_bwd_ref(*tins, tdout, act=act)
    want = _jax_vjp(jfn, jins, jdout)
    plain = _autograd(lambda *a: moe_gmm_ref(*a, act=act), tins, [tdout])
    for name, g, w, p in zip(("dh", "dwg", "dwu", "dwd"), got, want, plain):
        assert g.dtype == p.dtype and g.shape == p.shape, name
        _close(g, w, dtype, f"{name} vs jax.vjp")
        _close(g, p, dtype, f"{name} vs autograd")
    assert not got[0][:, C - C // 4:].any()


def test_moe_gmm_takes_only_its_activations():
    from repro_torch.kernels.moe_gmm import moe_gmm

    ins, dout = _gmm_inputs(1, 4, 8, 8, seed=2)
    t = [torch.from_numpy(a) for a in ins]
    for fn in (moe_gmm, moe_gmm_ref):
        with pytest.raises(ValueError, match="swish"):
            fn(*t, act="swish")
    with pytest.raises(ValueError, match="swish"):
        moe_gmm_bwd_ref(*t, torch.from_numpy(dout), act="swish")


def _rounded_gmm_backward(h, wg, wu, wd, dout):
    """The bf16 backward kernel's arithmetic (B6): G = h Wg, U = h Wu and
    dA = dout Wd^T summed in f32 from the bf16 inputs; A, dG and dU
    rounded to bf16; dWd = A^T dout, dWg = h^T dG, dWu = h^T dU and dh =
    dG Wg^T + dU Wu^T summed in f32 from those rounded values; each
    gradient rounded once to bf16."""
    h32, wg32, wu32, wd32, d32 = (t.float() for t in (h, wg, wu, wd, dout))
    g = torch.einsum("ecd,edf->ecf", h32, wg32)
    u = torch.einsum("ecd,edf->ecf", h32, wu32)
    da = torch.einsum("ecd,efd->ecf", d32, wd32)
    s = torch.sigmoid(g)
    silu = g * s
    a, dg, du = (t.bfloat16().float() for t in (
        silu * u, da * u * (s * (1 + g * (1 - s))), da * silu))
    dh = (torch.einsum("ecf,edf->ecd", dg, wg32)
          + torch.einsum("ecf,edf->ecd", du, wu32))
    return tuple(t.bfloat16() for t in (
        dh, torch.einsum("ecd,ecf->edf", h32, dg),
        torch.einsum("ecd,ecf->edf", h32, du),
        torch.einsum("ecf,ecd->efd", a, d32)))


@pytest.mark.parametrize("case", GMM_CASES)
def test_moe_gmm_bf16_backward_rounding_is_within_bf16_tolerance(case):
    """dh, dWg, dWu, dWd of the bf16 kernel's arithmetic on bf16 inputs
    against jax.vjp of the JAX package's `moe_gmm_ref` (f32 on the same
    values) within 2e-2 of each gradient's largest value plus 2e-2 of its
    own; empty capacity rows give zero dh."""
    E, C, D, F = case
    ins, dout = _gmm_inputs(*case, seed=sum(case) + 1, empty=C // 4)
    tins = [torch.from_numpy(a).bfloat16() for a in ins]
    tdout = torch.from_numpy(dout).bfloat16()
    got = _rounded_gmm_backward(*tins, tdout)
    want = _jax_vjp(j_moe_gmm_ref,
                    [jnp.asarray(t.float().numpy()) for t in tins],
                    jnp.asarray(tdout.float().numpy()))
    for name, g, w, t in zip(("dh", "dwg", "dwu", "dwd"), got, want, tins):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape, name
        w = np.asarray(w)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=2e-2,
                                   atol=2e-2 * np.abs(w).max(), err_msg=name)
    assert not got[0][:, C - C // 4:].any()


# ---------------- rglru_scan ------------------------------------------------

RGLRU_CASES = [(1, 32, 16), (2, 40, 8), (1, 23, 24), (3, 7, 5)]   # B, S, D


def _rglru_inputs(B, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.7, 0.999, size=(B, S, D)).astype(np.float32),
            rng.normal(size=(B, S, D)).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32)], \
        rng.normal(size=(B, S, D)).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_scan_bwd_ref_equals_jax_vjp_and_autograd(case, dtype):
    (a, bx, h0), dhs = _rglru_inputs(*case, seed=sum(case))
    (ta, ja), (tb, jb) = _pair(a, dtype), _pair(bx, dtype)
    th0, tdhs = torch.from_numpy(h0), torch.from_numpy(dhs)
    hs = rglru_scan_ref(ta, tb, th0)
    got = rglru_scan_bwd_ref(ta, hs, th0, tdhs)
    assert [g.dtype for g in got] == [ta.dtype, ta.dtype, torch.float32]
    want = _jax_vjp(j_rglru_ref, [ja, jb, jnp.asarray(h0)],
                    jnp.asarray(dhs))
    plain = _autograd(rglru_scan_ref, [ta, tb, th0], [tdhs])
    for name, g, w, p in zip(("da", "dbx", "dh0"), got, want, plain):
        _close(g, w, dtype, f"{name} vs jax.vjp")
        _close(g, p, dtype, f"{name} vs autograd")
    assert float(got[2].abs().max()) > 0   # dh0 takes part


# B, S, D, chunk: at the backward kernel's chunk (csrc/rglru_scan_bwd.cu's
# kChunk) and at 8 steps, S at one step, a chunk less one, a chunk, a
# chunk and one, several chunks, and several with a ragged tail (the JAX
# reference traces a step at a time, so the longest S stay short)
RGLRU_CHUNK = rglru_kernel.BWD_CHUNK
RGLRU_CHUNKED_CASES = [
    (1, 1, 6, RGLRU_CHUNK), (2, RGLRU_CHUNK - 1, 5, RGLRU_CHUNK),
    (3, RGLRU_CHUNK, 4, RGLRU_CHUNK), (1, RGLRU_CHUNK + 1, 7, RGLRU_CHUNK),
    (2, 2 * RGLRU_CHUNK + 5, 3, RGLRU_CHUNK),
    (1, 1, 3, 8), (2, 7, 5, 8), (3, 8, 4, 8), (1, 9, 6, 8), (2, 32, 5, 8),
    (3, 45, 3, 8)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", RGLRU_CHUNKED_CASES)
def test_rglru_scan_bwd_chunked_ref_equals_jax_vjp_and_plain(case, dtype):
    """The backward kernel's order of operations in plain torch (chunk
    walks from zero, the carries folded from the last chunk, the chunks
    walked again from their carries), which the card holds the kernel to
    bit for bit: within the tolerances of `jax.vjp` of the JAX package's
    `rglru_scan_ref` and of the plain backward `rglru_scan_bwd_ref`."""
    *shape, chunk = case
    (a, bx, h0), dhs = _rglru_inputs(*shape, seed=sum(case) + 5)
    (ta, ja), (tb, jb) = _pair(a, dtype), _pair(bx, dtype)
    th0, tdhs = torch.from_numpy(h0), torch.from_numpy(dhs)
    hs = rglru_scan_ref(ta, tb, th0)
    got = rglru_scan_bwd_chunked_ref(ta, hs, th0, tdhs, chunk)
    assert [g.dtype for g in got] == [ta.dtype, ta.dtype, torch.float32]
    assert [g.shape for g in got] == [ta.shape, ta.shape, th0.shape]
    want = _jax_vjp(j_rglru_ref, [ja, jb, jnp.asarray(h0)],
                    jnp.asarray(dhs))
    plain = rglru_scan_bwd_ref(ta, hs, th0, tdhs)
    for name, g, w, p in zip(("da", "dbx", "dh0"), got, want, plain):
        _close(g, w, dtype, f"{name} vs jax.vjp")
        _close(g, p, dtype, f"{name} vs rglru_scan_bwd_ref")


def test_rglru_backward_tiling_matches_the_kernel_source():
    """kernel.py's backward tiling constants are the CUDA source's
    constexprs."""
    src = rglru_kernel.BWD_SOURCE.read_text()

    def constant(name):
        m = re.search(rf"^constexpr int {name} = (\d+);", src, re.M)
        assert m, f"{name} not in {rglru_kernel.BWD_SOURCE.name}"
        return int(m.group(1))

    assert constant("kChunk") == RGLRU_CHUNK
    assert constant("kThreads") == rglru_kernel.BWD_CHANNELS


# ---------------- mamba_scan ------------------------------------------------

# B, S, D, N: from the sweep of tests/test_kernels.py:47-53, and ragged
MAMBA_CASES = [(1, 16, 8, 4), (2, 16, 8, 8), (1, 12, 12, 2), (1, 21, 33, 5),
               (2, 13, 7, 16)]


def _mamba_inputs(B, S, D, N, seed):
    rng = np.random.default_rng(seed)
    ins = [rng.normal(size=(B, S, D)).astype(np.float32),
           rng.uniform(0.01, 0.2, size=(B, S, D)).astype(np.float32),
           rng.normal(size=(B, S, N)).astype(np.float32),
           rng.normal(size=(B, S, N)).astype(np.float32),
           -np.exp(rng.normal(size=(D, N))).astype(np.float32),
           rng.normal(size=(D,)).astype(np.float32)]
    return ins, (rng.normal(size=(B, S, D)).astype(np.float32),
                 rng.normal(size=(B, D, N)).astype(np.float32))


def _mamba_pairs(ins, dtype):
    """x, dt, B, C in `dtype`; A and D float32, as the model passes them."""
    return [_pair(a, dtype if i < 4 else "float32")
            for i, a in enumerate(ins)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MAMBA_CASES)
def test_mamba_scan_bwd_ref_equals_jax_vjp_and_autograd(case, dtype):
    ins, (dy, dhS) = _mamba_inputs(*case, seed=sum(case))
    pairs = _mamba_pairs(ins, dtype)
    tins = [t for t, _ in pairs]
    tdy, tdhs = torch.from_numpy(dy), torch.from_numpy(dhS)
    names = ("dx", "ddt", "dBm", "dCm", "dA", "dD")
    # y's gradient alone: the JAX function returns y only
    got = mamba_scan_bwd_ref(*tins, tdy)
    assert [g.dtype for g in got] == [t.dtype for t in tins]
    want = _jax_vjp(j_mamba_ref, [j for _, j in pairs], jnp.asarray(dy))
    plain = _autograd(mamba_scan_ref, tins, [tdy, None])
    for name, g, w, p in zip(names, got, want, plain):
        _close(g, w, dtype, f"{name} vs jax.vjp")
        _close(g, p, dtype, f"{name} vs autograd")
    # and h_S's gradient beside it
    got = mamba_scan_bwd_ref(*tins, tdy, tdhs)
    plain = _autograd(mamba_scan_ref, tins, [tdy, tdhs])
    for name, g, p in zip(names, got, plain):
        _close(g, p, dtype, f"{name} with dhS vs autograd")


# S on and beside the saved states' chunk: 1, T - 1, T, T + 1, 3 T + 5
T = STATE_CHUNK
STATE_CASES = MAMBA_CASES + [(1, 1, 6, 4), (2, T - 1, 5, 3), (1, T, 9, 16),
                             (2, T + 1, 7, 8), (1, 3 * T + 5, 10, 5)]


@pytest.mark.parametrize("case", STATE_CASES)
def test_mamba_scan_ref_states_are_the_walks_chunk_starts(case):
    """The plain forward's chunk states: zero before step 0, and before
    step q T the h_S of the same walk over the first q T steps, bit for
    bit; y and h_S the same bits with and without them."""
    B, S, D, N = case
    ins, _ = _mamba_inputs(*case, seed=sum(case) + 7)
    tins = [torch.from_numpy(a) for a in ins]
    y, h = mamba_scan_ref(*tins)
    ky, kh, states = mamba_scan_ref(*tins, states=True)
    assert torch.equal(y, ky) and torch.equal(h, kh)
    assert states.shape == (B, -(-S // T), D, N)
    assert states.dtype == torch.float32 and not states[:, 0].any()
    for q in range(1, states.shape[1]):
        head = [t[:, :q * T] if t.dim() == 3 else t for t in tins]
        assert torch.equal(states[:, q], mamba_scan_ref(*head)[1]), q


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", STATE_CASES)
def test_mamba_scan_bwd_ref_from_saved_states(case, dtype):
    """The plain backward given the forward's chunk states: the same bits
    as without them, and within tolerance of jax.vjp of the JAX
    package's `mamba_scan_ref` (y's gradient; h_S's beside it held to
    autograd through the port's)."""
    ins, (dy, dhS) = _mamba_inputs(*case, seed=sum(case) + 8)
    pairs = _mamba_pairs(ins, dtype)
    tins = [t for t, _ in pairs]
    tdy, tdhs = torch.from_numpy(dy), torch.from_numpy(dhS)
    states = mamba_scan_ref(*tins, states=True)[2]
    names = ("dx", "ddt", "dBm", "dCm", "dA", "dD")
    got = mamba_scan_bwd_ref(*tins, tdy, None, states)
    for name, g, w in zip(names, got, mamba_scan_bwd_ref(*tins, tdy)):
        assert torch.equal(g, w), name
    want = _jax_vjp(j_mamba_ref, [j for _, j in pairs], jnp.asarray(dy))
    for name, g, w in zip(names, got, want):
        _close(g, w, dtype, f"{name} from states vs jax.vjp")
    got = mamba_scan_bwd_ref(*tins, tdy, tdhs, states)
    for name, g, w in zip(names, got, mamba_scan_bwd_ref(*tins, tdy, tdhs)):
        assert torch.equal(g, w), f"{name} with dhS"
    plain = _autograd(mamba_scan_ref, tins, [tdy, tdhs])
    for name, g, p in zip(names, got, plain):
        _close(g, p, dtype, f"{name} from states with dhS vs autograd")
    with pytest.raises(ValueError):
        mamba_scan_bwd_ref(*tins, tdy, None, states[:, :, :1])


# the backward kernel's chunk of its local and carry passes, and the chunks
# a main-pass block walks (csrc/mamba_scan_bwd.cu's kChunk and kSpan, which
# the library reports and kernel.bwd_library checks against these)
KERNEL_CHUNK, KERNEL_SPAN = mamba_kernel.BWD_CHUNK, mamba_kernel.BWD_SPAN


def test_backward_tiling_matches_the_kernel_source():
    """kernel.py's tiling constants are the CUDA source's constexprs."""
    src = mamba_kernel.BWD_SOURCE.read_text()

    def constant(name):
        m = re.search(rf"^constexpr int {name} = (\d+);", src, re.M)
        assert m, f"{name} not in {mamba_kernel.BWD_SOURCE.name}"
        return int(m.group(1))

    assert constant("kStep") == STATE_CHUNK
    assert constant("kChunk") == KERNEL_CHUNK
    assert KERNEL_CHUNK % STATE_CHUNK == 0
    assert constant("kSpan") == KERNEL_SPAN
    for n in (1, 2, 3, 5, 8, 16, 17, 32):
        np2 = 1 << (n - 1).bit_length()       # Split<NP>: L lanes of K
        lanes = np2 // min(np2, constant("kMaxK"))
        assert mamba_kernel.bwd_channels(n) == min(constant("kMaxChannels"),
                                                   256 // lanes), n


def _three_pass_bwd(x, dt, Bm, Cm, A, D, dy, dhS, states):
    """csrc/mamba_scan_bwd.cu's passes in plain torch, all but the lanes'
    summation order and the approximate exponential: each 64-step chunk's
    g walked back from zero with the product of its e_t (local pass); the
    carries into every chunk from dh_S (carry pass); each span of chunks
    from the carry into its last, its 16-step pieces rebuilt from the
    forward's chunk states and walked back, ddt's x B term as x times
    dx's sum over n (main pass); dA and dD summed a span at a time."""
    Bsz, S, Dd = x.shape
    T, C = STATE_CHUNK, KERNEL_CHUNK
    x, dt, Bm, Cm, dy = (t.float() for t in (x, dt, Bm, Cm, dy))
    nc = -(-S // C)
    e = torch.exp(dt[..., None] * A)                       # (B, S, D, N)
    cdy = Cm[:, :, None, :] * dy[..., None]
    out, decay = [None] * nc, [None] * nc
    for q in range(1, nc):
        g = torch.zeros_like(e[:, 0])
        p = torch.ones_like(g)
        for t in range(min(S, q * C + C) - 1, q * C - 1, -1):
            g = e[:, t] * (g + cdy[:, t])
            p = p * e[:, t]
        out[q], decay[q] = g, p
    carry = [None] * nc
    g = torch.zeros_like(e[:, 0]) if dhS is None else dhS.float()
    for q in range(nc - 1, 0, -1):
        carry[q] = g
        g = out[q] + decay[q] * g
    carry[0] = g
    dx, ddt = torch.zeros_like(x), torch.zeros_like(x)
    dB, dC = torch.zeros_like(Bm), torch.zeros_like(Cm)
    dA, dD = torch.zeros_like(A), torch.zeros(Dd)
    for y in range(-(-nc // KERNEL_SPAN)):
        q_last = min((y + 1) * KERNEL_SPAN, nc) - 1
        g, sum_a = carry[q_last], torch.zeros_like(A)
        for qs in range((q_last + 1) * (C // T) - 1,
                        y * KERNEL_SPAN * (C // T) - 1, -1):
            if qs * T >= S:
                continue
            h, us = states[:, qs], {}
            steps = range(qs * T, min(S, qs * T + T))
            for t in steps:
                us[t] = e[:, t] * h
                h = us[t] + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None]
                dC[:, t] = torch.einsum("bdn,bd->bn", h, dy[:, t])
            for t in reversed(steps):
                g = g + cdy[:, t]
                px = (g * Bm[:, t, None]).sum(-1)
                gu = g * us[t]
                dx[:, t] = px * dt[:, t] + dy[:, t] * D
                ddt[:, t] = x[:, t] * px + (gu * A).sum(-1)
                sum_a = sum_a + (gu * dt[:, t, :, None]).sum(0)
                dB[:, t] = torch.einsum("bdn,bd->bn", g, dt[:, t] * x[:, t])
                g = e[:, t] * g
        dA = dA + sum_a
        span = slice(y * KERNEL_SPAN * C, (q_last + 1) * C)
        dD = dD + (dy[:, span] * x[:, span]).sum((0, 1))
    return dx, ddt, dB, dC, dA, dD


@pytest.mark.parametrize("with_hs", [False, True])
@pytest.mark.parametrize("case", STATE_CASES + [(1, 64, 6, 4), (2, 65, 5, 3),
                                                (1, 129, 7, 8),
                                                (1, 197, 4, 16)])
def test_backward_kernel_passes_equal_the_plain_backward(case, with_hs):
    """The backward kernel's decomposition (`_three_pass_bwd`, f32) from
    the plain forward's chunk states: within 2e-5 of `mamba_scan_bwd_ref`
    (which the tests above hold to jax.vjp of the JAX package's
    `mamba_scan_ref`), over one chunk, several, a span and a half, and
    ragged ends."""
    ins, (dy, dhS) = _mamba_inputs(*case, seed=sum(case) + 9)
    tins = [torch.from_numpy(a) for a in ins]
    tdy = torch.from_numpy(dy)
    tdhs = torch.from_numpy(dhS) if with_hs else None
    states = mamba_scan_ref(*tins, states=True)[2]
    got = _three_pass_bwd(*tins, tdy, tdhs, states)
    want = mamba_scan_bwd_ref(*tins, tdy, tdhs)
    names = ("dx", "ddt", "dBm", "dCm", "dA", "dD")
    for name, g, w in zip(names, got, want):
        _close(g, w, "float32", f"{name} vs mamba_scan_bwd_ref")


# ---------------- the autograd Functions, kernels replaced ------------------


def _spy(fn, calls):
    def run(*args):
        calls.append(args)
        return fn(*args)
    return run


@pytest.mark.parametrize("kernel", ["moe_gmm", "rglru_scan", "mamba_scan",
                                    "mamba_scan_h_s"])
def test_function_wiring_with_plain_kernels(kernel):
    """The Function with the plain forward and backward in its kernels'
    place: the same outputs and input gradients as autograd through
    `ref.py`, one call of each, and None for its two callables."""
    if kernel == "moe_gmm":
        ins, dout = _gmm_inputs(2, 9, 12, 20, seed=1, empty=2)
        ins = [torch.from_numpy(a) for a in ins]
        fn, ref, bwd, outs = MoeGmmFn, moe_gmm_ref, moe_gmm_bwd_ref, [dout]
    elif kernel == "rglru_scan":
        ins, dhs = _rglru_inputs(2, 70, 6, seed=2)
        ins = [torch.from_numpy(a) for a in ins]
        fn, ref, bwd, outs = RglruScanFn, rglru_scan_ref, rglru_scan_bwd_ref, \
            [dhs]
    else:
        ins, (dy, dhS) = _mamba_inputs(2, 21, 9, 6, seed=3)
        ins = [torch.from_numpy(a) for a in ins]
        fn, ref, bwd = MambaScanFn, mamba_scan_ref, mamba_scan_bwd_ref
        outs = [dy, dhS if kernel == "mamba_scan_h_s" else None]
    outs = [None if o is None else torch.from_numpy(o) for o in outs]
    fwd_calls, bwd_calls = [], []
    leaves = [t.detach().requires_grad_() for t in ins]
    got = fn.apply(*leaves, _spy(ref, fwd_calls), _spy(bwd, bwd_calls))
    got = got if isinstance(got, tuple) else (got,)
    want = ref(*ins)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w)
    # the backward's own outputs: a gradient a tensor, None a callable
    direct = got[0].grad_fn.apply(*outs)
    assert len(direct) == len(ins) + 2
    assert all(isinstance(g, torch.Tensor) for g in direct[:len(ins)])
    assert direct[-2:] == (None, None)
    if fn is MambaScanFn:   # the forward's chunk states, kept
        saved = got[0].grad_fn.saved_tensors
        assert len(saved) == len(ins) + 1
        assert torch.equal(saved[-1], ref(*ins, states=True)[2])
    used = [(o, g) for o, g in zip(got, outs) if g is not None]
    grads = torch.autograd.grad([o for o, _ in used], leaves,
                                [g for _, g in used])
    plain = _autograd(ref, ins, outs)
    for g, d, p in zip(grads, direct, plain):
        assert torch.equal(g, d)
        _close(g, p, "float32", kernel)
    assert len(fwd_calls) == 1 and len(bwd_calls) == 2
