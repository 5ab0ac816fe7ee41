"""The port's flash attention (plain version and dispatch) against the
JAX package, on the CPU.

The same seeded numpy inputs go through the JAX Pallas kernel in
interpret mode, the JAX plain version and the port's `ops` / `ref`, at
the sweep of tests/test_kernels.py:21-33 and its tolerances (f32 2e-5,
bf16 2e-2), plus ragged lengths (which the port's kernel masks itself)
and the model's `chunked_attention` (tests/test_kernels.py:106).  The
card's bf16 kernel rounds P to bf16 before P V (ROADMAP Queue 3, B3);
its arithmetic, written out here in plain torch, stays within the bf16
tolerance of the plain version.  A head dim between the kernel's
instantiations runs zero-padded to the next one (above 256 on the f32
kernel's hd-512 and hd-1024 instantiations, bf16 widened to f32 around
the call; above 1024 the wrapper raises); that arithmetic, too, is held
to the JAX package here.  The cross-attention layers' modes (non-causal
with Sq > Sk, non-causal over 1,600 keys at hd 128 with 8 query heads a
KV head, MHA at hd 64 with ragged lengths) are held to the JAX kernel in
interpret mode, in bf16 through the card's arithmetic too.  The card's
bf16 backward kernels round P and dS to bf16 before the products they
feed (ROADMAP Queue 3, B4); their arithmetic, written out here in plain
torch, stays within 2e-2 of each gradient's largest value of `jax.vjp`
of the model's `chunked_attention`, also where the hd-256 dK/dV pass cuts
a group of query heads into parts whose f32 sums are added in order
(`bwd_kv_splits`, its rule checked here).  The build keys each library
by the headers beside its sources too, which nvcc is not given.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_attention_ref as j_ref
from repro.models.attention import chunked_attention
from repro_torch import kernels
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_attention.kernel import (
    BWD_SOURCE,
    HEAD_DIMS,
    SOURCE,
    bwd_kv_splits,
    padded_head_dim,
)
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask

SWEEP = [  # B, Hq, Hkv, Sq, Sk, hd, causal, window, bq, bk
    (1, 2, 2, 64, 64, 32, True, 0, 32, 32),     # MHA causal
    (2, 4, 2, 64, 64, 64, True, 0, 16, 32),     # GQA
    (1, 8, 1, 32, 32, 32, True, 0, 16, 16),     # MQA
    (1, 2, 2, 64, 64, 32, False, 0, 32, 32),    # bidirectional
    (1, 2, 1, 64, 64, 32, True, 24, 16, 16),    # sliding window
    (1, 2, 2, 32, 96, 32, True, 0, 16, 32),     # cross lens (decode-ish)
    (1, 3, 1, 48, 48, 16, True, 0, 16, 16),     # non-pow2 heads
]
RAGGED = [  # B, Hq, Hkv, Sq, Sk, hd, causal, window
    (1, 4, 2, 40, 72, 32, True, 0),     # lengths no tile divides
    (1, 2, 1, 48, 24, 16, True, 0),     # Sq > Sk: rows with no live key
    (2, 4, 1, 70, 70, 64, True, 20),    # window over a ragged edge
    (1, 2, 2, 33, 65, 128, False, 0),   # qwen3's head_dim
    (1, 10, 1, 40, 40, 256, True, 24),  # recurrentgemma's heads, window
]
NON_CAUSAL = [  # B, Hq, Hkv, Sq, Sk, hd, bq, bk (the JAX kernel's blocks)
    (1, 4, 2, 100, 30, 64, 20, 10),     # Sq > Sk: negative q_offset
    (1, 8, 1, 40, 1600, 128, 40, 100),  # llama-vision's cross layout
    (1, 4, 4, 77, 45, 64, 7, 9),        # seamless's MHA, ragged lengths
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(
        atol=2e-5, rtol=2e-5)


def _inputs(B, Hq, Hkv, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, Sq, hd)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, hd)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, hd)).astype(np.float32))


def _port(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SWEEP)
def test_matches_jax_kernel_and_ref(case, dtype):
    B, Hq, Hkv, Sq, Sk, hd, causal, window, bq, bk = case
    jdt, tdt = DTYPES[dtype]
    arrs = _inputs(B, Hq, Hkv, Sq, Sk, hd, seed=Sq * Sk + Hq)
    jq, jk, jv = [jnp.asarray(a, jdt) for a in arrs]
    q, k, v = _port(arrs, tdt)
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (B, Hq, Sq, hd)
    torch.testing.assert_close(
        got, flash_attention_ref(q, k, v, causal, window), atol=0, rtol=0)
    kern = j_flash(jq, jk, jv, causal=causal, window=window, block_q=bq,
                   block_k=bk, interpret=True)
    want = j_ref(jq, jk, jv, causal=causal, window=window)
    for ref in (kern, want):
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                                   **_tol(dtype))


@pytest.mark.parametrize("case", RAGGED)
def test_ragged_lengths_match_jax_ref(case):
    B, Hq, Hkv, Sq, Sk, hd, causal, window = case
    arrs = _inputs(B, Hq, Hkv, Sq, Sk, hd, seed=Sq + Sk)
    got = flash_attention(*_port(arrs, torch.float32), causal=causal,
                          window=window)
    want = j_ref(*[jnp.asarray(a) for a in arrs], causal=causal, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), **_tol("float32"))


def test_row_with_no_live_key_is_mean_of_v():
    """The finite -1e30 mask: a causal row before every key averages V."""
    q, k, v = _port(_inputs(1, 2, 1, 48, 24, 16, seed=3), torch.float32)
    got = flash_attention(q, k, v, causal=True)
    mean_v = v.mean(dim=2, keepdim=True).expand(1, 2, 24, 16)
    torch.testing.assert_close(got[:, :, :24], mean_v, atol=2e-6, rtol=2e-6)


def test_matches_model_chunked_attention():
    """The port's attention vs the JAX model's XLA path (the function the
    port's attention_block replaces with this op)."""
    B, Hq, Hkv, S, hd = 1, 4, 2, 64, 32
    arrs = _inputs(B, Hq, Hkv, S, S, hd, seed=106)
    got = flash_attention(*_port(arrs, torch.float32), causal=True)
    pos = jnp.arange(S, dtype=jnp.int32)
    want = chunked_attention(*[jnp.asarray(a) for a in arrs], pos, pos,
                             causal=True, chunk_q=16, chunk_k=16)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def _rounded_p_attention(q, k, v, causal, window, tile=64):
    """The bf16 kernel's arithmetic: scores and the online softmax in f32
    over 64-key tiles, the tile's P rounded to bf16 before P V, the
    denominator summed from the unrounded P."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Sq, hd)
    kf, vf = k.float(), v.float()
    mask = attention_mask(Sq, Sk, causal, window)
    m = torch.full((B, Hkv, Hq // Hkv, Sq, 1), NEG_INF)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qf)
    for k0 in range(0, Sk, tile):
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf,
                         kf[:, :, k0:k0 + tile]) * hd**-0.5
        s = torch.where(mask[:, k0:k0 + tile], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + torch.einsum("bhgqk,bhkd->bhgqd",
                                    p.bfloat16().float(),
                                    vf[:, :, k0:k0 + tile])
        m = m_new
    return (o / l).reshape(B, Hq, Sq, hd).to(q.dtype)


@pytest.mark.parametrize("case", [  # B, Hq, Hkv, S, hd, window
    (1, 4, 1, 600, 256, 256),   # recurrentgemma's heads, window
    (1, 8, 2, 300, 128, 0),     # qwen3's head_dim, causal
])
def test_bf16_p_rounding_is_within_bf16_tolerance(case):
    B, Hq, Hkv, S, hd, window = case
    q, k, v = _port(_inputs(B, Hq, Hkv, S, S, hd, seed=S + hd),
                    torch.bfloat16)
    got = _rounded_p_attention(q, k, v, True, window)
    want = flash_attention_ref(q, k, v, True, window)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **_tol("bfloat16"))


@pytest.mark.parametrize("hd,width", [
    (1, 16), (16, 16), (17, 32), (48, 64), (80, 128), (160, 256), (256, 256),
    (257, 512), (320, 512), (512, 512), (513, 1024), (640, 1024),
    (1024, 1024)])
def test_padded_head_dim_is_the_next_instantiation(hd, width):
    assert padded_head_dim(hd) == width and width in HEAD_DIMS


@pytest.mark.parametrize("hd", [0, 1025, 2048])
def test_head_dim_outside_the_instantiations_raises(hd):
    with pytest.raises(ValueError, match="largest instantiation is 1024"):
        padded_head_dim(hd)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", NON_CAUSAL)
def test_non_causal_modes_match_jax_kernel(case, dtype):
    B, Hq, Hkv, Sq, Sk, hd, bq, bk = case
    jdt, tdt = DTYPES[dtype]
    arrs = _inputs(B, Hq, Hkv, Sq, Sk, hd, seed=Sq + Sk + hd)
    q, k, v = _port(arrs, tdt)
    got = [flash_attention(q, k, v, causal=False)]
    if dtype == "bfloat16":   # the card's bf16 kernel rounds P (B3)
        got.append(_rounded_p_attention(q, k, v, False, 0))
    jq, jk, jv = [jnp.asarray(a, jdt) for a in arrs]
    kern = j_flash(jq, jk, jv, causal=False, block_q=bq, block_k=bk,
                   interpret=True)
    for out in got:
        assert out.dtype == tdt and out.shape == (B, Hq, Sq, hd)
        for ref in (kern, j_ref(jq, jk, jv, causal=False)):
            np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32),
                                       **_tol(dtype))


def _padded_attention(q, k, v, causal, window):
    """What the card's wrapper runs at a head dim between instantiations:
    q, k, v zero-padded to `padded_head_dim`, scores scaled by the true
    head dim, the output's padded columns dropped."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    width = padded_head_dim(hd)
    qp, kp, vp = (F.pad(t.float(), (0, width - hd)) for t in (q, k, v))
    qg = qp.reshape(B, Hkv, Hq // Hkv, Sq, width)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kp) * hd**-0.5
    s = torch.where(attention_mask(Sq, Sk, causal, window), s, NEG_INF)
    o = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(s, dim=-1), vp)
    assert hd == width or float(o[..., hd:].abs().max()) == 0.0
    return o[..., :hd].reshape(B, Hq, Sq, hd).to(q.dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd,window", [(48, 0), (80, 16), (160, 0), (320, 0),
                                       (512, 16), (768, 0), (1024, 16)])
def test_zero_padded_head_dim_matches_jax(hd, window, dtype):
    jdt, tdt = DTYPES[dtype]
    arrs = _inputs(1, 4, 2, 40, 40, hd, seed=hd)
    q, k, v = _port(arrs, tdt)
    got = _padded_attention(q, k, v, True, window)
    torch.testing.assert_close(got.float(),
                               flash_attention_ref(q, k, v, True, window).float(),
                               **_tol(dtype))
    jq, jk, jv = [jnp.asarray(a, jdt) for a in arrs]
    kern = j_flash(jq, jk, jv, causal=True, window=window, block_q=8,
                   block_k=8, interpret=True)
    for ref in (kern, j_ref(jq, jk, jv, causal=True, window=window)):
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                                   **_tol(dtype))


def _rounded_backward(q, k, v, o, do, causal, window, parts=1):
    """The bf16 backward kernels' arithmetic (B4): S, dP, D = rowsum(dO O),
    lse and every sum in f32; P rounded to bf16 before dV += P^T dO; dS =
    P (dP - D) from the rounded P, itself rounded to bf16 before dK +=
    dS^T Q and dQ += dS K; a causal row with no live key has p = 1 / Sk
    and ds = 0; dq, dk, dv rounded once to bf16.  With `parts` > 1 dK
    and dV are summed as the hd-256 dK/dV pass sums them
    (`_parts_summed`)."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Hkv, G, Sq, hd)
    dof = do.float().reshape(B, Hkv, G, Sq, hd)
    kf, vf = k.float(), v.float()
    scale = hd**-0.5
    mask = attention_mask(Sq, Sk, causal, window)
    s = torch.where(mask, torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale,
                    NEG_INF)
    lse = torch.logsumexp(s, -1, keepdim=True)
    none_live = ~mask.any(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    p = torch.where(none_live, 1.0 / Sk, p).bfloat16().float()
    d = (dof * o.float().reshape(B, Hkv, G, Sq, hd)).sum(-1, keepdim=True)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = torch.where(mask, p * (dp - d), 0.0).bfloat16().float()
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    if parts > 1:
        dk = _parts_summed(ds, qf, parts) * scale
        dv = _parts_summed(p, dof, parts)
    else:
        dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
        dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    return dq.reshape(B, Hq, Sq, hd).bfloat16(), dk.bfloat16(), dv.bfloat16()


def _parts_summed(w, x, parts):
    """sum over the group's heads g and queries of w[.., g, q, k] x[.., g,
    q, :] as the hd-256 dK/dV pass orders it: the group cut into `parts`
    runs of heads, the first G % parts one head longer, each run's f32
    sum apart, then the runs' sums added in order."""
    G = w.shape[2]
    per, extra = divmod(G, parts)
    out, g0 = None, 0
    for i in range(parts):
        g1 = g0 + per + (i < extra)
        part = torch.einsum("bhgqk,bhgqd->bhkd", w[:, :, g0:g1], x[:, :, g0:g1])
        out = part if out is None else out + part
        g0 = g1
    return out


@pytest.mark.parametrize("case", [  # B, Hq, Hkv, Sq, Sk, hd, causal, window
    (1, 15, 5, 256, 256, 64, True, 0),   # smollm-360m's layout
    (1, 8, 1, 200, 200, 128, True, 0),   # group 8 at hd 128 (yi)
    (1, 4, 2, 160, 160, 64, True, 48),   # a window
    (1, 4, 2, 96, 40, 32, True, 0),      # rows at negative positions
    (1, 10, 1, 96, 96, 256, True, 40),   # recurrentgemma's heads, window
    (1, 8, 2, 96, 96, 160, True, 0),     # stablelm's hd 160 (padded: 256)
])
def test_bf16_backward_rounding_is_within_bf16_tolerance(case):
    """dq, dk, dv of the kernels' bf16 arithmetic on bf16 inputs against
    jax.vjp of `chunked_attention` (f32 on the same values) within 2e-2 of
    each gradient's largest value plus 2e-2 of its own."""
    _hold_rounded_backward_to_jax(case, 1)


@pytest.mark.parametrize("case,parts", [
    ((1, 10, 1, 96, 96, 256, True, 40), None),   # the rule: 10 parts
    ((1, 10, 1, 96, 96, 256, True, 40), 4),      # 3, 3, 2, 2 heads
    ((2, 6, 2, 80, 120, 256, True, 0), None),    # the rule: 3 parts
    ((1, 6, 1, 70, 70, 160, False, 0), 4),       # 2, 2, 1, 1 heads
])
def test_bf16_backward_parts_sum_is_within_bf16_tolerance(case, parts):
    """The hd-256 dK/dV pass's order of sums over a group cut into parts
    (`bwd_kv_splits`' count at the case's shape, or a count that leaves a
    remainder) against jax.vjp of `chunked_attention` as above."""
    B, Hq, Hkv, Sq, Sk, hd, *_ = case
    if parts is None:
        parts = bwd_kv_splits(torch.bfloat16, padded_head_dim(hd), B * Hkv,
                              Sk, Hq // Hkv)
    assert parts > 1
    _hold_rounded_backward_to_jax(case, parts)


def _hold_rounded_backward_to_jax(case, parts):
    B, Hq, Hkv, Sq, Sk, hd, causal, window = case
    rng = np.random.default_rng(sum(case[:6]))
    arrs = [rng.normal(size=shape).astype(np.float32) for shape in (
        (B, Hq, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd), (B, Hq, Sq, hd))]
    q, k, v, do = _port(arrs, torch.bfloat16)
    qpos = jnp.arange(Sq, dtype=jnp.int32) + (Sk - Sq)
    kpos = jnp.arange(Sk, dtype=jnp.int32)
    _, vjp = jax.vjp(lambda a, b, c: chunked_attention(
        a, b, c, qpos, kpos, causal=causal, window=window, chunk_q=32,
        chunk_k=32), *(jnp.asarray(_np(t)) for t in (q, k, v)))
    want = vjp(jnp.asarray(_np(do)))
    o = _rounded_p_attention(q, k, v, causal, window)
    got = _rounded_backward(q, k, v, o, do, causal, window, parts)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=2e-2,
                                   atol=2e-2 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("args,parts", [
    # dtype, padded hd, BHkv, Sk, group
    ((torch.bfloat16, 256, 1, 4096, 10), 5),    # recurrentgemma, training
    ((torch.bfloat16, 256, 8, 512, 4), 4),      # stablelm, S 512: a head a part
    ((torch.bfloat16, 256, 4, 2150, 3), 2),     # 136 blocks: 2, 1 heads
    ((torch.bfloat16, 256, 40, 4096, 3), 1),    # enough blocks already
    ((torch.float32, 256, 1, 4096, 10), 1),     # f32: the CUDA cores
    ((torch.bfloat16, 128, 1, 4096, 8), 1),     # one warpgroup a block
])
def test_bwd_kv_splits_follows_the_rule(args, parts):
    """The least count of parts giving 264 dK/dV blocks of 64 keys, at
    most the group, for bf16 at hd 256 only."""
    assert bwd_kv_splits(*args) == parts


def test_flash_sources_share_the_wgmma_header():
    """Both flash sources include the one header of wgmma pieces, and it
    keys both libraries."""
    header = SOURCE.with_name("flash_wgmma.cuh")
    assert header.exists()
    for src in (SOURCE, BWD_SOURCE):
        assert '#include "flash_wgmma.cuh"' in src.read_text(), src.name


def test_header_keys_the_library_path(tmp_path, monkeypatch):
    """Two contents of a header beside a source give two library paths,
    and the header is not handed to nvcc as a translation unit."""
    src, hdr = tmp_path / "k.cu", tmp_path / "k.cuh"
    src.write_text('#include "k.cuh"\n')
    hdr.write_text("// one\n")
    first = kernels.library_path("k", [src])
    hdr.write_text("// two\n")
    second = kernels.library_path("k", [src])
    assert first != second
    assert kernels.library_path("k", [src]) == second

    cmds = []

    class Refused:
        returncode = 1

        def communicate(self):
            return "", "refused"

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "cuda_tool", lambda name: name)
    monkeypatch.setattr(kernels.subprocess, "Popen",
                        lambda cmd, **kw: cmds.append(cmd) or Refused())
    with pytest.raises(RuntimeError, match="nvcc failed to build k"):
        kernels.build_libraries([("k", [src])])
    assert str(src) in cmds[0] and str(hdr) not in cmds[0]
