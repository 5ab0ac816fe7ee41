"""The CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs where only the port is installed:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
Without a card every test skips.  Tolerances are chip_smoke.py's:
rotor_slice state atol 1e-5, totals rtol 1e-5; flash_attention and
moe_gmm f32 2e-5, bf16 2e-2 (tests/test_kernels.py:15-18); mamba_scan
and rglru_scan f32 1e-4, bf16 2e-2 (tests/test_kernels.py:66-69); the
faulted fluid steps (plain torch) state atol 1e-5 against their CPU
run, the flow engines at tests/test_flows_jax.py's tolerances (the tiled
engine's histograms, backlog and remaining bytes equal to the dense
engine's on the card, and its results equal to its CPU run's).  The
bf16 flash kernel's wgmma tile products, and the moe_gmm backward's, are
exact up to the f32 summation order: within 1e-5 of the sum of the
products' magnitudes.
Head dims between the flash instantiations run zero-padded, above 256 on
the f32 kernel alone (up to 1024); the cross-attention layers' modes
(non-causal, Sq above or below Sk) run on both flash kernels; moe_gmm
runs its scalar loads for rows or weights off 16 bytes.  The flash
backward kernel (training) is held to autograd through the plain
version at the same tolerances relative to each gradient's largest
value, bit for bit against itself (at hd 256 with the group cut into
parts too), and its bf16 path (hd 16-256) is seen to launch the wgmma
kernels; the forward's lse to torch.logsumexp
at 2e-5.  The backward kernels of moe_gmm, rglru_scan and mamba_scan
(training, F3 repaired) are held to autograd through their plain
versions alike, bit for bit against themselves (rglru_scan's also
against its kernel's order of operations in plain torch, and over 20
reruns; moe_gmm's bf16 path
seen to launch its wgmma kernels alone, mamba_scan's backward its four
passes; the mamba forward's chunk states, which its backward reads, to
the plain version's, and kept only under autograd); a reduced train step of
smollm, qwen3-moe, falcon-mamba and recurrentgemma on the card matches
the CPU's within 1e-5, with each kernel's launches counted.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.topology import (
    build_lifted_opera_topology,
    build_opera_topology,
)
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_attention.kernel import (
    BWD_WGMMA_HEAD_DIMS,
    WGMMA_HEAD_DIMS,
    bwd_kv_splits,
    flash_attention_bwd,
    flash_attention_fwd,
    wgmma_probe,
)
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ref
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
from repro_torch.kernels.mamba_scan.kernel import mamba_scan_fwd
from repro_torch.kernels.moe_gmm.kernel import moe_gmm_fwd
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
from repro_torch.kernels.rotor_slice.kernel import rotor_slice_fwd
from repro_torch.kernels.rotor_slice.ref import rotor_slice_ref
from repro_torch.netsim import fluid_torch
from repro_torch.netsim.faults import (
    FailureEvent,
    FailureSchedule,
    apply_flow_faults,
    compile_fault_masks,
)
from repro_torch.netsim.flows import build_scenario
from repro_torch.netsim.flows_torch import simulate_flows_batch
from repro_torch.models.model import init_params
from repro_torch.netsim.sweep import DesignPoint, scenario_demand
from repro_torch.serve.engine import Request, ServeEngine

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


def _held_to_plain_version(own, relay, dst, vlb):
    """State atol 1e-5, totals rtol 1e-5 against `rotor_slice_ref`, and
    the same bits from a second launch."""
    got = rotor_slice_fwd(own, relay, dst, vlb)
    ref = rotor_slice_ref(own, relay, dst, vlb)
    torch.cuda.synchronize()
    for x, y in zip(got[:2], ref[:2]):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)
    for x, y in zip(got[2:], ref[2:]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    again = rotor_slice_fwd(own, relay, dst, vlb)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("vlb", [False, True])
@pytest.mark.parametrize("n,u,g", [(16, 4, 1), (16, 4, 2), (108, 6, 1),
                                   (240, 12, 2)])  # k24-n240-g2: ragged strip
def test_kernel_matches_plain_version(card, n, u, g, vlb):
    # above 128 racks the sweep lifts its topologies (sweep.LIFTED_TOPO_RACKS)
    build = build_lifted_opera_topology if n > 128 else build_opera_topology
    dst = torch.as_tensor(
        build(n, u, seed=0, groups=g).matching_index_tensor(), device=card)
    own, relay = _state(n, 4, 0, card)
    for t in range(0, dst.shape[0], max(1, dst.shape[0] // 5)):
        _held_to_plain_version(own, relay, dst[t], vlb)


def _xor_matching(n, u, device):
    """dst[i, s] = i ^ (s + 1): u disjoint involutions without fixed
    points; slot 5 dark for every row, as a reconfiguring switch."""
    i = torch.arange(n, dtype=torch.int32)[:, None]
    dst = i ^ torch.arange(1, u + 1, dtype=torch.int32)[None]
    dst[:, 5] = n
    return dst.to(device)


@pytest.mark.parametrize("state", ["random", "half_drained", "worst_case"])
@pytest.mark.parametrize("n,bsz", [(1024, 2), (4096, 1)])
def test_kernel_on_synthetic_matchings(card, n, bsz, state):
    """Full strips (N 1024) and narrow ones (N 4096: T 8).  Half the rows
    drained stop spreading; relay zero with own below 1 leaves every
    partner room, so every live slot adds to the gather."""
    dst = _xor_matching(n, 32, card)
    own, relay = _state(n, bsz, 5, card)
    if state == "half_drained":
        own[:, ::2] = 0.0
    elif state == "worst_case":
        own = own * 0.5
        relay = torch.zeros_like(relay)
    for vlb in (False, True):
        _held_to_plain_version(own, relay, dst, vlb)


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


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(
        atol=2e-5, rtol=2e-5)


def _normal(shape, seed, device, dtype, scale=1.0):
    a = np.random.default_rng(seed).normal(size=shape) * scale
    return torch.as_tensor(a, dtype=torch.float32, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [  # B, Hq, Hkv, Sq, Sk, hd, causal, window
    (1, 2, 2, 64, 64, 32, True, 0), (2, 4, 2, 64, 64, 64, True, 0),
    (1, 8, 1, 32, 32, 32, True, 0), (1, 2, 2, 64, 64, 32, False, 0),
    (1, 2, 1, 64, 64, 32, True, 24), (1, 2, 2, 32, 96, 32, True, 0),
    (1, 3, 1, 48, 48, 16, True, 0), (1, 4, 2, 40, 72, 128, True, 0),
    (1, 2, 1, 48, 24, 16, True, 0), (2, 4, 1, 70, 70, 64, True, 20),
    (1, 2, 2, 33, 65, 128, False, 0), (1, 2, 1, 100, 150, 64, False, 30),
    (1, 10, 1, 100, 100, 256, True, 24), (1, 10, 1, 70, 130, 256, True, 0),
    # ragged 64-row tiles at the main path's head dims; a window across
    # tile edges; Sq > Sk, rows with no live key
    (1, 4, 2, 200, 200, 128, True, 0), (1, 4, 1, 130, 300, 256, True, 70),
    (1, 4, 1, 96, 40, 128, True, 0),
    # cross-attention and the encoder: non-causal with Sq > Sk (negative
    # q_offset), llama-vision's layout over 1,600 image tokens, seamless's
    # MHA at hd 64, square and ragged
    (1, 4, 2, 100, 30, 64, False, 0), (1, 64, 8, 455, 1600, 128, False, 0),
    (1, 16, 16, 455, 455, 64, False, 0), (1, 4, 4, 77, 45, 64, False, 0),
])
def test_flash_attention_matches_plain_version(card, case, dtype):
    B, Hq, Hkv, Sq, Sk, hd, causal, window = case
    q = _normal((B, Hq, Sq, hd), 0, card, dtype)
    k = _normal((B, Hkv, Sk, hd), 1, card, dtype)
    v = _normal((B, Hkv, Sk, hd), 2, card, dtype)
    launch_counts.clear()
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert launch_counts["flash_attention"] == 1
    want = flash_attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F", [
    (2, 16, 16, 32), (4, 8, 32, 64), (3, 12, 8, 24),
    (8, 4, 64, 32), (4, 13, 300, 260), (2, 9, 2304, 96),
    # qwen3-moe's widths at decode (C 1, 4: 4 rows a block), C 8 (one
    # 8-row tile), C 9 (3 tiles of 4, across a tile edge), C 14 (8 rows
    # a block, the second tile ragged) and a prefill's C 40
    (16, 1, 2048, 768), (16, 4, 2048, 768), (16, 8, 2048, 768),
    (16, 9, 2048, 768), (16, 14, 2048, 768), (16, 40, 2048, 768),
    # weight rows that are no whole number of 16-byte loads: scalar
    # loads (bf16 at C 3, both types at C 14)
    (3, 3, 300, 260), (2, 14, 301, 259),
])
def test_moe_gmm_matches_plain_version(card, E, C, D, F, dtype):
    h = _normal((E, C, D), 3, card, dtype)
    wg = _normal((E, D, F), 4, card, dtype, D**-0.5)
    wu = _normal((E, D, F), 5, card, dtype, D**-0.5)
    wd = _normal((E, F, D), 6, card, dtype, F**-0.5)
    launch_counts.clear()
    got = moe_gmm(h, wg, wu, wd)
    assert launch_counts["moe_gmm"] == 1
    want = moe_gmm_ref(h, wg, wu, wd)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("E,C,D,F", [(2, 16, 16, 32), (4, 13, 300, 260),
                                     (16, 4, 2048, 768), (16, 14, 2048, 768),
                                     (2, 14, 301, 259)])
def test_moe_gmm_takes_the_configs_activation(card, E, C, D, F, act, dtype):
    """The gelu (tanh form) and relu instantiations of the first pass,
    vector and scalar loads, 4 and 8 rows a block, against `moe_gmm_ref`
    with the same activation; one launch each."""
    h = _normal((E, C, D), 13, card, dtype)
    wg = _normal((E, D, F), 14, card, dtype, D**-0.5)
    wu = _normal((E, D, F), 15, card, dtype, D**-0.5)
    wd = _normal((E, F, D), 16, card, dtype, F**-0.5)
    launch_counts.clear()
    got = moe_gmm(h, wg, wu, wd, act)
    assert launch_counts["moe_gmm"] == 1
    want = moe_gmm_ref(h, wg, wu, wd, act)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert not torch.equal(got, moe_gmm(h, wg, wu, wd))   # not silu


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_takes_empty_capacity_rows(card, dtype):
    """A dispatch buffer as the model leaves it: most experts' capacity
    rows all zero, a few rows filled; empty rows give zero output."""
    E, C, D, F = 32, 4, 2048, 768
    h = torch.zeros((E, C, D), dtype=dtype, device=card)
    h[3, :2] = _normal((2, D), 40, card, dtype)
    h[17, :1] = _normal((1, D), 41, card, dtype)
    h[31] = _normal((C, D), 42, card, dtype)
    wg = _normal((E, D, F), 43, card, dtype, D**-0.5)
    wu = _normal((E, D, F), 44, card, dtype, D**-0.5)
    wd = _normal((E, F, D), 45, card, dtype, F**-0.5)
    got = moe_gmm(h, wg, wu, wd)
    want = moe_gmm_ref(h, wg, wu, wd)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    empty = h.float().abs().sum(-1) == 0
    assert int(empty.sum()) == E * C - 7
    assert float(got.float()[empty].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_takes_weights_off_16_bytes(card, dtype):
    """Weights that start 2 or 4 bytes past a 16-byte line take the
    scalar loads (and the output still matches)."""
    E, C, D, F = 4, 4, 256, 128
    h = _normal((E, C, D), 46, card, dtype)
    ws = []
    for seed, shape, fan in ((47, (E, D, F), D), (48, (E, D, F), D),
                             (49, (E, F, D), F)):
        buf = torch.empty(E * D * F + 8, dtype=dtype, device=card)
        w = buf[1:1 + E * D * F].view(shape)
        w.copy_(_normal(shape, seed, card, dtype, fan**-0.5))
        assert w.data_ptr() % 16
        ws.append(w)
    got = moe_gmm(h, *ws)
    want = moe_gmm_ref(h, *ws)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,window", [(48, 0), (80, 24), (160, 0), (320, 0),
                                       (512, 24), (768, 0), (1024, 24)])
def test_flash_attention_takes_any_head_dim(card, hd, window, dtype):
    """Head dims between the instantiations run zero-padded to the next
    one (stablelm-12b's is 160); above 256 on the f32 kernel's hd-512 and
    hd-1024 instantiations, bf16 widened to f32 around the call."""
    q = _normal((1, 8, 100, hd), 36, card, dtype)
    k = _normal((1, 2, 100, hd), 37, card, dtype)
    v = _normal((1, 2, 100, hd), 38, card, dtype)
    launch_counts.clear()
    got = flash_attention(q, k, v, causal=True, window=window)
    assert launch_counts["flash_attention"] == 1
    want = flash_attention_ref(q, k, v, True, window)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("hd", WGMMA_HEAD_DIMS)
def test_wgmma_probe_matches_matmul(card, hd):
    """The bf16 kernel's tile products alone: S = Q K^T (both operands
    K-major from shared memory) and O = P V (P from registers, V
    MN-major), through its swizzled layouts and descriptors."""
    q, k, v = (_normal((64, hd), seed, card, torch.bfloat16)
               for seed in (30, 31, 32))
    p = _normal((64, 64), 33, card, torch.bfloat16).abs()
    s, o = wgmma_probe(q, k, v, p)
    torch.cuda.synchronize()
    for got, a, b in ((s, q, k.T), (o, p, v)):
        want = a.double() @ b.double()
        size = a.double().abs() @ b.double().abs()
        assert float(((got.double() - want).abs() - 1e-5 * size).max()) <= 0


def test_flash_attention_counts_one_launch_per_call(card):
    """bf16 (wgmma) and f32 (CUDA cores): one launch each."""
    q = _normal((1, 4, 70, 64), 34, card, torch.float32)
    k = _normal((1, 2, 70, 64), 35, card, torch.float32)
    launch_counts.clear()
    flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16())
    assert launch_counts["flash_attention"] == 1
    flash_attention(q, k, k)
    assert launch_counts["flash_attention"] == 2


def test_model_kernels_are_deterministic(card):
    q = _normal((1, 4, 70, 64), 7, card, torch.bfloat16)
    k = _normal((1, 2, 70, 64), 8, card, torch.bfloat16)
    assert torch.equal(flash_attention(q, k, k), flash_attention(q, k, k))
    h = _normal((4, 8, 64), 9, card, torch.bfloat16)
    w = _normal((4, 64, 64), 10, card, torch.bfloat16, 0.125)
    assert torch.equal(moe_gmm(h, w, w, w), moe_gmm(h, w, w, w))


def test_model_kernel_wrappers_check_their_inputs(card):
    q = _normal((4, 32, 64), 11, card, torch.float32)
    k = _normal((2, 32, 64), 12, card, torch.float32)
    with pytest.raises(TypeError):
        flash_attention_fwd(q.double(), k.double(), k.double(), 2, True, 0)
    with pytest.raises(TypeError):
        flash_attention_fwd(q, k.bfloat16(), k.bfloat16(), 2, True, 0)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k.cpu(), k.cpu(), 2, True, 0)
    with pytest.raises(ValueError):
        flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, k, 2, True, 0)
    wide = _normal((4, 32, 1088), 16, card, torch.float32)
    with pytest.raises(ValueError):   # hd 1088: above every instantiation
        flash_attention_fwd(wide, wide[:2].contiguous(), wide[:2].contiguous(),
                            2, True, 0)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, k, 3, True, 0)   # 4 rows != 2 x 3
    kb = k.bfloat16()
    buf = torch.zeros(q.numel() + 8, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):   # bf16 must start on 16 bytes
        flash_attention_fwd(buf[1:1 + q.numel()].view(q.shape), kb, kb, 2,
                            True, 0)
    h = _normal((2, 8, 32), 13, card, torch.float32)
    w = _normal((2, 32, 16), 14, card, torch.float32)
    wd = _normal((2, 16, 32), 15, card, torch.float32)
    with pytest.raises(TypeError):
        moe_gmm_fwd(h.half(), w.half(), w.half(), wd.half())
    with pytest.raises(TypeError):
        moe_gmm_fwd(h, w.bfloat16(), w, wd)
    with pytest.raises(ValueError):
        moe_gmm_fwd(h, w.cpu(), w, wd)
    with pytest.raises(ValueError):
        moe_gmm_fwd(h, w, w, wd.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        moe_gmm_fwd(h, w, w, w)   # wd must be (E, F, D)


def test_reduced_serve_counts_its_launches(card):
    cfg = reduced_config(get_config("qwen3-moe-30b-a3b"))
    params = init_params(cfg, 0, device=card)
    eng = ServeEngine(cfg, params, slots=2, max_seq=48, device=card)
    rng = np.random.default_rng(0)
    for rid in range(3):
        eng.submit(Request(rid=rid, max_new_tokens=5, prompt=rng.integers(
            0, cfg.vocab_size, int(rng.integers(5, 20))).astype(np.int32)))
    launch_counts.clear()
    done = eng.run_to_completion()
    assert len(done) == 3
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens)
    n = cfg.num_layers
    assert launch_counts["flash_attention"] == n * eng.prefills == n * 3
    assert launch_counts["moe_gmm"] == n * (eng.prefills + eng.ticks)


@pytest.mark.parametrize("arch,flash_layers,moe_layers", [
    ("deepseek-moe-16b", 3, 2), ("smollm-360m", 2, 0), ("yi-9b", 2, 0),
    ("stablelm-12b", 2, 0), ("qwen1.5-110b", 2, 0)])
def test_reduced_transformer_archs_count_their_launches(card, arch,
                                                        flash_layers,
                                                        moe_layers):
    """flash_attention once a layer a prefill (deepseek's dense first
    layer too), moe_gmm once a MoE layer a prefill and a tick."""
    cfg = reduced_config(get_config(arch))
    params = init_params(cfg, 0, device=card)
    eng = ServeEngine(cfg, params, slots=2, max_seq=48, device=card)
    rng = np.random.default_rng(0)
    for rid in range(3):
        eng.submit(Request(rid=rid, max_new_tokens=5, prompt=rng.integers(
            0, cfg.vocab_size, int(rng.integers(5, 20))).astype(np.int32)))
    launch_counts.clear()
    done = eng.run_to_completion()
    assert len(done) == 3 and eng.ticks > 0
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens)
    want = {"flash_attention": flash_layers * 3}
    if moe_layers:
        want["moe_gmm"] = moe_layers * (eng.prefills + eng.ticks)
    assert dict(launch_counts) == want


@pytest.mark.parametrize("arch,flash_per_prefill", [
    ("seamless-m4t-large-v2", 2 + 2 * 2), ("llama-3.2-vision-90b", 4)])
def test_reduced_cross_archs_count_their_launches(card, arch,
                                                  flash_per_prefill):
    """flash_attention once an encoder, self_attn or cross_attn layer a
    prefill and twice a decoder layer (self and cross); decode's
    attention is plain torch, so a tick launches none."""
    cfg = reduced_config(get_config(arch))
    params = init_params(cfg, 0, device=card)
    eng = ServeEngine(cfg, params, slots=2, max_seq=48, device=card)
    rng = np.random.default_rng(0)
    for rid in range(3):
        eng.submit(Request(rid=rid, max_new_tokens=5, prompt=rng.integers(
            0, cfg.vocab_size, int(rng.integers(5, 20))).astype(np.int32)))
    launch_counts.clear()
    done = eng.run_to_completion()
    assert len(done) == 3 and eng.ticks > 0
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens)
    assert dict(launch_counts) == {"flash_attention": flash_per_prefill * 3}


def _scan_tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(
        atol=1e-4, rtol=1e-4)


def _mamba_inputs(B, S, D, N, seed, device, dtype, x_dtype=None):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(B, S, D)), rng.uniform(0.01, 0.2, (B, S, D)),
            rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N)),
            -np.exp(rng.normal(size=(D, N))), rng.normal(size=(D,)))
    t = [torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrs]
    return [t[0].to(x_dtype or dtype)] + [a.to(dtype) for a in t[1:4]] + t[4:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D,N", [
    (1, 16, 8, 4), (2, 32, 16, 4), (1, 24, 12, 2), (2, 16, 8, 8),
    (1, 40, 300, 16), (2, 33, 70, 3), (1, 20, 16, 32),
    # falcon-mamba-7b's prefill; N 3 and 32 over several 16-step chunks
    (1, 512, 8192, 16), (1, 70, 96, 3), (2, 50, 100, 32)])
def test_mamba_scan_matches_plain_version(card, B, S, D, N, dtype):
    args = _mamba_inputs(B, S, D, N, 16, card, dtype)
    launch_counts.clear()
    y, h = mamba_scan(*args)
    assert launch_counts["mamba_scan"] == 1
    ry, rh = mamba_scan_ref(*args)
    torch.cuda.synchronize()
    assert y.dtype == h.dtype == torch.float32
    torch.testing.assert_close(y, ry, **_scan_tol(dtype))
    torch.testing.assert_close(h, rh, **_scan_tol(dtype))
    y2, h2 = mamba_scan(*args)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_mamba_scan_takes_the_model_dtypes(card):
    """x in bf16 beside f32 dt, B, C, as `mamba_mix` passes them."""
    args = _mamba_inputs(2, 37, 96, 16, 17, card, torch.float32,
                         x_dtype=torch.bfloat16)
    y, h = mamba_scan(*args)
    ry, rh = mamba_scan_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ry, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, rh, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D", [
    (1, 32, 16), (2, 64, 8), (1, 48, 24), (3, 100, 130), (1, 17, 2560),
    # recurrentgemma-2b's longest prefill; a ragged S over 16 chunks of 64;
    # 313 chunks, the last ragged, whose carries run in one pass
    (1, 3300, 2560), (1, 1000, 300), (2, 20000, 130)])
def test_rglru_scan_matches_plain_version(card, B, S, D, dtype):
    rng = np.random.default_rng(18)
    a = torch.as_tensor(rng.uniform(0.7, 0.999, (B, S, D)), device=card,
                        dtype=torch.float32).to(dtype)
    bx = _normal((B, S, D), 19, card, dtype)
    h0 = _normal((B, D), 20, card, torch.float32)
    launch_counts.clear()
    got = rglru_scan(a, bx, h0)
    assert launch_counts["rglru_scan"] == 1
    want = rglru_scan_ref(a, bx, h0)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, **_scan_tol(dtype))
    assert torch.equal(got, rglru_scan(a, bx, h0))


def test_scan_kernels_are_deterministic(card):
    args = _mamba_inputs(1, 64, 512, 16, 21, card, torch.float32,
                         x_dtype=torch.bfloat16)
    a, b = mamba_scan(*args), mamba_scan(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    x = _normal((2, 50, 300), 22, card, torch.float32).sigmoid()
    h0 = _normal((2, 300), 23, card, torch.float32)
    assert torch.equal(rglru_scan(x, x, h0), rglru_scan(x, x, h0))


def test_scan_kernel_wrappers_check_their_inputs(card):
    x, dt, bm, cm, a, d = _mamba_inputs(1, 8, 16, 4, 24, card, torch.float32)
    with pytest.raises(TypeError):
        mamba_scan_fwd(x.double(), dt, bm, cm, a, d)
    with pytest.raises(TypeError):
        mamba_scan_fwd(x, dt, bm.bfloat16(), cm, a, d)   # B not dt's type
    with pytest.raises(TypeError):
        mamba_scan_fwd(x, dt, bm, cm, a.bfloat16(), d)
    with pytest.raises(ValueError):
        mamba_scan_fwd(x, dt.cpu(), bm, cm, a, d)
    with pytest.raises(ValueError):
        mamba_scan_fwd(x, dt, bm, cm, a[:8], d)
    with pytest.raises(ValueError):   # N = 33 > the kernel's 32
        mamba_scan_fwd(*_mamba_inputs(1, 8, 16, 33, 25, card, torch.float32))
    with pytest.raises(ValueError):
        mamba_scan_fwd(x.transpose(1, 2).contiguous().transpose(1, 2), dt,
                       bm, cm, a, d)
    h0 = _normal((1, 16), 26, card, torch.float32)
    with pytest.raises(TypeError):
        rglru_scan_fwd(x, dt.bfloat16(), h0)
    with pytest.raises(TypeError):
        rglru_scan_fwd(x, dt, h0.bfloat16())
    with pytest.raises(ValueError):
        rglru_scan_fwd(x, dt, h0.cpu())
    with pytest.raises(ValueError):
        rglru_scan_fwd(x, dt, h0[:, :8])


@pytest.mark.parametrize("arch,kernels", [
    ("falcon-mamba-7b", {"mamba_scan": 2}),
    ("recurrentgemma-2b", {"rglru_scan": 4, "flash_attention": 1}),
])
def test_reduced_recurrent_serve_counts_its_launches(card, arch, kernels):
    """Per prefill: one launch a layer of the kind; decode launches none."""
    cfg = reduced_config(get_config(arch))
    params = init_params(cfg, 0, device=card)
    eng = ServeEngine(cfg, params, slots=2, max_seq=48, device=card)
    rng = np.random.default_rng(0)
    for rid in range(3):
        eng.submit(Request(rid=rid, max_new_tokens=5, prompt=rng.integers(
            0, cfg.vocab_size, int(rng.integers(5, 20))).astype(np.int32)))
    launch_counts.clear()
    done = eng.run_to_completion()
    assert len(done) == 3 and eng.ticks > 0
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens)
    assert dict(launch_counts) == {k: n * 3 for k, n in kernels.items()}


# ---------------------------------------------------------------------------
# fault injection and the flow engine (plain torch on the card)
# ---------------------------------------------------------------------------


def _fault_schedules(topo):
    """A link, a ToR and a switch event with onsets, lags and recoveries
    inside two cycles, and a drawn mixed schedule."""
    S = topo.num_slices
    events = (FailureEvent("link", ((1, 0), (5, 1)), onset_step=2,
                           detect_lag=3, recover_step=S + 4),
              FailureEvent("tor", (3,), onset_step=5, detect_lag=2,
                           recover_step=S + 8),
              FailureEvent("switch", (2,), onset_step=S // 2, detect_lag=3))
    return [FailureSchedule(topo.num_racks, topo.num_switches, events),
            FailureSchedule.draw(topo, seed=8, link_frac=0.1, tor_frac=0.12,
                                 switch_count=1, onset_step=3, detect_lag=3)]


@pytest.mark.parametrize("vlb", [False, True])
@pytest.mark.parametrize("engine", ["dense", "sparse"])
def test_faulted_steps_match_cpu(card, engine, vlb):
    """Two cycles of the faulted step on the card and on the CPU, each
    from its own last state: state atol 1e-5, totals rtol 1e-5."""
    topo = build_opera_topology(16, 4, seed=0)
    masks = compile_fault_masks(topo, _fault_schedules(topo))
    own, relay = _state(16, 2, 3, "cpu")
    runs = {}
    for dev in ("cpu", card):
        tl = tuple(torch.as_tensor(a, device=dev) for a in (
            masks.up_onset, masks.up_detect, masks.up_recover,
            masks.tor_onset, masks.tor_detect, masks.tor_recover))
        pair_sw = torch.as_tensor(masks.pair_switch, device=dev).long()
        sw = torch.as_tensor(masks.switch_id, device=dev).long()
        adj = torch.as_tensor(topo.matching_tensor(), device=dev)
        dst = torch.as_tensor(topo.matching_index_tensor(), device=dev)
        o, r = own.to(dev), relay.to(dev)
        steps = []
        for g in range(2 * topo.num_slices):
            t = g % topo.num_slices
            if engine == "dense":
                out = fluid_torch._slice_step_faulted(
                    o, r, adj[t], sw[t], pair_sw, g, tl, vlb)
            else:
                out = fluid_torch._sparse_slice_step_faulted(
                    o, r, dst[t], pair_sw, g, tl, vlb)
            o, r = out[0], out[1]
            steps.append([x.cpu() if x is not None else None for x in out])
        runs[str(dev)] = steps
    for want, got in zip(runs["cpu"], runs[str(card)]):
        for x, y in zip(got[:2], want[:2]):
            torch.testing.assert_close(x, y, atol=1e-5, rtol=0)
        for x, y in zip(got[2:], want[2:]):
            if y is not None:
                torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("engine", ["dense", "sparse"])
def test_faulted_engine_matches_cpu(card, engine):
    dp = DesignPoint(k=8, num_racks=16)
    cfg = dp.to_config()
    topo = build_opera_topology(16, 4, seed=0)
    dem = np.stack([scenario_demand("permutation", cfg, 0.5, s)
                    for s in range(2)])
    kw = dict(max_cycles=6, topo=topo, engine=engine, paced_cycles=3,
              faults=_fault_schedules(topo))
    launch_counts.clear()
    got = fluid_torch.simulate_rotor_bulk_batch(cfg, dem, **kw)
    assert launch_counts["rotor_slice"] == 0   # the faulted step is plain
    ref = fluid_torch.simulate_rotor_bulk_batch(cfg, dem, device="cpu", **kw)
    np.testing.assert_allclose(got.finished_frac, ref.finished_frac, atol=5e-5)
    np.testing.assert_allclose(got.blackholed_bytes, ref.blackholed_bytes,
                               rtol=1e-4, atol=1.0)
    assert got.blackholed_bytes.max() > 0


def test_empty_schedule_is_bitwise_on_the_kernel_path(card):
    """An event-less schedule without pacing runs the unfaulted sparse
    program: the rotor_slice kernel once a slice, the same bits as
    faults=None."""
    dp = DesignPoint(k=8, num_racks=16)
    cfg = dp.to_config()
    topo = build_opera_topology(16, 4, seed=0)
    dem = scenario_demand("skew", cfg, 2.5, 0)
    runs = []
    for faults in (None, FailureSchedule.empty(topo),
                   [FailureSchedule.empty(topo)]):
        launch_counts.clear()
        runs.append(fluid_torch.simulate_rotor_bulk_batch(
            cfg, dem, max_cycles=4, topo=topo, engine="sparse",
            faults=faults))
        assert launch_counts["rotor_slice"] == 4 * topo.num_slices
    for r in runs[1:]:
        for f in ("finished_frac", "wire_bytes", "goodput_bytes",
                  "residual_bytes"):
            np.testing.assert_array_equal(getattr(r, f), getattr(runs[0], f))


def test_faulted_flows_match_cpu(card):
    """The dense flow engine, faulted and not, on the card against the
    CPU: equal admission and completion totals, results at
    tests/test_flows_jax.py's tolerances."""
    topo = build_opera_topology(8, 2, seed=0)
    kw = dict(num_hosts=16, horizon_s=0.12, dt_s=5e-4, tail_s=0.1, seed=0)
    base = build_scenario("opera", "websearch", 0.12, **kw)
    sched = FailureSchedule.draw(topo, seed=5, tor_frac=0.25, link_frac=0.2,
                                 onset_step=40, detect_lag=5,
                                 recover_step=120)
    scns = [base, apply_flow_faults(base, sched)]
    got = simulate_flows_batch(scns, trace=True)
    ref = simulate_flows_batch(scns, trace=True, device="cpu")
    for g, r, gh, rh in zip(got.results, ref.results, got.hists, ref.hists):
        assert g.admitted == r.admitted
        assert np.isclose(g.finished_frac, r.finished_frac, atol=1e-6)
        assert np.isclose(g.backlog_frac, r.backlog_frac, atol=1e-4)
        assert np.isclose(g.fct_mean_ms, r.fct_mean_ms, rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(gh.sum(1), rh.sum(1))
    for g, r, s in zip(got.traces, ref.traces, scns):
        np.testing.assert_allclose(g, r, atol=s.sizes.max() * 1e-5)


def _tiled_scenarios():
    """Four small scenarios (clean), then two of them faulted."""
    topo = build_opera_topology(8, 2, seed=0)
    kw = dict(num_hosts=16, horizon_s=0.12, dt_s=5e-4, tail_s=0.1)
    clean = [build_scenario(net, wl, load, seed=seed, **kw)
             for net, wl, load, seed in (("opera", "websearch", 0.1, 0),
                                         ("opera", "datamining", 0.35, 1),
                                         ("expander", "websearch", 0.2, 2),
                                         ("rotornet", "websearch", 0.15, 3))]
    sched = FailureSchedule.draw(topo, seed=5, tor_frac=0.25, link_frac=0.2,
                                 onset_step=40, detect_lag=5,
                                 recover_step=120)
    return clean, [apply_flow_faults(s, sched) for s in clean[:2]] + clean[2:]


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
def test_tiled_flows_match_dense_on_the_card(card, faulted):
    """The tiled engine on the card against the dense one on the card:
    histograms bitwise, p99s within one bin, the same backlog_frac and
    remaining bytes (both engines stage the same allowances and sum the
    same per-flow deficits on the host)."""
    scns = _tiled_scenarios()[faulted]
    dense = simulate_flows_batch(scns, engine="dense")
    tiled = simulate_flows_batch(scns, engine="tiled", tile_size=32,
                                 window_tiles=1, chunk_steps=16)
    assert tiled.peak_window_tiles > 1
    width = np.log2(1e7) / 96          # FCT_BIN_LOG2_WIDTH
    for d, t, dh, th, drem, trem in zip(
            dense.results, tiled.results, dense.hists, tiled.hists,
            dense.remaining_bytes, tiled.remaining_bytes):
        np.testing.assert_array_equal(th, dh)
        assert (t.admitted, t.finished_frac) == (d.admitted, d.finished_frac)
        assert t.backlog_frac == d.backlog_frac
        np.testing.assert_array_equal(trem, drem)
        for f in ("fct_p99_ms_small", "fct_p99_ms_mid", "fct_p99_ms_large"):
            a, b = getattr(t, f), getattr(d, f)
            if a == 0.0 or b == 0.0 or np.isinf(a) or np.isinf(b):
                assert a == b
            else:
                assert abs(np.log2(a / b)) <= width * (1 + 1e-9), f


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
def test_tiled_flows_on_the_card_match_cpu(card, faulted):
    """The device-resident window gives the CPU run's results: the same
    window peak, admission, completions and histogram class totals (a
    bin may move where CUDA's log and the CPU's differ in the last bit),
    and remaining bytes within tests/test_flows_jax.py's trajectory
    tolerance."""
    scns = _tiled_scenarios()[faulted]
    kw = dict(engine="tiled", tile_size=32, window_tiles=1, chunk_steps=16)
    got = simulate_flows_batch(scns, **kw)
    ref = simulate_flows_batch(scns, device="cpu", **kw)
    assert got.peak_window_tiles == ref.peak_window_tiles
    for s, g, r, gh, rh, grem, rrem in zip(
            scns, got.results, ref.results, got.hists, ref.hists,
            got.remaining_bytes, ref.remaining_bytes):
        np.testing.assert_array_equal(gh.sum(1), rh.sum(1))
        assert (g.admitted, g.finished_frac) == (r.admitted, r.finished_frac)
        assert abs(g.backlog_frac - r.backlog_frac) < 1e-5
        assert np.isclose(g.fct_mean_ms, r.fct_mean_ms, rtol=1e-5)
        np.testing.assert_allclose(grem, rrem, atol=s.sizes.max() * 1e-5)


# ---------------- training: the backward kernels ----------------------------


def _grad_close(got, want, dtype, what):
    """The kernels' tolerance relative to the gradient's largest value:
    |got - want| <= tol max|want| + tol |want| (chip_smoke.py)."""
    tol = _tol(dtype)["atol"]
    g, w = got.float(), want.float()
    bound = tol * float(w.abs().max()) + tol * w.abs()
    assert bool(((g - w).abs() <= bound).all()), (
        f"{what}: {float((g - w).abs().max())} beyond {tol} of "
        f"{float(w.abs().max())}")


def _bwd_inputs(case, dtype, device, seed=40):
    B, Hq, Hkv, Sq, Sk, hd, _, _ = case
    return (_normal((B, Hq, Sq, hd), seed, device, dtype),
            _normal((B, Hkv, Sk, hd), seed + 1, device, dtype),
            _normal((B, Hkv, Sk, hd), seed + 2, device, dtype),
            _normal((B, Hq, Sq, hd), seed + 3, device, dtype))


def _attention_grads(fn, q, k, v, do, causal, window):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = fn(q, k, v, causal, window)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))


BWD_CASES = [  # B, Hq, Hkv, Sq, Sk, hd, causal, window
    (1, 2, 2, 64, 64, 32, True, 0), (2, 4, 2, 64, 64, 64, True, 0),
    (1, 8, 1, 32, 32, 32, True, 0), (1, 2, 2, 64, 64, 32, False, 0),
    (1, 2, 1, 64, 64, 32, True, 24), (1, 2, 2, 32, 96, 32, True, 0),
    (1, 3, 1, 48, 48, 16, True, 0), (1, 2, 1, 96, 32, 32, True, 0),
    # smollm's layout over ragged tiles, yi's group 8, stablelm's hd 160
    # (padded to 256), hd 256 with a window, non-causal with Sq != Sk
    (2, 6, 2, 200, 200, 64, True, 0), (1, 16, 2, 130, 130, 128, True, 0),
    (1, 8, 2, 100, 100, 160, True, 0), (1, 4, 1, 90, 150, 256, True, 40),
    (1, 4, 2, 77, 200, 128, False, 0), (1, 4, 4, 120, 45, 64, False, 0),
    # the bf16 (wgmma) kernels' edges: Sq, Sk off 64 with Sq != Sk, causal;
    # a single query row; group 8 at hd 128 (causal with a window, and
    # non-causal); causal rows at negative positions over ragged tiles;
    # key tiles behind the window of every query (dK = dV = 0)
    (1, 4, 2, 100, 170, 64, True, 0), (2, 4, 2, 1, 130, 64, True, 0),
    (1, 8, 1, 192, 192, 128, True, 70), (1, 8, 1, 200, 330, 128, False, 0),
    (2, 3, 1, 130, 70, 32, True, 0), (1, 2, 1, 70, 70, 16, False, 0),
    (1, 4, 2, 40, 300, 64, True, 30),
    # hd 256 (bf16: two warpgroups a dK/dV block, the group cut into
    # parts): group 10 over one KV head with a window on ragged tiles;
    # Sq != Sk non-causal; causal rows at negative positions; key tiles
    # behind every query's window; a single query row; three heads in two
    # parts (2, 1: 136 key-tile blocks)
    (1, 10, 1, 200, 200, 256, True, 70), (1, 4, 2, 77, 200, 256, False, 0),
    (2, 3, 1, 130, 70, 256, True, 0), (1, 4, 2, 40, 300, 256, True, 30),
    (2, 4, 2, 1, 130, 256, True, 0), (2, 6, 2, 300, 2150, 256, True, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_bwd_matches_plain_autograd(card, case, dtype):
    """dq, dk, dv through `flash_attention`'s autograd function (one
    forward and one backward launch) against autograd through the plain
    version."""
    *_, causal, window = case
    q, k, v, do = _bwd_inputs(case, dtype, card)
    launch_counts.clear()
    got = _attention_grads(
        lambda *a: flash_attention(*a[:3], causal=a[3], window=a[4]),
        q, k, v, do, causal, window)
    assert dict(launch_counts) == {"flash_attention": 1,
                                   "flash_attention_bwd": 1}
    want = _attention_grads(flash_attention_ref, q, k, v, do, causal, window)
    torch.cuda.synchronize()
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        _grad_close(g, w, dtype, name)


@pytest.mark.parametrize("dtype,hd", [
    (torch.bfloat16, 16), (torch.bfloat16, 32), (torch.bfloat16, 64),
    (torch.bfloat16, 128), (torch.bfloat16, 256), (torch.float32, 64)])
def test_flash_attention_bwd_runs_wgmma_for_bf16_up_to_hd_128(card, dtype,
                                                              hd):
    """The profiler's kernel names: bf16 at hd 16-256 launches the wgmma
    dK/dV and dQ kernels, f32 the CUDA-core ones, each after the D
    pass."""
    from torch.profiler import ProfilerActivity, profile

    case = (1, 4, 2, 96, 96, hd, True, 0)
    q, k, v, do = (t.reshape(-1, 96, hd)
                   for t in _bwd_inputs(case, dtype, card))
    o, lse = flash_attention_fwd(q, k, v, 2, True, 0, return_lse=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention_bwd(q, k, v, o, do, lse, 2, True, 0)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if "flash_bwd" in e.key}
    wgmma = dtype == torch.bfloat16 and hd in BWD_WGMMA_HEAD_DIMS
    assert any("flash_bwd_dsum" in n for n in names), names
    for part in ("flash_bwd_dkdv", "flash_bwd_dq"):
        hits = [n for n in names if part in n]
        assert len(hits) == 1 and ("wgmma" in hits[0]) == wgmma, names


def test_flash_attention_bwd_is_deterministic(card):
    case = (2, 6, 2, 300, 300, 64, True, 0)
    q, k, v, do = _bwd_inputs(case, torch.bfloat16, card)
    fn = lambda *a: flash_attention(*a[:3], causal=a[3])  # noqa: E731
    a = _attention_grads(fn, q, k, v, do, True, 0)
    b = _attention_grads(fn, q, k, v, do, True, 0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(1, 4, 2, 70, 70, 64, True, 0),
                                  (1, 4, 1, 96, 40, 128, True, 0),
                                  (1, 4, 2, 50, 80, 256, False, 0),
                                  (1, 2, 1, 64, 64, 32, True, 24)])
def test_flash_attention_lse_matches_logsumexp(card, case, dtype):
    """The forward's lse against torch.logsumexp of the plain version's
    scaled, masked scores (rows with no live key at -1e30, as both give)."""
    from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask

    B, Hq, Hkv, Sq, Sk, hd, causal, window = case
    q, k, v, _ = _bwd_inputs(case, dtype, card)
    o, lse = flash_attention_fwd(q.reshape(-1, Sq, hd), k.reshape(-1, Sk, hd),
                                 v.reshape(-1, Sk, hd), Hq // Hkv, causal,
                                 window, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B * Hq, Sq)
    assert torch.equal(o, flash_attention_fwd(
        q.reshape(-1, Sq, hd), k.reshape(-1, Sk, hd), v.reshape(-1, Sk, hd),
        Hq // Hkv, causal, window))
    s = torch.einsum("bhgqd,bhkd->bhgqk",
                     q.reshape(B, Hkv, Hq // Hkv, Sq, hd).float(),
                     k.float()) * hd**-0.5
    mask = attention_mask(Sq, Sk, causal, window, device=card)
    want = torch.logsumexp(torch.where(mask, s, NEG_INF), -1).reshape(-1, Sq)
    torch.testing.assert_close(lse, want, atol=2e-5, rtol=2e-5)


def test_flash_attention_bwd_hd256_parts_are_deterministic(card):
    """bf16 at hd 256 with the group cut into parts (10 heads, 10 parts
    here): the parts' sum kernel runs, and a second call gives the same
    bits."""
    case = (1, 10, 1, 300, 300, 256, True, 70)
    q, k, v, do = _bwd_inputs(case, torch.bfloat16, card)
    assert bwd_kv_splits(torch.bfloat16, 256, 1, 300, 10) == 10
    fn = lambda *a: flash_attention(*a[:3], causal=a[3],  # noqa: E731
                                    window=a[4])
    a = _attention_grads(fn, q, k, v, do, True, 70)
    b = _attention_grads(fn, q, k, v, do, True, 70)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    qf, kf, vf, dof = (t.reshape(-1, t.shape[2], 256) for t in (q, k, v, do))
    o, lse = flash_attention_fwd(qf, kf, vf, 10, True, 70, return_lse=True)
    names = _traced_kernels(
        lambda: flash_attention_bwd(qf, kf, vf, o, dof, lse, 10, True, 70),
        "flash_bwd")
    assert "flash_bwd_kv_reduce" in names, names


def test_flash_attention_bwd_checks_its_inputs(card):
    case = (1, 4, 2, 32, 32, 64, True, 0)
    q, k, v, do = (t.reshape(-1, t.shape[2], t.shape[3])
                   for t in _bwd_inputs(case, torch.float32, card))
    o, lse = flash_attention_fwd(q, k, v, 2, True, 0, return_lse=True)
    flash_attention_bwd(q, k, v, o, do, lse, 2, True, 0)
    with pytest.raises(ValueError):   # o of another type
        flash_attention_bwd(q, k, v, o.bfloat16(), do, lse, 2, True, 0)
    with pytest.raises(ValueError):   # dO off the card
        flash_attention_bwd(q, k, v, o, do.cpu(), lse, 2, True, 0)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, do[:, :16].contiguous(), lse, 2,
                            True, 0)
    with pytest.raises(ValueError):   # lse of the wrong shape / type
        flash_attention_bwd(q, k, v, o, do, lse[:, :16].contiguous(), 2,
                            True, 0)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, do, lse.double(), 2, True, 0)
    with pytest.raises(ValueError):   # 4 rows != 2 x 3
        flash_attention_bwd(q, k, v, o, do, lse, 3, True, 0)
    with pytest.raises(TypeError):
        flash_attention_bwd(q.double(), k.double(), v.double(), o, do, lse,
                            2, True, 0)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    ob, lb = flash_attention_fwd(qb, kb, vb, 2, True, 0, return_lse=True)
    buf = torch.empty(do.numel() + 1, dtype=torch.bfloat16, device=card)
    dob = buf[1:].view(do.shape)   # 2 bytes past an aligned start
    dob.copy_(do)
    with pytest.raises(ValueError, match="16 bytes"):   # cp.async
        flash_attention_bwd(qb, kb, vb, ob, dob, lb, 2, True, 0)


def test_flash_attention_bwd_raises_above_hd_256(card):
    """The forward serves hd 320 (the f32 kernel's hd 512); autograd
    through it raises where the backward has no instantiation."""
    q = _normal((1, 4, 32, 320), 50, card, torch.float32)
    k = _normal((1, 2, 32, 320), 51, card, torch.float32)
    with torch.no_grad():
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="backward"):
        flash_attention(q.requires_grad_(), k, k)
    f = q.detach().reshape(4, 32, 320)
    kf = k.reshape(2, 32, 320)
    with pytest.raises(ValueError, match="backward"):
        flash_attention_bwd(f, kf, kf, f, f, torch.zeros(4, 32, device=card),
                            2, True, 0)


def _model_kernel_calls(card):
    """A small call of each of moe_gmm, mamba_scan and rglru_scan."""
    h = _normal((4, 8, 64), 60, card, torch.float32)
    w = _normal((4, 64, 32), 61, card, torch.float32, 0.125)
    wd = _normal((4, 32, 64), 62, card, torch.float32, 0.125)
    mamba = _mamba_inputs(1, 16, 32, 4, 63, card, torch.float32)
    a = _normal((1, 16, 32), 64, card, torch.float32).sigmoid()
    h0 = _normal((1, 32), 65, card, torch.float32)
    return {"moe_gmm": (moe_gmm, moe_gmm_ref, (h, w, w, wd)),
            "mamba_scan": (mamba_scan, mamba_scan_ref, tuple(mamba)),
            "rglru_scan": (rglru_scan, rglru_scan_ref, (a, a, h0))}


def test_model_kernels_carry_gradients_on_the_card(card):
    """F3 repaired: under autograd moe_gmm, mamba_scan and rglru_scan run
    their forward kernel once and their backward kernel once, with the
    gradients of autograd through the plain version; a serving call (no
    grad) launches the forward alone and gives the same bits as a call
    on tensors that require nothing."""
    for name, (fn, ref, args) in _model_kernel_calls(card).items():
        want = fn(*args)   # nothing requires grad
        launch_counts.clear()
        with torch.no_grad():
            served = fn(*(t.detach().requires_grad_() for t in args))
        assert dict(launch_counts) == {name: 1}, name
        got = served if isinstance(served, tuple) else (served,)
        ref_out = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(x, y) for x, y in zip(got, ref_out)), name
        grads = []
        for f in (fn, ref):
            leaves = [t.detach().requires_grad_() for t in args]
            out = f(*leaves)
            out = out[0] if isinstance(out, tuple) else out
            grads.append(torch.autograd.grad(out, leaves,
                                             torch.ones_like(out)))
            if f is fn:
                assert dict(launch_counts) == {name: 2, f"{name}_bwd": 1}, \
                    name
        for g, w in zip(*grads):
            _grad_close(g, w, torch.float32, name)


GMM_BWD_CASES = [  # E, C, D, F: ragged against the 64 x 64 tiles
    (2, 16, 16, 32), (4, 8, 32, 64), (3, 12, 8, 24), (2, 67, 130, 70),
    (1, 5, 33, 17), (8, 40, 256, 96),
    # the bf16 kernels' 64 x 128 and 128 x 64 block tiles: a multiple of
    # them, ragged against them, D and F not multiples of 8 (element loads)
    (4, 128, 256, 256), (3, 100, 200, 150), (2, 70, 75, 45)]


def _gmm_bwd_grads(fn, h, ws, dout):
    leaves = [t.detach().requires_grad_() for t in (h, *ws)]
    return torch.autograd.grad(fn(*leaves), leaves, dout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GMM_BWD_CASES)
def test_moe_gmm_bwd_matches_plain_autograd(card, case, dtype):
    """dh, dWg, dWu, dWd through `moe_gmm`'s autograd function (one
    forward, one backward launch) against autograd through the plain
    version, empty capacity rows giving zero dh; bit for bit on a rerun."""
    E, C, D, F = case
    h = _normal((E, C, D), 70, card, dtype)
    h[:, C - C // 4:] = 0   # empty capacity rows
    ws = [_normal(s, 71 + i, card, dtype, s[1] ** -0.5)
          for i, s in enumerate(((E, D, F), (E, D, F), (E, F, D)))]
    dout = _normal((E, C, D), 74, card, dtype)
    launch_counts.clear()
    got = _gmm_bwd_grads(moe_gmm, h, ws, dout)
    assert dict(launch_counts) == {"moe_gmm": 1, "moe_gmm_bwd": 1}
    want = _gmm_bwd_grads(moe_gmm_ref, h, ws, dout)
    torch.cuda.synchronize()
    for name, g, w in zip(("dh", "dwg", "dwu", "dwd"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        _grad_close(g, w, dtype, name)
    assert not got[0][:, C - C // 4:].any()
    again = _gmm_bwd_grads(moe_gmm, h, ws, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("case", [(2, 16, 16, 32), (2, 67, 130, 70),
                                  (4, 128, 256, 256), (2, 70, 75, 45)])
def test_moe_gmm_bwd_takes_the_configs_activation(card, case, act, dtype):
    """dh, dWg, dWu, dWd of the gelu and relu instantiations of the
    activation pass through `moe_gmm`'s autograd function against
    autograd through `moe_gmm_ref` with the same activation, empty
    capacity rows giving zero dh.  relu's derivative steps at G = 0:
    where the plain version's G lies within 2^-16 of sum |h| |Wg| of
    zero (under 1e-3 of the elements) the kernel's other summation order
    may take the other side, and dh and dWg may move by that much more
    (chip_smoke.py's `_relu_steps`)."""
    E, C, D, F = case
    h = _normal((E, C, D), 60, card, dtype)
    h[:, C - C // 4:] = 0
    ws = [_normal(s, 61 + i, card, dtype, s[1] ** -0.5)
          for i, s in enumerate(((E, D, F), (E, D, F), (E, F, D)))]
    dout = _normal((E, C, D), 64, card, dtype)
    launch_counts.clear()
    got = _gmm_bwd_grads(lambda *a: moe_gmm(*a, act), h, ws, dout)
    assert dict(launch_counts) == {"moe_gmm": 1, "moe_gmm_bwd": 1}
    want = _gmm_bwd_grads(lambda *a: moe_gmm_ref(*a, act), h, ws, dout)
    torch.cuda.synchronize()
    allow = [0.0] * 4
    if act == "relu":
        h32, g32, u32, d32 = (t.float() for t in (h, *ws))
        near = torch.einsum("ecd,edf->ecf", h32, g32).abs() <= 2.0**-16 * (
            torch.einsum("ecd,edf->ecf", h32.abs(), g32.abs()))
        assert int(near.sum()) <= 1e-3 * near.numel()
        step = near * (torch.einsum("ecd,efd->ecf", dout.float(), d32)
                       * torch.einsum("ecd,edf->ecf", h32, u32)).abs()
        allow[:2] = (torch.einsum("ecf,edf->ecd", step, g32.abs()),
                     torch.einsum("ecd,ecf->edf", h32.abs(), step))
    tol = _tol(dtype)["atol"]
    for name, g, w, a in zip(("dh", "dwg", "dwu", "dwd"), got, want, allow):
        g, w = g.float(), w.float()
        bound = tol * float(w.abs().max()) + tol * w.abs() + a
        assert bool(((g - w).abs() <= bound).all()), (
            f"{act} {name}: {float((g - w).abs().max())} beyond {tol} of "
            f"{float(w.abs().max())}")
    assert not got[0][:, C - C // 4:].any()


def _traced_kernels(fn, part: str, reps: int = 10) -> set:
    """Names (template arguments kept) of the kernels holding `part` in
    the profiler's CUDA trace of `reps` calls of `fn`, after a warm call.
    The card's profiler drops a process's first traced launches at times
    (a trace of one call has kept only its last kernel), so several
    calls are traced, and a trace with none is taken again (up to 3
    times), as chip_smoke.py's `_traced` does."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = {re.search(r"(\w+(?:<[^>]*>)?)\(", e.key).group(1)
                 for e in prof.key_averages() if part in e.key}
        if names:
            return names
    return set()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_bwd_runs_wgmma_for_bf16(card, dtype):
    """The profiler's kernel names: bf16 launches the four wgmma kernels
    alone (the activation pass, silu's instantiation, the two
    weight-gradient launches, dh), f32 the CUDA-core ones alone (the
    activation pass and the tiled products of dWd, dWg, dWu and dh)."""
    from repro_torch.kernels.moe_gmm.kernel import moe_gmm_bwd

    E, C, D, F = 2, 70, 128, 96
    h = _normal((E, C, D), 75, card, dtype)
    ws = [_normal(s, 76 + i, card, dtype, s[1] ** -0.5)
          for i, s in enumerate(((E, D, F), (E, D, F), (E, F, D)))]
    dout = _normal((E, C, D), 79, card, dtype)
    want = ({"moe_bwd_act_wgmma<0>", "moe_bwd_wgrad_wgmma<1>",
             "moe_bwd_wgrad_wgmma<2>", "moe_bwd_dh_wgmma"}
            if dtype == torch.bfloat16 else
            {"moe_bwd_act<float, 0>",
             "moe_bwd_gemm<float, false, float, false, float>",
             "moe_bwd_gemm<float, true, float, true, float>"})
    assert _traced_kernels(lambda: moe_gmm_bwd(h, *ws, dout),
                           "moe_bwd") == want


@pytest.mark.parametrize("vec", [True, False])
def test_moe_wgmma_probe_matches_matmul(card, vec):
    """The bf16 backward's tile products alone, in the three operand
    orientations its passes use (x K-major with y MN-major, both K-major,
    both MN-major), its atoms filled by 16-byte copies or by element
    loads: exact up to the f32 summation order, within 1e-5 of the sum of
    the products' magnitudes."""
    from repro_torch.kernels.moe_gmm.kernel import moe_wgmma_probe

    x = _normal((64, 64), 80, card, torch.bfloat16)
    y = _normal((64, 64), 81, card, torch.bfloat16)
    out = moe_wgmma_probe(x, y, vec=vec)
    torch.cuda.synchronize()
    for got, a, b in zip(out, (x, x, x.T), (y, y.T, y)):
        want = a.double() @ b.double()
        size = a.double().abs() @ b.double().abs()
        assert float(((got.double() - want).abs() - 1e-5 * size).max()) <= 0


def _rglru_bwd_grads(fn, a, bx, h0, dhs):
    leaves = [t.detach().requires_grad_() for t in (a, bx, h0)]
    return torch.autograd.grad(fn(*leaves), leaves, dhs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D", [
    (1, 32, 16), (2, 64, 8), (1, 48, 24), (1, 65, 130), (2, 300, 200),
    (1, 1, 5), (1, 4096, 256),
    # recurrentgemma-2b's training shape; ragged S and D at B 3 (D not a
    # multiple of 8: element loads); a chunk's multiple and a step
    (1, 4096, 2560), (3, 1000, 2500), (2, 129, 130)])
def test_rglru_scan_bwd_matches_plain_autograd(card, B, S, D, dtype):
    """da, dbx, dh0 through `rglru_scan`'s autograd function against
    autograd through the plain version: one chunk, several, ragged S and
    D, and over a hundred chunks; bit for bit on a rerun."""
    a = _normal((B, S, D), 80, card, torch.float32).sigmoid() * 0.3 + 0.69
    a = a.to(dtype)
    bx = _normal((B, S, D), 81, card, dtype)
    h0 = _normal((B, D), 82, card, torch.float32)
    dhs = _normal((B, S, D), 83, card, torch.float32)
    launch_counts.clear()
    got = _rglru_bwd_grads(rglru_scan, a, bx, h0, dhs)
    assert dict(launch_counts) == {"rglru_scan": 1, "rglru_scan_bwd": 1}
    want = _rglru_bwd_grads(rglru_scan_ref, a, bx, h0, dhs)
    torch.cuda.synchronize()
    for name, g, w in zip(("da", "dbx", "dh0"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _grad_close(g, w, dtype, name)
    again = _rglru_bwd_grads(rglru_scan, a, bx, h0, dhs)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def _rglru_bwd_inputs(B, S, D, seed, device, dtype):
    a = _normal((B, S, D), seed, device, torch.float32).sigmoid() * 0.3 + 0.69
    a = a.to(dtype)
    bx = _normal((B, S, D), seed + 1, device, dtype)
    h0 = _normal((B, D), seed + 2, device, torch.float32)
    dhs = _normal((B, S, D), seed + 3, device, torch.float32)
    return a, rglru_scan_fwd(a, bx, h0), h0, dhs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D", [
    (1, 1, 5), (1, 63, 8), (2, 64, 130), (1, 65, 256), (3, 1000, 2500),
    (2, 129, 136), (1, 4096, 2560), (2, 4500, 72)])
def test_rglru_scan_bwd_equals_chunked_emulation(card, B, S, D, dtype):
    """The backward kernel gives the bits of its own order of operations
    in plain torch (`rglru_scan_bwd_chunked_ref` at the kernel's chunk):
    chunk walks, carries folded from the last chunk, walks from the
    carries."""
    from repro_torch.kernels.rglru_scan.kernel import (
        BWD_CHUNK,
        rglru_scan_bwd,
    )
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_chunked_ref

    a, hs, h0, dhs = _rglru_bwd_inputs(B, S, D, 84, card, dtype)
    launch_counts.clear()
    got = rglru_scan_bwd(a, hs, h0, dhs)
    assert dict(launch_counts) == {"rglru_scan_bwd": 1}
    want = rglru_scan_bwd_chunked_ref(a, hs, h0, dhs, BWD_CHUNK)
    torch.cuda.synchronize()
    for name, g, w in zip(("da", "dbx", "dh0"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_bwd_reruns_give_the_same_bits(card, dtype):
    """20 runs at B 2 over 70 chunks (the look-back's waits and folds
    differ from run to run) give one result, the chunked emulation's."""
    from repro_torch.kernels.rglru_scan.kernel import (
        BWD_CHUNK,
        rglru_scan_bwd,
    )
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_chunked_ref

    S = 70 * BWD_CHUNK - 17
    a, hs, h0, dhs = _rglru_bwd_inputs(2, S, 1280, 88, card, dtype)
    first = rglru_scan_bwd(a, hs, h0, dhs)
    for _ in range(19):
        again = rglru_scan_bwd(a, hs, h0, dhs)
        assert all(torch.equal(x, y) for x, y in zip(first, again))
    want = rglru_scan_bwd_chunked_ref(a, hs, h0, dhs, BWD_CHUNK)
    assert all(torch.equal(x, y) for x, y in zip(first, want))


def _mamba_bwd_grads(fn, args, dy, dhs):
    leaves = [t.detach().requires_grad_() for t in args]
    y, h = fn(*leaves)
    outs, grads = ((y, h), (dy, dhs)) if dhs is not None else ((y,), (dy,))
    return torch.autograd.grad(outs, leaves, grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D,N,with_hs", [
    (1, 16, 8, 4, False), (2, 32, 16, 4, True), (1, 24, 12, 2, False),
    (2, 16, 8, 8, True), (1, 40, 300, 16, True), (2, 33, 70, 3, False),
    (1, 20, 16, 32, True), (1, 1, 9, 1, True), (1, 512, 256, 16, False),
    # S at the saved states' 16 steps and the passes' 64-step chunks, one
    # of each short of them and past them; 66 chunks
    (1, 15, 70, 16, True), (2, 17, 24, 16, False), (1, 63, 9, 5, True),
    (2, 64, 24, 16, True), (1, 65, 100, 16, False), (1, 197, 40, 32, True),
    (1, 4165, 64, 16, True)])
def test_mamba_scan_bwd_matches_plain_autograd(card, B, S, D, N, with_hs,
                                               dtype):
    """dx, ddt, dB, dC, dA, dD through `mamba_scan`'s autograd function
    against autograd through the plain version, with and without h_S's
    gradient, N from 1 to 32, ragged S and D, S on and beside the chunk
    boundaries and over 64 chunks; bit for bit on a rerun."""
    args = _mamba_inputs(B, S, D, N, 90, card, dtype)
    dy = _normal((B, S, D), 91, card, torch.float32)
    dhs = _normal((B, D, N), 92, card, torch.float32) if with_hs else None
    launch_counts.clear()
    got = _mamba_bwd_grads(mamba_scan, args, dy, dhs)
    assert dict(launch_counts) == {"mamba_scan": 1, "mamba_scan_bwd": 1}
    want = _mamba_bwd_grads(mamba_scan_ref, args, dy, dhs)
    torch.cuda.synchronize()
    for name, g, w in zip(("dx", "ddt", "dB", "dC", "dA", "dD"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _grad_close(g, w, dtype, name)
    again = _mamba_bwd_grads(mamba_scan, args, dy, dhs)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("B,S,D,N,x_dtype", [
    (1, 16, 8, 4, torch.float32), (2, 33, 70, 3, torch.float32),
    (1, 65, 300, 16, torch.bfloat16), (1, 20, 16, 32, torch.float32),
    (1, 1, 9, 1, torch.float32)])
def test_mamba_scan_states_match_plain_version(card, B, S, D, N, x_dtype):
    """The forward's chunk states (the state before every 16 steps)
    against the plain version's, and y and h_S the same bits as a call
    that keeps none."""
    from repro_torch.kernels.mamba_scan.kernel import state_shape

    args = _mamba_inputs(B, S, D, N, 93, card, torch.float32,
                         x_dtype=x_dtype)
    y, h = mamba_scan_fwd(*args)
    ky, kh, states = mamba_scan_fwd(*args, states=True)
    _, _, want = mamba_scan_ref(*args, states=True)
    torch.cuda.synchronize()
    assert torch.equal(y, ky) and torch.equal(h, kh)
    assert states.shape == want.shape == state_shape(args[0], args[4])
    torch.testing.assert_close(states, want, atol=1e-4, rtol=1e-4)
    assert not states[:, 0].any()   # the state before step 0


def test_mamba_scan_serving_keeps_no_states(card):
    """With no grad recorded the op launches the forward kernel once and
    allocates y and h_S alone; under autograd it keeps the chunk states."""
    args = _mamba_inputs(1, 512, 256, 16, 94, card, torch.float32)
    leaves = [t.detach().requires_grad_() for t in args]
    states_bytes = 4 * 1 * (512 // 16) * 256 * 16
    out_bytes = 4 * (512 * 256 + 256 * 16)
    for grad in (False, True):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(card)
        torch.cuda.reset_peak_memory_stats(card)
        launch_counts.clear()
        with torch.set_grad_enabled(grad):
            y, h = mamba_scan(*leaves)
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated(card) - before
        assert dict(launch_counts) == {"mamba_scan": 1}
        assert (y.grad_fn is not None) == grad
        if grad:
            assert grown >= out_bytes + states_bytes
        else:
            assert grown < out_bytes + states_bytes // 2
        del y, h


def test_mamba_scan_bwd_runs_its_passes(card):
    """The profiler's kernel names: the local, carry, main and sum passes,
    and no forward walk."""
    from repro_torch.kernels.mamba_scan.kernel import (
        BWD_PASSES,
        mamba_scan_bwd,
    )

    args = _mamba_inputs(1, 300, 200, 16, 95, card, torch.float32,
                         x_dtype=torch.bfloat16)
    states = mamba_scan_fwd(*args, states=True)[2]
    dy = _normal((1, 300, 200), 96, card, torch.float32)
    names = _traced_kernels(lambda: mamba_scan_bwd(*args, dy, None, states),
                            "mamba_scan")
    assert {n.split("<")[0] for n in names} == set(BWD_PASSES)


def test_backward_kernel_wrappers_check_their_inputs(card):
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan_bwd
    from repro_torch.kernels.moe_gmm.kernel import moe_gmm_bwd
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_bwd

    h = _normal((2, 8, 16), 100, card, torch.float32)
    w = _normal((2, 16, 8), 101, card, torch.float32)
    wd = _normal((2, 8, 16), 102, card, torch.float32)
    with pytest.raises(ValueError):
        moe_gmm_bwd(h, w, w, wd, h[:, :4].contiguous())
    with pytest.raises(ValueError):
        moe_gmm_bwd(h, w, w, wd, h.bfloat16())
    a = _normal((1, 8, 16), 103, card, torch.float32)
    h0 = _normal((1, 16), 104, card, torch.float32)
    with pytest.raises(ValueError):
        rglru_scan_bwd(a, a.bfloat16(), h0, a)      # hs not f32
    with pytest.raises(ValueError):
        rglru_scan_bwd(a, a, h0, a.cpu())
    args = _mamba_inputs(1, 8, 16, 4, 105, card, torch.float32)
    states = mamba_scan_fwd(*args, states=True)[2]
    with pytest.raises(ValueError):
        mamba_scan_bwd(*args, a[:, :4].contiguous(), None, states)
    with pytest.raises(ValueError):
        mamba_scan_bwd(*args, a, torch.zeros(1, 16, 5, device=card), states)
    with pytest.raises(ValueError):   # the forward's chunk states needed
        mamba_scan_bwd(*args, a, None, None)
    with pytest.raises(ValueError):
        mamba_scan_bwd(*args, a, None, states[:, :, :8].contiguous())


def test_reduced_train_step_on_the_card_equals_cpu(card):
    """Two steps of reduced smollm-360m in f32 in its head layout (hd 64, 3
    query heads a KV head) on the card and on the CPU from the same
    masters: losses, grad norms rtol 1e-5, parameters atol/rtol 1e-5;
    flash 2 launches a layer a step (remat), backward 1."""
    import copy

    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.models.parallel import single_device_ctx
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    cfg = reduced_config(get_config("smollm-360m")).replace(
        compute_dtype="float32", num_heads=3, num_kv_heads=1, head_dim=64)
    cpu = init_params(cfg, 0, device="cpu", masters=True)
    on_card = copy.deepcopy(cpu).to(card)
    step = make_train_step(cfg, single_device_ctx(),
                           AdamWConfig(lr=1e-4, warmup_steps=2,
                                       total_steps=10))
    src = SyntheticLM(cfg.vocab_size, 64, 4, seed=0)
    runs = {}
    for dev, params in (("cpu", cpu), ("cuda", on_card)):
        state = init_train_state(cfg, params)
        launch_counts.clear()
        rows = []
        for _, batch in zip(range(2), device_batches(src, 0, dev)):
            state, m = step(state, batch)
            rows.append({k: float(v) for k, v in m.items()})
        runs[dev] = (state, rows, dict(launch_counts))
    (cs, crows, _), (gs, grows, launches) = runs["cpu"], runs["cuda"]
    L = cfg.num_layers
    assert launches == {"flash_attention": 2 * 2 * L,
                        "flash_attention_bwd": 2 * L}
    for a, b in zip(grows, crows):
        for k in ("loss", "grad_norm", "lr"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), k
    got = dict(gs["params"].named_parameters())
    for name, p in cs["params"].named_parameters():
        torch.testing.assert_close(got[name].detach().cpu(), p.detach(),
                                   atol=1e-5, rtol=1e-5)


# kernels a layer of each kind launches in training, by arch
TRAIN_KERNELS = {
    "qwen3-moe-30b-a3b": {"flash_attention": "moe", "moe_gmm": "moe"},
    "falcon-mamba-7b": {"mamba_scan": "ssm"},
    "recurrentgemma-2b": {"rglru_scan": "rglru",
                          "flash_attention": "local_attn"},
}


@pytest.mark.parametrize("arch", list(TRAIN_KERNELS))
def test_reduced_arch_train_step_on_the_card_equals_cpu(card, arch):
    """Two steps of a reduced MoE, SSM or hybrid arch in f32 on the card
    and on the CPU from the same masters: losses, grad norms rtol 1e-5,
    parameters atol/rtol 1e-5; each kernel 2 forward launches a layer of
    its kind a step (remat) and 1 backward launch."""
    import copy

    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.models.transformer import stack_plan
    from repro_torch.models.parallel import single_device_ctx
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    cfg = reduced_config(get_config(arch)).replace(compute_dtype="float32")
    cpu = init_params(cfg, 0, device="cpu", masters=True)
    on_card = copy.deepcopy(cpu).to(card)
    step = make_train_step(cfg, single_device_ctx(),
                           AdamWConfig(lr=1e-4, warmup_steps=2,
                                       total_steps=10))
    src = SyntheticLM(cfg.vocab_size, 64, 4, seed=0)
    runs = {}
    for dev, params in (("cpu", cpu), ("cuda", on_card)):
        state = init_train_state(cfg, params)
        launch_counts.clear()
        rows = []
        for _, batch in zip(range(2), device_batches(src, 0, dev)):
            state, m = step(state, batch)
            rows.append({k: float(v) for k, v in m.items()})
        runs[dev] = (state, rows, dict(launch_counts))
    (cs, crows, _), (gs, grows, launches) = runs["cpu"], runs["cuda"]
    kinds = stack_plan(cfg).kinds
    want = {}
    for name, kind in TRAIN_KERNELS[arch].items():
        n = kinds.count(kind)
        want[name] = 2 * 2 * n
        want[f"{name}_bwd"] = 2 * n
    assert launches == want
    for a, b in zip(grows, crows):
        for k in ("loss", "grad_norm", "lr"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), k
    got = dict(gs["params"].named_parameters())
    for name, p in cs["params"].named_parameters():
        torch.testing.assert_close(got[name].detach().cpu(), p.detach(),
                                   atol=1e-5, rtol=1e-5)


# ---------------- the rotor collectives and opera-dp on the card ------------


@pytest.fixture(scope="module")
def card_world(card):
    """Every collective case of a world of 2 ranks on the one card (gloo,
    staged through host memory: NCCL refuses two ranks on one card)."""
    import torch_dist_cases as K
    from repro_torch.core.comm import spawn_world

    return spawn_world(K.collective_rank, 2, ["w2"], device="cuda",
                       timeout_s=300)


def _tree_leaves(t) -> list:
    return [t["a"], t["b"]["c"]] if isinstance(t, dict) else [t]


@pytest.mark.parametrize("name", [
    "rs@data", "ag@data", "ar@data", "ar_direct@data", "a2a@data",
    "a2a_vlb@data", "exp_ag@data", "exp_psum@data", "hier", "tree", "comp"])
def test_collective_on_cuda_tensors(card_world, name):
    """Each collective on CUDA tensors against its float64 reference at
    atol/rtol 1e-5 (the compressed one within a relative 0.05, its error
    and payload giving back its input); wire bytes as `schedule_stats`."""
    import torch_dist_cases as K

    assert all(r["backend"] == "gloo" for r in card_world)
    for rank, r in enumerate(card_world):
        got, _ = r["w2"][name]
        if name == "comp":
            x = K.inputs("w2", "comp", K.SHAPE)
            want = x[0].astype(np.float64).sum(0)
            err = np.abs(got["total1"] - want).max() / np.abs(want).max()
            assert err < 0.05
            np.testing.assert_allclose(
                got["q2"].astype(np.float32) * got["scale2"] + got["err2"],
                x[1][rank] + got["err1"], atol=1e-6)
            continue
        want = K.exact("w2", name, rank)
        for g, w in zip(*(_tree_leaves(t) for t in (got, want))):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
        assert r["w2"]["wire"] == {"rs_ag": 1.0, "direct": 1.0}


def test_opera_dp_step_on_the_card_equals_cpu(card):
    """Two opera-dp steps of reduced smollm (f32, hd 64) on a world of 2
    ranks on the card and on the CPU from the same seed-0 masters: losses
    and grad norms rtol 1e-5, rank 0's parameters atol/rtol 1e-5, the
    replicas the same bits; each rank launches the flash kernel 2 times a
    layer a step and its backward once."""
    import torch_dist_cases as K
    from repro_torch.core.comm import spawn_world

    runs = [("w2", False, 2)]
    card_run, cpu_run = (spawn_world(K.dp_rank, 2, None, runs, device=d,
                                     timeout_s=300)
                         for d in ("cuda", "cpu"))
    L = K.DP_CONFIG["num_layers"]
    for r in card_run:
        assert r[0]["launches"] == {"flash_attention": 2 * L * 2,
                                    "flash_attention_bwd": L * 2}
    for i in range(2):
        assert card_run[0][0]["rows"][i]["digest"] == \
            card_run[1][0]["rows"][i]["digest"]
        a, b = card_run[0][0]["rows"][i], cpu_run[0][0]["rows"][i]
        for k in ("loss", "grad_norm", "lr"):
            assert a["metrics"][k] == pytest.approx(b["metrics"][k],
                                                    rel=1e-5), k
        for name, p in b["params"].items():
            np.testing.assert_allclose(a["params"][name], p, atol=1e-5,
                                       rtol=1e-5, err_msg=name)
