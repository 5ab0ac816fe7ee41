"""ctypes binding of the Hopper flash attention kernels: the forward
(``csrc/flash_attention.cu``) and the backward
(``csrc/flash_attention_bwd.cu``, its own library).

The CUDA source replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py::_kernel``; its header states
the bound and the design.  The library is built at first use (see
`repro_torch.kernels.build_library`).  The wrapper checks what it is
given, allocates the output with `torch.empty`, launches on the current
stream without synchronising, and raises on a non-zero ``cudaError_t``.
A head dim between the instantiations is zero-padded to the next one
(`padded_head_dim`): zero columns add nothing to Q K^T and give zero
output columns, and the scale stays that of the true head dim.  Head
dims above 256 run on the f32 kernel's hd-512 and hd-1024 instantiations
only: bf16 inputs are widened to f32 for the call and the output rounded
back once.  Above 1024 the wrapper raises.

The forward writes each row's logsumexp when asked (``return_lse``), for
`flash_attention_bwd`, which computes dq, dk and dv from q, k, v, o, the
output's gradient and that lse in three kernels, four where the group
is cut into parts (one call, counted once under ``flash_attention_bwd``),
at head dims up to 256 (zero-padded as the forward pads them); above
256 it raises (ROADMAP item 6b).  bf16
(`BWD_WGMMA_HEAD_DIMS`, hd 16-256) runs on the tensor cores (wgmma); f32
on the CUDA cores.  At hd 256 a dK/dV block is two warpgroups, and each
KV head's group of query heads may be cut into parts walked by separate
blocks (`bwd_kv_splits`), whose f32 sums a fourth kernel adds.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build_library, launch_counts

NAME = "flash_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_NAME = "flash_attention_bwd"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
HEAD_DIMS = (16, 32, 64, 128, 256, 512, 1024)  # the f32 kernel's
WGMMA_HEAD_DIMS = HEAD_DIMS[:5]                # the bf16 (wgmma) kernel's
BWD_HEAD_DIMS = HEAD_DIMS[:5]                  # the backward's
BWD_WGMMA_HEAD_DIMS = HEAD_DIMS[:5]            # its bf16 (wgmma) kernels'
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# dK/dV blocks the head split aims at: two for each SM of an H100 SXM
# (132), fixed rather than read from the card, so that the order of the
# sums, and so the bits, are the same on every card
BWD_FILL_BLOCKS = 2 * 132

_lib = None
_bwd_lib = None


def library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = build_library(NAME, [SOURCE])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32,
            ctypes.c_float, ptr,
        ]
        lib.flash_attention_launch.restype = i32
        lib.flash_wgmma_probe_launch.argtypes = [ptr] * 6 + [i32, ptr]
        lib.flash_wgmma_probe_launch.restype = i32
        _lib = lib
    return _lib


def bwd_library() -> ctypes.CDLL:
    """Build (once per source content) and load the backward's library."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = build_library(BWD_NAME, [BWD_SOURCE])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd_launch.argtypes = [ptr] * 11 + [i32] * 9 + [
            ctypes.c_float, ptr]
        lib.flash_attention_bwd_launch.restype = i32
        _bwd_lib = lib
    return _bwd_lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           group: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (BH, S, hd)")
    bhq, _, hd = q.shape
    if k.shape != v.shape or k.shape[2] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if group < 1 or bhq != k.shape[0] * group:
        raise ValueError(f"BHq {bhq} != BHkv {k.shape[0]} x group {group}")
    padded_head_dim(hd)
    if not 1 <= bhq <= 65535 or q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)} "
                         "outside the kernel's range")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}, expected {q.device} (CUDA)")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 "
                            "or bfloat16, one type for q, k and v")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (cp.async)")


def padded_head_dim(hd: int) -> int:
    """The instantiation a head dim runs on: the least of `HEAD_DIMS` not
    below it.  Raises above the largest."""
    for width in HEAD_DIMS:
        if 1 <= hd <= width:
            return width
    raise ValueError(f"head_dim {hd} outside 1..{HEAD_DIMS[-1]}: the flash "
                     f"kernel's largest instantiation is {HEAD_DIMS[-1]}")


def bwd_head_dim(hd: int) -> int:
    """The backward's instantiation for a head dim, as the forward pads
    it; above the backward's largest it raises."""
    if hd > BWD_HEAD_DIMS[-1]:
        raise ValueError(f"head_dim {hd}: the flash backward's largest "
                         f"instantiation is {BWD_HEAD_DIMS[-1]} (ROADMAP "
                         "Queue 1 item 6b)")
    return padded_head_dim(hd)


def bwd_kv_splits(dtype: torch.dtype, width: int, bhkv: int, sk: int,
                  group: int) -> int:
    """Parts each KV head's group of query heads is cut into for the
    backward's dK/dV pass: 1, except for bf16 at hd 256 (two warpgroups
    a block, one block an SM), where it is the least number of parts that
    gives `BWD_FILL_BLOCKS` blocks of 64 keys, at most one a head.  The
    first ``group % parts`` parts take one head more; their f32 sums are
    added in part order and rounded once."""
    if dtype != torch.bfloat16 or width != 256:
        return 1
    blocks = bhkv * -(-sk // 64)
    return min(group, math.ceil(BWD_FILL_BLOCKS / blocks))


def flash_attention_fwd(
    q: torch.Tensor,   # (BHq, Sq, hd), heads folded
    k: torch.Tensor,   # (BHkv, Sk, hd)
    v: torch.Tensor,
    group: int,        # Hq // Hkv: q row bh reads kv row bh // group
    causal: bool,
    window: int,
    return_lse: bool = False,
):
    """Attention on the card; returns o (BHq, Sq, hd) in q's dtype, and
    with `return_lse` also each row's f32 logsumexp of its scaled, masked
    scores, lse (BHq, Sq)."""
    _check(q, k, v, group)
    lib = library()
    bhq, sq, hd = q.shape
    width = padded_head_dim(hd)
    dtype = q.dtype
    with torch.cuda.device(q.device):
        if width not in WGMMA_HEAD_DIMS:   # the f32 kernel alone
            q, k, v = (t.float() for t in (q, k, v))
        if width != hd:
            q, k, v = (F.pad(t, (0, width - hd)) for t in (q, k, v))
        o = torch.empty_like(q)
        lse = (torch.empty((bhq, sq), dtype=torch.float32, device=q.device)
               if return_lse else None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            DTYPES[q.dtype], bhq, sq, k.shape[1], width, group,
            int(bool(causal)), int(window), hd**-0.5, stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError_t {err}")
    launch_counts[NAME] += 1
    o = o if width == hd else o[..., :hd]
    o = o.to(dtype).contiguous()
    return (o, lse) if return_lse else o


def flash_attention_bwd(
    q: torch.Tensor,      # (BHq, Sq, hd), heads folded
    k: torch.Tensor,      # (BHkv, Sk, hd)
    v: torch.Tensor,
    o: torch.Tensor,      # (BHq, Sq, hd): the forward's output
    do: torch.Tensor,     # (BHq, Sq, hd): the loss's gradient by o
    lse: torch.Tensor,    # (BHq, Sq) f32: the forward's logsumexp
    group: int,
    causal: bool,
    window: int,
):
    """dq, dk, dv on the card, each in q's dtype and shape, for the
    forward `flash_attention_fwd(q, k, v, group, causal, window)`."""
    _check(q, k, v, group)
    bhq, sq, hd = q.shape
    width = bwd_head_dim(hd)
    for name, t in (("o", o), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {q.dtype} tensor "
                             f"of q's shape {tuple(q.shape)} on {q.device}")
    if do.dtype == torch.bfloat16 and do.data_ptr() % 16:
        raise ValueError("do must start on 16 bytes (cp.async)")
    if (lse.shape != (bhq, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 ({bhq}, {sq}) "
                         f"tensor on {q.device}")
    lib = bwd_library()
    with torch.cuda.device(q.device):
        if width != hd:
            q, k, v, o, do = (F.pad(t, (0, width - hd))
                              for t in (q, k, v, o, do))
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        dsum = torch.empty((bhq, sq), dtype=torch.float32, device=q.device)
        splits = bwd_kv_splits(q.dtype, width, k.shape[0], k.shape[1], group)
        partial = (torch.empty((splits, 2, *k.shape), dtype=torch.float32,
                               device=q.device) if splits > 1 else None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            None if partial is None else partial.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), DTYPES[q.dtype], bhq, sq,
            k.shape[1], width, group, splits, int(bool(causal)), int(window),
            hd**-0.5, stream)
    if err:
        raise RuntimeError(
            f"flash_attention_bwd launch failed: cudaError_t {err}")
    launch_counts[BWD_NAME] += 1
    if width != hd:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


def wgmma_probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                p: torch.Tensor) -> tuple:
    """The bf16 kernel's two tile products alone, through its loads,
    descriptors and fragment layouts: ``s = q @ k.T`` (64, 64) and
    ``o = p @ v`` (64, hd), both f32, from bf16 q, k, v (64, hd) and
    p (64, 64) on the card."""
    hd = q.shape[-1]
    if hd not in WGMMA_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {WGMMA_HEAD_DIMS}")
    for name, t, shape in (("q", q, (64, hd)), ("k", k, (64, hd)),
                           ("v", v, (64, hd)), ("p", p, (64, 64))):
        if (tuple(t.shape) != shape or t.dtype != torch.bfloat16
                or t.device.type != "cuda" or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, aligned bf16 "
                             f"CUDA tensor of shape {shape}")
    lib = library()
    with torch.cuda.device(q.device):
        s = torch.empty((64, 64), dtype=torch.float32, device=q.device)
        o = torch.empty((64, hd), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_wgmma_probe_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
            s.data_ptr(), o.data_ptr(), hd, stream)
    if err:
        raise RuntimeError(f"wgmma probe launch failed: cudaError_t {err}")
    launch_counts["flash_wgmma_probe"] += 1
    return s, o
