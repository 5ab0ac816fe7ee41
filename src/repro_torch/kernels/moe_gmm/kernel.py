"""ctypes binding of the Hopper grouped expert-FFN kernel
(``csrc/moe_gmm.cu``).

The CUDA source replaces the TPU kernel
``repro/kernels/moe_gmm/kernel.py::_kernel``; its header states the
bound and the design: two passes, ``moe_gmm_gate_up`` into an f32
activation scratch and ``moe_gmm_down``, launched together by one call.
The library is built at first use (see
`repro_torch.kernels.build_library`).  `plan` gives the grid and the
load width from the shapes alone; the wrapper checks what
it is given, allocates the scratch and the output with `torch.empty`,
launches on the current stream without synchronising, counts one launch
and raises on a non-zero ``cudaError_t``.  The gate's activation
(``ref.ACTS``: silu, gelu, relu) is a template argument of the first pass
and of the backward's activation pass, chosen at launch.

`moe_gmm_bwd` binds the backward (``csrc/moe_gmm_bwd.cu`` with
``csrc/moe_wgmma.cuh``, a library of its own): dh, dWg, dWu and dWd from
h, the weights and the output's gradient, counted once a call under
``moe_gmm_bwd``.  bf16 runs four launches on the tensor cores (wgmma,
f32 sums; A, dG and dU rounded to bf16 in a bf16 scratch), f32 five of
tiled f32 products on the CUDA cores (an f32 scratch).
`moe_wgmma_probe` runs the bf16 kernels' tile products alone.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import build_library, launch_counts
from repro_torch.kernels.moe_gmm.ref import check_act

NAME = "moe_gmm"
SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm.cu"
BWD_NAME = "moe_gmm_bwd"
BWD_SOURCE = SOURCE.with_name("moe_gmm_bwd.cu")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The source's tiling: kWarps warps of 32 lanes, kLanesX lanes across a
# weight row (16-byte loads each), so 32 / kLanesX slices of the summed
# dimension a warp; pass 1 runs half the warps on Wg, half on Wu.
WARPS = 8
LANES_X = 16
LOAD_BYTES = 16

_lib = None
_bwd_lib = None


class Plan(NamedTuple):
    rows: int            # capacity rows a block holds (R in the source)
    row_tiles: int       # ceil(C / rows): weight reads per column tile
    vec_gate_up: bool    # 16-byte loads of Wg, Wu (rows a whole number)
    vec_down: bool       # 16-byte loads of Wd
    gate_up_blocks: int  # blocks of each pass
    down_blocks: int


def plan(E: int, C: int, D: int, F: int, dtype: torch.dtype) -> Plan:
    """How the kernel runs (E, C, D, F) in `dtype`.  Rows a block: 8
    where that pads C to no more rows than 4 would (C 5-8, 13-16, ...:
    each weight load then feeds twice the rows), else 4 (decode's C 4,
    and C 9-12, 17-20, ...); ceil(C / rows) row tiles.  Each block is
    LANES_X 16-byte loads wide, with vector loads only where a weight row
    is a whole number of them (the wrapper also needs the weights on 16
    bytes)."""
    per_load = LOAD_BYTES // dtype.itemsize
    rows = 8 if C > 4 and -(-C // 4) == 2 * -(-C // 8) else 4
    tiles = -(-C // rows)
    cols = LANES_X * per_load
    return Plan(rows=rows, row_tiles=tiles,
                vec_gate_up=F % per_load == 0, vec_down=D % per_load == 0,
                gate_up_blocks=E * tiles * -(-F // cols),
                down_blocks=E * tiles * -(-D // cols))


def library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = build_library(NAME, [SOURCE])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.moe_gmm_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
            i32, i32, ptr,
        ]
        lib.moe_gmm_launch.restype = i32
        _lib = lib
    return _lib


def bwd_library() -> ctypes.CDLL:
    """Build (once per source content) and load the backward's library."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = build_library(BWD_NAME, [BWD_SOURCE])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.moe_gmm_bwd_launch.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
        lib.moe_gmm_bwd_launch.restype = i32
        lib.moe_wgmma_probe.argtypes = [ptr, ptr, ptr, i32, ptr]
        lib.moe_wgmma_probe.restype = i32
        _bwd_lib = lib
    return _bwd_lib


def _check(h, wg, wu, wd) -> None:
    if h.dim() != 3 or wg.dim() != 3 or wu.dim() != 3 or wd.dim() != 3:
        raise ValueError("h must be (E, C, D), wg/wu (E, D, F), wd (E, F, D)")
    e, c, d = h.shape
    f = wg.shape[2]
    if wg.shape != (e, d, f) or wu.shape != (e, d, f) or wd.shape != (e, f, d):
        raise ValueError(f"weights {tuple(wg.shape)}, {tuple(wu.shape)}, "
                         f"{tuple(wd.shape)} do not fit h {tuple(h.shape)}")
    if not (1 <= e <= 65535 and c >= 1 and d >= 1 and f >= 1):
        raise ValueError(f"E={e}, C={c}, D={d}, F={f} outside the kernel's range")
    for name, t in (("h", h), ("wg", wg), ("wu", wu), ("wd", wd)):
        if t.device != h.device or t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}, expected {h.device} (CUDA)")
        if t.dtype not in DTYPES or t.dtype != h.dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 "
                            "or bfloat16, one type for h and the weights")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def moe_gmm_fwd(h: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """The expert FFN with the gate's activation `act` (``ACTS``) on the
    card; returns (E, C, D) in h's dtype."""
    activation = check_act(act)
    _check(h, wg, wu, wd)
    lib = library()
    e, c, d = h.shape
    f = wg.shape[2]
    p = plan(e, c, d, f, h.dtype)
    vec_gate_up = p.vec_gate_up and not (wg.data_ptr() % LOAD_BYTES
                                         or wu.data_ptr() % LOAD_BYTES)
    vec_down = p.vec_down and not wd.data_ptr() % LOAD_BYTES
    with torch.cuda.device(h.device):
        act = torch.empty((e, c, f), dtype=torch.float32, device=h.device)
        out = torch.empty_like(h)
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.moe_gmm_launch(
            h.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            act.data_ptr(), out.data_ptr(), DTYPES[h.dtype], activation,
            p.rows,
            int(vec_gate_up), int(vec_down), e, c, d, f, stream)
    if err:
        raise RuntimeError(f"moe_gmm launch failed: cudaError_t {err}")
    launch_counts[NAME] += 1
    return out


def moe_gmm_bwd(h: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor, dout: torch.Tensor, act: str = "silu"):
    """The backward on the card: (dh (E, C, D), dwg, dwu (E, D, F), dwd
    (E, F, D)) in h's dtype from the forward's inputs, its activation
    `act` and the output's gradient dout (E, C, D), of h's dtype."""
    activation = check_act(act)
    _check(h, wg, wu, wd)
    if dout.shape != h.shape or dout.dtype != h.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype}: expected "
                         f"{tuple(h.shape)} {h.dtype}")
    if dout.device != h.device or not dout.is_contiguous():
        raise ValueError(f"dout must be contiguous on {h.device}")
    lib = bwd_library()
    e, c, d = h.shape
    f = wg.shape[2]
    with torch.cuda.device(h.device):
        scratch = torch.empty(3 * e * c * f, dtype=h.dtype, device=h.device)
        dh = torch.empty_like(h)
        dwg, dwu, dwd = (torch.empty_like(w) for w in (wg, wu, wd))
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.moe_gmm_bwd_launch(
            h.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            dout.data_ptr(), scratch.data_ptr(), dh.data_ptr(),
            dwg.data_ptr(), dwu.data_ptr(), dwd.data_ptr(), DTYPES[h.dtype],
            activation, e, c, d, f, stream)
    if err:
        raise RuntimeError(f"moe_gmm_bwd launch failed: cudaError_t {err}")
    launch_counts[BWD_NAME] += 1
    return dh, dwg, dwu, dwd


def moe_wgmma_probe(x: torch.Tensor, y: torch.Tensor,
                    vec: bool = True) -> torch.Tensor:
    """The bf16 backward's tile products alone, through its atom loads
    (16-byte copies if `vec`, else element loads), descriptors and wgmma:
    (3, 64, 64) f32 ``x @ y``, ``x @ y.T`` and ``x.T @ y`` from bf16 x, y
    (64, 64) on the card, the three operand orientations its passes use."""
    for name, t in (("x", x), ("y", y)):
        if (tuple(t.shape) != (64, 64) or t.dtype != torch.bfloat16
                or t.device.type != "cuda" or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, aligned bf16 "
                             "CUDA tensor of shape (64, 64)")
    lib = bwd_library()
    with torch.cuda.device(x.device):
        out = torch.empty((3, 64, 64), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_wgmma_probe(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                                  int(vec), stream)
    if err:
        raise RuntimeError(f"moe wgmma probe launch failed: cudaError_t {err}")
    launch_counts["moe_wgmma_probe"] += 1
    return out
