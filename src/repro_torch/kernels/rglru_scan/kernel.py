"""ctypes binding of the Hopper RG-LRU scan kernel
(``csrc/rglru_scan.cu``).

The CUDA source replaces the TPU kernel
``repro/kernels/rglru_scan/kernel.py::_kernel``; its header states the
bound and the design.  The library is built at first use (see
`repro_torch.kernels.build_library`).  The wrapper checks what it is
given, allocates the output and the kernel's (B, ceil(S / chunk), 2, D)
float32 scratch of chunk ends with `torch.empty`, launches the three
passes (``rglru_chunk_ends``, ``rglru_chunk_carry``, ``rglru_chunk_scan``;
one call, counted once) on the current stream without synchronising, and
raises on a non-zero ``cudaError_t``.
``a`` and ``bx`` come in one type, float32 (the model's gates) or
bfloat16; ``h0`` is float32.  Nothing is cast.

`rglru_scan_bwd` binds the backward (``csrc/rglru_scan_bwd.cu``, a
library of its own): da, dbx and dh0 from a, the forward's states, h0
and the states' gradient, in one kernel over tiles of `BWD_CHUNK` steps
and `BWD_CHANNELS` channels that walk the forward's chunks from the end
and hand their carries on by a look-back, counted once under
``rglru_scan_bwd``.  `bwd_tiling` reads the tiling from the library,
which must agree with these constants.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import build_library, launch_counts

NAME = "rglru_scan"
SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
BWD_NAME = "rglru_scan_bwd"
BWD_SOURCE = SOURCE.with_name("rglru_scan_bwd.cu")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_CHUNK = 32        # steps a tile of the backward
BWD_CHANNELS = 128    # channels a tile of the backward

_lib = None
_bwd_lib = None


def library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = build_library(NAME, [SOURCE])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                          i32, i32, ptr]
        lib.rglru_scan_launch.restype = i32
        lib.rglru_scan_scratch_floats.argtypes = [i32, i32, i32]
        lib.rglru_scan_scratch_floats.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def bwd_library() -> ctypes.CDLL:
    """Build (once per source content) and load the backward's library."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = build_library(BWD_NAME, [BWD_SOURCE])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan_bwd_launch.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        lib.rglru_scan_bwd_launch.restype = i32
        lib.rglru_scan_bwd_scratch_floats.argtypes = [i32, i32, i32]
        lib.rglru_scan_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.rglru_scan_bwd_tiling.argtypes = [ptr]
        lib.rglru_scan_bwd_tiling.restype = None
        got, want = _tiling(lib), (BWD_CHUNK, BWD_CHANNELS)
        if got != want:
            raise RuntimeError(f"rglru_scan_bwd.cu's tiling is {got} (steps, "
                               f"channels), kernel.py's {want}")
        _bwd_lib = lib
    return _bwd_lib


def _tiling(lib: ctypes.CDLL) -> Tuple[int, int]:
    out = (ctypes.c_int * 2)()
    lib.rglru_scan_bwd_tiling(out)
    return tuple(out)


def bwd_tiling() -> Tuple[int, int]:
    """The backward library's tiling: the steps and channels of a tile."""
    return _tiling(bwd_library())


def _check(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor) -> None:
    if a.dim() != 3 or h0.dim() != 2:
        raise ValueError("a, bx must be (B, S, D), h0 (B, D)")
    bsz, s, d = a.shape
    if bx.shape != a.shape or h0.shape != (bsz, d):
        raise ValueError(f"bx {tuple(bx.shape)} / h0 {tuple(h0.shape)} do "
                         f"not fit a {tuple(a.shape)}")
    if not (1 <= bsz <= 65535 and s >= 1 and d >= 1):
        raise ValueError(f"B={bsz}, S={s}, D={d} outside the kernel's range")
    for name, t, types in (("a", a, DTYPES), ("bx", bx, (a.dtype,)),
                           ("h0", h0, (torch.float32,))):
        if t.device != a.device or t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}, expected {a.device} (CUDA)")
        if t.dtype not in types:
            raise TypeError(f"{name} is {t.dtype}; a and bx take float32 or "
                            "bfloat16, one type for both, h0 float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rglru_scan_fwd(a: torch.Tensor, bx: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """The recurrence on the card; returns every h_t, (B, S, D) float32."""
    _check(a, bx, h0)
    lib = library()
    bsz, s, d = a.shape
    with torch.cuda.device(a.device):
        out = torch.empty((bsz, s, d), dtype=torch.float32, device=a.device)
        ends = torch.empty(lib.rglru_scan_scratch_floats(bsz, s, d),
                           dtype=torch.float32, device=a.device)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_launch(a.data_ptr(), bx.data_ptr(), h0.data_ptr(),
                                    ends.data_ptr(), out.data_ptr(),
                                    DTYPES[a.dtype], bsz, s, d, stream)
    if err:
        raise RuntimeError(f"rglru_scan launch failed: cudaError_t {err}")
    launch_counts[NAME] += 1
    return out


def rglru_scan_bwd(a: torch.Tensor, hs: torch.Tensor, h0: torch.Tensor,
                   dhs: torch.Tensor):
    """The backward on the card: (da, dbx) in a's dtype and dh0 (B, D)
    float32 from a (B, S, D), the forward's states hs (B, S, D) float32,
    h0 and the states' gradient dhs (B, S, D) float32.  The kernel's
    float32 scratch (status words, chunk aggregates and carries) comes
    from `torch.empty`; the library zeroes its status words itself."""
    _check(a, a, h0)
    for name, t in (("hs", hs), ("dhs", dhs)):
        if t.shape != a.shape or t.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: expected "
                             f"{tuple(a.shape)} float32")
        if t.device != a.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {a.device}")
    lib = bwd_library()
    bsz, s, d = a.shape
    with torch.cuda.device(a.device):
        da = torch.empty_like(a)
        dbx = torch.empty_like(a)
        dh0 = torch.empty((bsz, d), dtype=torch.float32, device=a.device)
        scratch = torch.empty(lib.rglru_scan_bwd_scratch_floats(bsz, s, d),
                              dtype=torch.float32, device=a.device)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_bwd_launch(
            a.data_ptr(), hs.data_ptr(), h0.data_ptr(), dhs.data_ptr(),
            scratch.data_ptr(), da.data_ptr(), dbx.data_ptr(), dh0.data_ptr(),
            DTYPES[a.dtype], bsz, s, d, stream)
    if err:
        raise RuntimeError(f"rglru_scan_bwd launch failed: cudaError_t {err}")
    launch_counts[BWD_NAME] += 1
    return da, dbx, dh0
