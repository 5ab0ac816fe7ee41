"""ctypes binding of the Hopper selective-scan kernel
(``csrc/mamba_scan.cu``).

The CUDA source replaces the TPU kernel
``repro/kernels/mamba_scan/kernel.py::_kernel``; its header states the
bound and the design.  The library is built at first use (see
`repro_torch.kernels.build_library`).  The wrapper checks what it is
given, allocates the outputs with `torch.empty`, launches on the current
stream without synchronising, and raises on a non-zero ``cudaError_t``.

Types are taken as they come, nothing is cast: ``x`` in float32 or
bfloat16 (the model passes the compute dtype), ``dt``, ``Bm`` and
``Cm`` in one type, float32 or bfloat16 (the model passes float32,
ssm.py:54-55), ``A`` and ``D`` in float32.

`mamba_scan_bwd` binds the backward (``csrc/mamba_scan_bwd.cu``, a
library of its own): the six inputs' gradients from the forward's inputs,
y's gradient and h_S's, two kernels (``mamba_scan_bwd`` and
``mamba_scan_bwd_sum``, which adds the blocks' partial sums) counted once
under ``mamba_scan_bwd``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build_library, launch_counts

NAME = "mamba_scan"
SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
BWD_NAME = "mamba_scan_bwd"
BWD_SOURCE = SOURCE.with_name("mamba_scan_bwd.cu")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32      # 16 lanes of 2 states a channel (csrc/mamba_scan.cu)

_lib = None
_bwd_lib = None


def library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = build_library(NAME, [SOURCE])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mamba_scan_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, ptr,
        ]
        lib.mamba_scan_launch.restype = i32
        _lib = lib
    return _lib


def bwd_library() -> ctypes.CDLL:
    """Build (once per source content) and load the backward's library."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = build_library(BWD_NAME, [BWD_SOURCE])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mamba_scan_bwd_launch.argtypes = [ptr] * 15 + [i32] * 6 + [ptr]
        lib.mamba_scan_bwd_launch.restype = i32
        lib.mamba_scan_bwd_scratch_floats.argtypes = [i32] * 4
        lib.mamba_scan_bwd_scratch_floats.restype = ctypes.c_longlong
        _bwd_lib = lib
    return _bwd_lib


def _check(x, dt, Bm, Cm, A, D) -> None:
    if x.dim() != 3 or Bm.dim() != 3 or A.dim() != 2 or D.dim() != 1:
        raise ValueError("x, dt must be (B, S, D), Bm, Cm (B, S, N), "
                         "A (D, N), D (D,)")
    bsz, s, d = x.shape
    n = A.shape[1]
    if (dt.shape != x.shape or Bm.shape != (bsz, s, n) or Cm.shape != Bm.shape
            or A.shape != (d, n) or D.shape != (d,)):
        raise ValueError(f"dt {tuple(dt.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)} do not fit x {tuple(x.shape)}")
    if not (1 <= bsz <= 65535 and s >= 1 and d >= 1 and 1 <= n <= MAX_STATE):
        raise ValueError(f"B={bsz}, S={s}, D={d}, N={n} outside the "
                         "kernel's range")
    for name, t, types in (("x", x, DTYPES), ("dt", dt, DTYPES),
                           ("Bm", Bm, (dt.dtype,)), ("Cm", Cm, (dt.dtype,)),
                           ("A", A, (torch.float32,)),
                           ("D", D, (torch.float32,))):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}, expected {x.device} (CUDA)")
        if t.dtype not in types:
            raise TypeError(f"{name} is {t.dtype}; x and dt take float32 or "
                            "bfloat16, Bm and Cm dt's type, A and D float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def mamba_scan_fwd(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor,
                   D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan on the card; returns (y (B, S, D), h_S
    (B, D, N)), both float32."""
    _check(x, dt, Bm, Cm, A, D)
    lib = library()
    bsz, s, d = x.shape
    n = A.shape[1]
    with torch.cuda.device(x.device):
        y = torch.empty((bsz, s, d), dtype=torch.float32, device=x.device)
        h = torch.empty((bsz, d, n), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mamba_scan_launch(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(),
            DTYPES[x.dtype], DTYPES[dt.dtype], bsz, s, d, n, stream)
    if err:
        raise RuntimeError(f"mamba_scan launch failed: cudaError_t {err}")
    launch_counts[NAME] += 1
    return y, h


def mamba_scan_bwd(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   dy: torch.Tensor, dhS: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """The backward on the card: (dx in x's dtype; ddt, dBm, dCm in dt's;
    dA (D, N), dD (D,) float32) from the forward's inputs, y's gradient dy
    (B, S, D) float32 and h_S's, dhS (B, D, N) float32 (None: zero)."""
    _check(x, dt, Bm, Cm, A, D)
    bsz, s, d = x.shape
    n = A.shape[1]
    for name, t, shape in (("dy", dy, (bsz, s, d)), ("dhS", dhS, (bsz, d, n))):
        if t is None:
            continue
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: expected "
                             f"{shape} float32")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    lib = bwd_library()
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        ddt, dBm, dCm = (torch.empty_like(t) for t in (dt, Bm, Cm))
        dA = torch.empty_like(A)
        dD = torch.empty_like(D)
        scratch = torch.empty(lib.mamba_scan_bwd_scratch_floats(bsz, s, d, n),
                              dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mamba_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), D.data_ptr(), dy.data_ptr(),
            None if dhS is None else dhS.data_ptr(), scratch.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dBm.data_ptr(), dCm.data_ptr(),
            dA.data_ptr(), dD.data_ptr(), DTYPES[x.dtype], DTYPES[dt.dtype],
            bsz, s, d, n, stream)
    if err:
        raise RuntimeError(f"mamba_scan_bwd launch failed: cudaError_t {err}")
    launch_counts[BWD_NAME] += 1
    return dx, ddt, dBm, dCm, dA, dD
