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
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import build_library, launch_counts

NAME = "mamba_scan"
SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32      # 16 lanes of 2 states a channel (csrc/mamba_scan.cu)

_lib = None


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
