"""ctypes binding of the Hopper grouped expert-FFN kernel
(``csrc/moe_gmm.cu``).

The CUDA source replaces the TPU kernel
``repro/kernels/moe_gmm/kernel.py::_kernel``; its header states the
bound and the design.  The library is built at first use (see
`repro_torch.kernels.build_library`).  The wrapper checks what it is
given, allocates the output with `torch.empty`, launches on the current
stream without synchronising, and raises on a non-zero ``cudaError_t``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build_library, launch_counts

NAME = "moe_gmm"
SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 8            # kBC in the source: h rows held per block
SMEM_BYTES = 227 * 1024

_lib = None


def library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = build_library(NAME, [SOURCE])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.moe_gmm_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr,
        ]
        lib.moe_gmm_launch.restype = i32
        _lib = lib
    return _lib


def _check(h, wg, wu, wd) -> None:
    if h.dim() != 3 or wg.dim() != 3 or wu.dim() != 3 or wd.dim() != 3:
        raise ValueError("h must be (E, C, D), wg/wu (E, D, F), wd (E, F, D)")
    e, c, d = h.shape
    f = wg.shape[2]
    if wg.shape != (e, d, f) or wu.shape != (e, d, f) or wd.shape != (e, f, d):
        raise ValueError(f"weights {tuple(wg.shape)}, {tuple(wu.shape)}, "
                         f"{tuple(wd.shape)} do not fit h {tuple(h.shape)}")
    if not (1 <= e <= 65535 and c >= 1 and f >= 1
            and 4 * ROWS * (d + 256) <= SMEM_BYTES):
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
                wd: torch.Tensor) -> torch.Tensor:
    """The expert FFN on the card; returns (E, C, D) in h's dtype."""
    _check(h, wg, wu, wd)
    lib = library()
    e, c, d = h.shape
    with torch.cuda.device(h.device):
        out = torch.empty_like(h)
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.moe_gmm_launch(
            h.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            out.data_ptr(), DTYPES[h.dtype], e, c, d, wg.shape[2], stream)
    if err:
        raise RuntimeError(f"moe_gmm launch failed: cudaError_t {err}")
    launch_counts[NAME] += 1
    return out
