"""ctypes binding of the Hopper rotor slice kernel (``csrc/rotor_slice.cu``).

The CUDA source replaces the TPU kernel
``repro/kernels/rotor_slice/kernel.py::_kernel``; its header states the
bound and the design.  The library is built at first use (see
`repro_torch.kernels.build_library`).  The wrapper checks what it is
given, allocates the outputs and the scratch with `torch.empty`,
launches both passes on the current stream without synchronising, and
raises on a non-zero ``cudaError_t``.  Pass B's strip width is
`strip_width` of N alone.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import build_library, launch_counts

SOURCE = Path(__file__).resolve().parent / "csrc" / "rotor_slice.cu"
MAX_RACKS = 6144  # pass B at its narrowest strip (T 8) fits up to here
MAX_SLOTS = 64  # kMaxU in the source; the launch refuses more
STRIP_WIDTHS = (32, 16, 8)  # pass B's instantiations, widest first
SMEM_BYTES = 227 * 1024 - 1024  # kMaxSmem less 1 KB in the source


def _cols_smem(n: int, t: int, u: int) -> int:
    """Pass B's shared memory with vlb (`cols_smem` in the source): the
    (N, T) f32 strip of take, a list head per row, 8 bytes a live cell."""
    return n * t * 4 + n * 4 + t * u * 8


_lib = None


def strip_width(n: int) -> int:
    """Pass B's strip width T for N racks: the widest whose shared memory
    fits `SMEM_BYTES` at any u (32 at N = 1024, 8 at N = 6144)."""
    for t in STRIP_WIDTHS:
        if _cols_smem(n, t, MAX_SLOTS) <= SMEM_BYTES:
            return t
    raise ValueError(f"N = {n}: no strip width fits shared memory")


def library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = build_library("rotor_slice", [SOURCE])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rotor_slice_launch.argtypes = [
            ptr, ptr, ptr, i32, i32, i32, i32, i32,
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ]
        lib.rotor_slice_launch.restype = i32
        _lib = lib
    return _lib


def _check(own: torch.Tensor, relay: torch.Tensor, dst: torch.Tensor) -> None:
    if own.dim() != 3 or own.shape[1] != own.shape[2]:
        raise ValueError(f"own must be (B, N, N), got {tuple(own.shape)}")
    bsz, n = own.shape[0], own.shape[1]
    if relay.shape != own.shape:
        raise ValueError(f"relay {tuple(relay.shape)} != own {tuple(own.shape)}")
    if dst.dim() != 2 or dst.shape[0] != n:
        raise ValueError(f"dst must be (N={n}, u), got {tuple(dst.shape)}")
    if not 1 <= dst.shape[1] <= MAX_SLOTS:
        raise ValueError(f"u = {dst.shape[1]} outside 1..{MAX_SLOTS}")
    if not 1 <= n <= MAX_RACKS or bsz < 1 or bsz > 65535:
        raise ValueError(f"B = {bsz}, N = {n} outside the kernel's range")
    for name, t, dtype in (("own", own, torch.float32),
                           ("relay", relay, torch.float32),
                           ("dst", dst, torch.int32)):
        if t.device != own.device or t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}, expected {own.device} (CUDA)")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rotor_slice_fwd(
    own: torch.Tensor,     # (B, N, N) f32, CUDA
    relay: torch.Tensor,   # (B, N, N) f32, CUDA
    dst: torch.Tensor,     # (N, u) int32, CUDA, sentinel N
    vlb: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One slice on the card; returns (own, relay, delivered, moved)."""
    _check(own, relay, dst)
    lib = library()
    bsz, n, u = own.shape[0], own.shape[1], dst.shape[1]
    with torch.cuda.device(own.device):
        own_out = torch.empty_like(own)
        relay_out = torch.empty_like(relay)
        totals = torch.empty((2, bsz), dtype=own.dtype, device=own.device)
        # One scratch allocation, in f32 words: W as (weight, partner row)
        # pairs (B, N, u, 2) first, for 8-byte alignment, then the slot
        # masks (B, N) u64, send_relay (B, N, u), frac and the three row
        # partials (4, B, N), and the spreading-row counts (B,) int32.
        edge, rows = bsz * n * u, bsz * n
        scratch = torch.empty(3 * edge + 6 * rows + bsz, dtype=torch.float32,
                              device=own.device)
        base = scratch.data_ptr()
        at = [base + 4 * w for w in (0, 2 * edge, 2 * edge + 2 * rows,
                                     3 * edge + 2 * rows, 3 * edge + 3 * rows,
                                     3 * edge + 6 * rows)]
        stream = torch.cuda.current_stream(own.device).cuda_stream
        err = lib.rotor_slice_launch(
            own.data_ptr(), relay.data_ptr(), dst.data_ptr(),
            bsz, n, u, int(bool(vlb)), strip_width(n),
            own_out.data_ptr(), relay_out.data_ptr(),
            totals[0].data_ptr(), totals[1].data_ptr(), at[2], at[0], at[1],
            at[3], at[4], at[5],
            stream)
    if err:
        raise RuntimeError(f"rotor_slice launch failed: cudaError_t {err}")
    launch_counts["rotor_slice"] += 1
    return own_out, relay_out, totals[0], totals[1]
