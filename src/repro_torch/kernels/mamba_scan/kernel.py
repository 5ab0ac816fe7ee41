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

`mamba_scan_fwd(..., states=True)` also returns the forward's chunk
states, the state before every `STATE_CHUNK` steps, which the backward
reads; serving does not ask for them.  `mamba_scan_bwd` binds the
backward (``csrc/mamba_scan_bwd.cu``, a library of its own): the six
inputs' gradients from the forward's inputs, its chunk states, y's
gradient and h_S's, four kernels (`BWD_PASSES`: a local pass and a carry
pass over `BWD_CHUNK`-step chunks, the main pass over spans of `BWD_SPAN`
chunks and the sum of the blocks' partials) counted once under
``mamba_scan_bwd``.  `bwd_tiling` reads the tiling from the library,
which must agree with these constants.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build_library, launch_counts
from repro_torch.kernels.mamba_scan.ref import STATE_CHUNK

NAME = "mamba_scan"
SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
BWD_NAME = "mamba_scan_bwd"
BWD_SOURCE = SOURCE.with_name("mamba_scan_bwd.cu")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32      # 16 lanes of 2 states a channel (csrc/mamba_scan.cu)
# the backward's kernels, by the names the profiler shows
BWD_PASSES = ("mamba_scan_bwd_local", "mamba_scan_bwd_carry",
              "mamba_scan_bwd_main", "mamba_scan_bwd_sum")
BWD_CHUNK = 64      # steps a chunk of the backward's passes
BWD_SPAN = 2        # chunks a main-pass block walks


def bwd_channels(n: int) -> int:
    """Channels a block of the backward's passes at state size `n`."""
    return 64 if n <= 16 else 32

_lib = None
_bwd_lib = None


def library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = build_library(NAME, [SOURCE])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mamba_scan_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
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
        lib.mamba_scan_bwd_launch.argtypes = [ptr] * 16 + [i32] * 6 + [ptr]
        lib.mamba_scan_bwd_launch.restype = i32
        lib.mamba_scan_bwd_scratch_floats.argtypes = [i32] * 4
        lib.mamba_scan_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.mamba_scan_bwd_occupancy.argtypes = [i32, i32, i32, ptr]
        lib.mamba_scan_bwd_occupancy.restype = i32
        lib.mamba_scan_bwd_tiling.argtypes = [i32, ptr]
        lib.mamba_scan_bwd_tiling.restype = None
        for n in (16, MAX_STATE):
            got = _tiling(lib, n)
            want = (STATE_CHUNK, BWD_CHUNK, BWD_SPAN, bwd_channels(n))
            if got != want:
                raise RuntimeError(
                    f"mamba_scan_bwd.cu's tiling at N {n} is {got} (state "
                    f"steps, chunk, span, channels), kernel.py's {want}")
        _bwd_lib = lib
    return _bwd_lib


def _tiling(lib: ctypes.CDLL, n: int) -> Tuple[int, int, int, int]:
    out = (ctypes.c_int * 4)()
    lib.mamba_scan_bwd_tiling(n, out)
    return tuple(out)


def bwd_tiling(n: int) -> Tuple[int, int, int, int]:
    """The backward library's tiling at state size `n`: the steps between
    the saved states it reads, the steps of a chunk, the chunks a
    main-pass block walks and the channels a block."""
    return _tiling(bwd_library(), n)


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


def state_shape(x: torch.Tensor, A: torch.Tensor) -> Tuple[int, ...]:
    """(B, ceil(S / STATE_CHUNK), D, N): the forward's chunk states."""
    bsz, s, d = x.shape
    return (bsz, -(-s // STATE_CHUNK), d, A.shape[1])


def mamba_scan_fwd(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   states: bool = False) -> Tuple[torch.Tensor, ...]:
    """The selective scan on the card; returns (y (B, S, D), h_S
    (B, D, N)), both float32, and with `states` the chunk states
    (`state_shape`, float32) too."""
    _check(x, dt, Bm, Cm, A, D)
    lib = library()
    bsz, s, d = x.shape
    n = A.shape[1]
    with torch.cuda.device(x.device):
        y = torch.empty((bsz, s, d), dtype=torch.float32, device=x.device)
        h = torch.empty((bsz, d, n), dtype=torch.float32, device=x.device)
        kept = torch.empty(state_shape(x, A), dtype=torch.float32,
                           device=x.device) if states else None
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mamba_scan_launch(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(),
            None if kept is None else kept.data_ptr(),
            DTYPES[x.dtype], DTYPES[dt.dtype], bsz, s, d, n, stream)
    if err:
        raise RuntimeError(f"mamba_scan launch failed: cudaError_t {err}")
    launch_counts[NAME] += 1
    return (y, h, kept) if states else (y, h)


def bwd_occupancy(x_dtype: torch.dtype, p_dtype: torch.dtype,
                  n: int) -> dict:
    """Resident blocks an SM of each of the backward's passes for these
    types and N (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = (ctypes.c_int * len(BWD_PASSES))()
    err = bwd_library().mamba_scan_bwd_occupancy(
        DTYPES[x_dtype], DTYPES[p_dtype], n, blocks)
    if err:
        raise RuntimeError(f"mamba_scan_bwd occupancy: cudaError_t {err}")
    return dict(zip(BWD_PASSES, blocks))


def mamba_scan_bwd(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   dy: torch.Tensor, dhS: Optional[torch.Tensor],
                   states: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The backward on the card: (dx in x's dtype; ddt, dBm, dCm in dt's;
    dA (D, N), dD (D,) float32) from the forward's inputs, y's gradient dy
    (B, S, D) float32, h_S's, dhS (B, D, N) float32 (None: zero), and the
    forward's chunk states (`mamba_scan_fwd(..., states=True)`)."""
    _check(x, dt, Bm, Cm, A, D)
    bsz, s, d = x.shape
    n = A.shape[1]
    if states is None:
        raise ValueError("the backward reads the forward's chunk states: "
                         "mamba_scan_fwd(..., states=True)")
    for name, t, shape in (("dy", dy, (bsz, s, d)), ("dhS", dhS, (bsz, d, n)),
                           ("states", states, state_shape(x, A))):
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
            A.data_ptr(), D.data_ptr(), states.data_ptr(), dy.data_ptr(),
            None if dhS is None else dhS.data_ptr(), scratch.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dBm.data_ptr(), dCm.data_ptr(),
            dA.data_ptr(), dD.data_ptr(), DTYPES[x.dtype], DTYPES[dt.dtype],
            bsz, s, d, n, stream)
    if err:
        raise RuntimeError(f"mamba_scan_bwd launch failed: cudaError_t {err}")
    launch_counts[BWD_NAME] += 1
    return dx, ddt, dBm, dCm, dA, dD
