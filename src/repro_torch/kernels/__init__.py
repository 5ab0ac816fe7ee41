"""Hand-written Hopper kernels, their build helper and dispatch.

Each kernel package keeps the reference's trio: ``kernel.py`` binds the
CUDA kernel, ``ref.py`` is the plain PyTorch version of the same
function, and ``ops.py`` picks between them by the device of the
tensors it is given (`pick`): a CPU tensor goes to the plain version,
a CUDA tensor launches the kernel (which raises on what it cannot
take).  Nothing falls back from the kernel to the plain version.  Where
autograd records (`records`), a CUDA tensor goes through the package's
`torch.autograd.Function`, whose forward launches the forward kernel and
whose backward launches the backward kernel; on the CPU autograd
differentiates the plain versions.

Kernels are compiled at first use from the sources in the package, with
``nvcc`` for ``sm_90a``, into ``build/`` at the repository root, and
loaded through `ctypes`.  Nothing is built or imported from a GPU
toolchain when a module is imported.

`launch_counts` counts kernel launches by name: each wrapper adds one
where it launches its kernel, and nowhere else, so a run can show that
its main path went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Sequence, Tuple

import torch

launch_counts: collections.Counter = collections.Counter()

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # the plain versions round a*b + c twice; keep nvcc from fusing it
    "-fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def pick(t: torch.Tensor, kernel: Callable, plain: Callable) -> Callable:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no kernel or plain version for device {t.device}")


def records(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on `tensors`: grad mode on and one
    of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def cuda_tool(name: str) -> str:
    """A CUDA toolkit program (``nvcc``, ``cuobjdump``) on PATH or under
    CUDA_HOME."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found on PATH or under CUDA_HOME")
    return path


def library_path(name: str, sources: Sequence[Path]) -> Path:
    """Where `build_library` puts `name`: keyed by the flags and the bytes
    of the sources and of the headers (``*.cuh``) beside them, which the
    sources include but nvcc is not given, so an edit to either builds a
    new library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted({hdr for src in sources
                      for hdr in Path(src).parent.glob("*.cuh")})
    for path in [*sources, *headers]:
        h.update(Path(path).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_libraries(specs: Sequence[Tuple[str, Sequence[Path]]]) -> list:
    """Compile each ``(name, sources)`` into a shared library with a plain
    C interface (unless this content was built before) and load them.
    One ``nvcc`` per library, all started together.  The compiler's
    report (registers, shared memory, spills) goes to ``<lib>.log``."""
    procs = []
    for name, sources in specs:
        out = library_path(name, sources)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp),
               *map(str, sources)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        out.with_suffix(".log").write_text(stdout + stderr)
        if proc.returncode:
            failed.append(f"nvcc failed to build {name} ({proc.returncode}):"
                          f"\n{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [ctypes.CDLL(str(library_path(name, sources)))
            for name, sources in specs]


def build_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """`build_libraries` for one library."""
    return build_libraries([(name, sources)])[0]
