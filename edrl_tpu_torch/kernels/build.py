"""Build and load the package's CUDA kernels.

The sources in ``csrc/`` compile with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, which ``ctypes`` loads.  The build happens
at first use, into ``build/edrl_tpu_torch/`` at the root of the checkout, and
is reused until a hash of the sources and flags changes.  Nothing here runs
at import time: a machine without ``nvcc`` can import the package, and only
a call that needs a kernel fails, with :class:`KernelBuildError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "edrl_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else ``$CUDA_HOME/bin`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = cuda_home / "bin" / "nvcc"
    if candidate.is_file() and os.access(candidate, os.X_OK):
        return str(candidate)
    raise KernelBuildError(
        "nvcc not found on PATH or in $CUDA_HOME/bin "
        f"(CUDA_HOME={cuda_home}); the CUDA kernels of edrl_tpu_torch need "
        "the CUDA toolkit to build"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    """Hash of the kernel sources and compiler flags, which names the library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels unless a library for these sources exists.

    Returns the library's path.  The compiler's report (``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept beside it in a
    ``.log`` file.
    """
    out = build_dir / f"libedrl_tpu_torch_{source_hash()}.so"
    if out.exists():
        return out
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cu_files = [str(p) for p in _sources() if p.suffix == ".cu"]
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *cu_files]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.edrl_attention_smem_bytes.argtypes = [i32, i32]
    lib.edrl_attention_smem_bytes.restype = ctypes.c_longlong
    lib.edrl_self_attention_fwd.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32, i32, ptr,
    ]
    lib.edrl_self_attention_fwd.restype = i32
    lib.edrl_window_attention_v2_fwd.argtypes = [
        ptr, ptr, ptr, i32, i32, i32, i32, i32, f32, i32, ptr,
    ]
    lib.edrl_window_attention_v2_fwd.restype = i32
    return lib


_LIB: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on the first call in this process."""
    global _LIB
    if _LIB is None:
        _LIB = _bind(ctypes.CDLL(str(build_library())))
    return _LIB
