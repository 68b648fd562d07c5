"""Build and load the package's CUDA kernels.

The sources in ``csrc/`` compile with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, which ``ctypes`` loads: one ``nvcc -c`` per
``.cu`` file, all started together, then one link.  The build happens at
first use, into ``build/edrl_tpu_torch/`` at the root of the checkout, and
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    obj_dir = build_dir / f"obj_{out.stem}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    cu_files = [p for p in _sources() if p.suffix == ".cu"]
    jobs = []
    for src in cu_files:
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj_dir / f"{src.stem}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        text, _ = proc.communicate()
        log.append(text)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
           *(str(obj_dir / f"{src.stem}.o") for src in cu_files)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc link failed with code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    shutil.rmtree(obj_dir, ignore_errors=True)
    out.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32, f32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    signatures = {
        # is_bf16, n, d, with_bias -> dynamic shared memory of the forward's route
        "edrl_attention_fwd_smem_bytes": (i64, [i32, i32, i32, i32]),
        # is_bf16, n, d -> 1 for the tensor-core route, 0 for the CUDA-core route
        "edrl_attention_fwd_route": (i32, [i32, i32, i32]),
        # is_bf16, n, d, with_bias, out[3]: blocks per SM, smem bytes, warps per block
        "edrl_attention_fwd_occupancy": (i32, [i32, i32, i32, i32, ptr]),
        "edrl_attention_bwd_smem_bytes": (i64, [i32, i32, i32]),
        # is_bf16, n, d -> 1 for the tensor-core route, 0 for the CUDA-core route
        "edrl_attention_bwd_route": (i32, [i32, i32, i32]),
        # is_bf16, n, d, with_dbias, out[4]: dq and dk/dv kernels' blocks per SM, then their smem bytes
        "edrl_attention_bwd_occupancy": (i32, [i32, i32, i32, i32, ptr]),
        "edrl_self_attention_fwd": (i32, [ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32, i32, ptr]),
        "edrl_window_attention_v2_fwd": (i32, [ptr, ptr, ptr, i32, i32, i32, i32, i32, f32, i32, ptr]),
        # q, k, v, dout, dq, dk, dv, stats, batch, n, c, heads, scale, is_bf16, stream
        "edrl_self_attention_bwd": (
            i32, [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32, i32, ptr]),
        # qkv, bias, dout, dqkv, dbias_partial, dbias, stats, batch, windows, n, c,
        # heads, batch_per_block, scale, is_bf16, stream
        "edrl_window_attention_v2_bwd": (
            i32, [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, i32, ptr]),
        "edrl_mk_mmd_scratch_floats": (i64, [i32, i32]),
        # source, target, n_s, n_t, d, kernel_mul, kernel_num, scratch, out, stream
        "edrl_mk_mmd_fwd": (i32, [ptr, ptr, i32, i32, i32, f32, i32, ptr, ptr, ptr]),
        # x, gamma, beta, y, m, c, eps, is_bf16, stream
        "edrl_layer_norm_fwd": (i32, [ptr, ptr, ptr, ptr, i32, i32, f32, i32, ptr]),
        # x, dy, gamma, dx, dgamma, dbeta, partial, m, c, blocks, eps, is_bf16, stream
        "edrl_layer_norm_bwd": (i32, [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, f32, i32, ptr]),
        # u_is_bf16, c, h -> 1 for the wgmma route, 0 for the mma.sync route, -1 refused
        "edrl_fused_mlp_route": (i32, [i32, i32, i32]),
        # out[7]: CTAs per SM and smem bytes of the forward's kernels (two products, fused
        # at C = 128), threads per CTA
        "edrl_fused_mlp_fwd_occupancy": (i32, [ptr]),
        # out[5]: hidden kernel CTAs per SM and smem; du and weight-gradient CTAs per SM; their smem
        "edrl_fused_mlp_bwd_occupancy": (i32, [ptr]),
        # u, w1, b1, w2, b2, y, wa, wb, act, m, c, h, u_is_bf16, w_is_bf16, stream
        "edrl_fused_mlp_fwd": (i32, [ptr] * 9 + [i32] * 5 + [ptr]),
        # u, dy, w1, b1, w2, du, dw1, db1, dw2, db2, w1t, w1b, w2b, dh, act,
        # db1_part, db2_part, dw1_part, dw2_part, m, c, h, splits, chunk,
        # u_is_bf16, w_is_bf16, stream
        "edrl_fused_mlp_bwd": (i32, [ptr] * 19 + [i32] * 7 + [ptr]),
        # x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, y, qkv, xln, o, wqkv_t,
        # wproj_t, batch, windows, bias_windows, n, c, heads, scale, is_bf16, stream
        "edrl_attention_sublayer_fwd": (i32, [ptr] * 14 + [i32] * 6 + [f32, i32, ptr]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


_LIB: Optional[ctypes.CDLL] = None


def launch(counts: dict, name: str, fn, device, *args) -> None:
    """Call entry point ``fn(*args, stream)`` on ``device``'s current stream,
    raise if it returns a CUDA error, and count the launch in ``counts[name]``."""
    import torch

    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    counts[name] += 1


def sm_count(device) -> int:
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on the first call in this process."""
    global _LIB
    if _LIB is None:
        _LIB = _bind(ctypes.CDLL(str(build_library())))
    return _LIB
