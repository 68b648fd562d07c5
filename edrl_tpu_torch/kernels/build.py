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
import functools
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
        # is_bf16, n, d -> 1 for the wgmma route, 0 for the CUDA-core route
        "edrl_attention_fwd_route": (i32, [i32, i32, i32]),
        # d, heads, n, groups, head / row / group stride, box rows, out[11]: the wgmma route's tensor map
        "edrl_attention_fwd_map_plan": (i32, [i32, i32, i32, i32, i64, i32, i64, i32, ptr]),
        # n, items, out[2]: the wgmma route's CTAs and work units
        "edrl_attention_fwd_grid": (i32, [i32, i32, ptr]),
        # is_bf16, n, d, with_bias, out[3]: blocks per SM, smem bytes, warps per block
        "edrl_attention_fwd_occupancy": (i32, [i32, i32, i32, i32, ptr]),
        "edrl_attention_bwd_smem_bytes": (i64, [i32, i32, i32]),
        # is_bf16, n, d -> 1 for the wgmma route, 0 for the CUDA-core route
        "edrl_attention_bwd_route": (i32, [i32, i32, i32]),
        # is_bf16, n, d, with_dbias, out[4]: rows (dq) and keys (dk/dv) kernels' blocks per SM, then
        # their smem bytes
        "edrl_attention_bwd_occupancy": (i32, [i32, i32, i32, i32, ptr]),
        # n, batch, windows, heads, batch_per_block, out[7]: the wgmma route's rows kernel CTAs and
        # units, keys kernel CTAs and units, keys held, rows and keys consumer registers (setmaxnreg)
        "edrl_attention_bwd_grid": (i32, [i32, i32, i32, i32, i32, ptr]),
        "edrl_self_attention_fwd": (i32, [ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32, i32, ptr]),
        # q, k, v, bias, o, batch, windows, heads, n, d, q/k/v's group / head / row stride, o's,
        # scale, is_bf16, stream
        "edrl_window_attention_fwd": (i32, [ptr] * 5 + [i32] * 5 + [i64, i64, i32] * 2 + [f32, i32, ptr]),
        # q, k, v, dout, dq, dk, dv, stats, batch, n, c, heads, scale, is_bf16, stream
        "edrl_self_attention_bwd": (
            i32, [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32, i32, ptr]),
        # q, k, v, bias, bias_tiles, dout, dq, dk, dv, dbias_partial, dbias, stats, batch, windows,
        # heads, n, d, q/k/v's (and dq/dk/dv's) group / head / row stride, dout's, batch_per_block,
        # scale, is_bf16, stream
        "edrl_window_attention_bwd": (
            i32, [ptr] * 12 + [i32] * 5 + [i64, i64, i32] * 2 + [i32, f32, i32, ptr]),
        # n -> 1 for the cluster route, 0 for the split route
        "edrl_mk_mmd_route": (i32, [i32]),
        "edrl_mk_mmd_scratch_floats": (i64, [i32, i32]),
        # out[8]: cluster kernel registers, static smem, local bytes, threads; split route's
        # partial kernel registers, smem, local bytes; the cluster route's CTAs
        "edrl_mk_mmd_fwd_attributes": (i32, [ptr]),
        # source, target, n_s, n_t, d, kernel_mul, kernel_num, scratch, out, state, stream
        "edrl_mk_mmd_fwd": (i32, [ptr, ptr, i32, i32, i32, f32, i32, ptr, ptr, ptr, ptr]),
        # n, out[4]: registers, local bytes, dynamic smem bytes, CTAs per SM
        "edrl_mk_mmd_bwd_attributes": (i32, [i32, ptr]),
        # source, target, state, grad, ds, dt, n_s, n_t, d, kernel_mul, kernel_num, stream
        "edrl_mk_mmd_bwd": (i32, [ptr] * 6 + [i32, i32, i32, f32, i32, ptr]),
        # stream: one launch of an empty kernel
        "edrl_empty_launch": (i32, [ptr]),
        # x, gamma, beta, y, m, c, eps, is_bf16, stream
        "edrl_layer_norm_fwd": (i32, [ptr, ptr, ptr, ptr, i32, i32, f32, i32, ptr]),
        # x, dy, gamma, dx, dgb ([2, c]: dgamma, dbeta), partial, m, c, ctas, eps, is_bf16, stream
        "edrl_layer_norm_bwd": (i32, [ptr] * 6 + [i32, i32, i32, f32, i32, ptr]),
        # m, c, is_bf16, kind (0 forward, 1 backward, 2 residual), sms, out[4]: threads per
        # row, rows per CTA, CTAs, partials
        "edrl_layer_norm_plan": (i32, [i32, i32, i32, i32, i32, ptr]),
        # c, is_bf16, out[5]: CTAs per SM, threads per CTA, smem bytes, registers, local bytes
        "edrl_layer_norm_fwd_occupancy": (i32, [i32, i32, ptr]),
        # c, is_bf16, residual, out[5]: as the forward's
        "edrl_layer_norm_bwd_occupancy": (i32, [i32, i32, i32, ptr]),
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
        # x, dy (f32), res, gamma, dx, dgb, partial, m, c, ctas, eps, is_bf16, stream
        "edrl_layer_norm_bwd_residual": (i32, [ptr] * 7 + [i32, i32, i32, f32, i32, ptr]),
        # is_bf16, c, heads -> 1 for the wgmma route, 0 for the f32 FMA route, -1 refused
        "edrl_attention_sublayer_route": (i32, [i32, i32, i32]),
        # out[4]: qkv and proj products' CTAs per SM, their smem bytes, threads per CTA
        "edrl_attention_sublayer_fwd_occupancy": (i32, [ptr]),
        # out[4]: da product's CTAs per SM (bf16, f32 result), weight gradient's; their smem bytes
        "edrl_attention_sublayer_bwd_occupancy": (i32, [ptr]),
        # x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, y, qkv, xln, o, batch,
        # windows, bias_windows, n, c, heads, scale, is_bf16, stream
        "edrl_attention_sublayer_fwd": (i32, [ptr] * 12 + [i32] * 6 + [f32, i32, ptr]),
        # a, dout, w, dw, db, da, dw_part, db_part, m, p, q, splits, chunk,
        # rows_per_part, da_is_f32, stream
        "edrl_attention_sublayer_dense_bwd": (i32, [ptr] * 8 + [i32] * 7 + [ptr]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


_LIB: Optional[ctypes.CDLL] = None
# The namespace of the forward kernels' operators (``torch.ops.edrl_tpu_torch.*``),
# which each kernel module registers as it is imported.
OP_NAMESPACE = "edrl_tpu_torch"


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``: a wrapper calls its
    ``autograd.Function`` then, and its forward operator alone otherwise."""
    import torch

    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def launch(counts: dict, name: str, fn, device, *args) -> None:
    """Call entry point ``fn(*args, stream)`` on ``device``'s current stream,
    raise if it returns a CUDA error, and count the launch in ``counts[name]``.

    The stream is read as a raw handle, and the thread's current device is
    switched only where ``device`` is another: the host's work per launch is
    what a host-bound step pays."""
    import torch

    index = torch.cuda.current_device() if device.index is None else device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    counts[name] += 1


def aligned16(t):
    """t itself, or a copy where its data does not start on a 16-byte
    boundary (TMA and the kernels' 16-byte loads need it)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SM count of a CUDA ``device``, asked once per device."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on the first call in this process."""
    global _LIB
    if _LIB is None:
        _LIB = _bind(ctypes.CDLL(str(build_library())))
    return _LIB
