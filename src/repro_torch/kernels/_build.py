"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` has a plain C interface (pointers, sizes, the stream; an
``int`` return carrying ``cudaGetLastError()``), so no source includes
PyTorch's headers and a build takes seconds. The sources compile in
parallel, one ``nvcc`` each, for ``sm_90a`` (Hopper), then link into one
shared library under ``build/repro_torch/<hash>/`` at the repository root,
keyed on a hash of the sources, the headers they share (``csrc/*.cuh``) and
the flags. The build runs on first use; a
failed build raises.

No ``--use_fast_math``: the quantizer divides with a true IEEE divide and
rounds half to even, bit-exact with ``jnp.round`` and numpy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
LIB_NAME = "libreprotorch.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float
SIGNATURES = {
    # x, codes, scales, rows, size, n_chunks, chunk, bits, stream
    "rt_quantize": [_P, _P, _P, _I64, _I64, _I64, _I32, _I32, _P],
    # codes, scales, out, rows, size, n_chunks, chunk, bits, stream
    "rt_dequantize": [_P, _P, _P, _I64, _I64, _I64, _I32, _I32, _P],
    # x, vals, idx, rows, size, n_blocks, block, k, stream
    "rt_topk_select": [_P, _P, _P, _I64, _I64, _I64, _I32, _I32, _P],
    # buf, weights, out, batch, n, p, dtype (0 = f32, 1 = bf16), stream
    "rt_gossip_mix": [_P, _P, _P, _I64, _I32, _I64, _I32, _P],
    # q, k, v, o, lse (or null), b, sq, skv, h, kvh, hd, (b, s, h) strides of
    # q, k and v, causal, window, softcap, stream: f32 (SIMT) and bf16
    # (tensor cores)
    "rt_flash_attention_f32": [_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
                               *[_I64] * 9, _I32, _I32, _F32, _P],
    "rt_flash_attention_bf16": [_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
                                *[_I64] * 9, _I32, _I32, _F32, _P],
    # q, k, v, o, lse, dO, D scratch, dq, dk, dv, an unused pointer (the
    # earlier kernels' GQA scratch), b, sq, skv, h, kvh, hd, causal, window,
    # softcap, dtype (0 = f32, 1 = bf16), stream
    "rt_flash_attention_bwd": [*[_P] * 11, _I32, _I32, _I32, _I32, _I32, _I32,
                               _I32, _I32, _F32, _I32, _P],
    # dt, B, C, x, A_log, D, y, h_last, h_chunks (or null), b, s, di, n, x dtype,
    # y dtype, stream
    "rt_selective_scan": [*[_P] * 9, _I32, _I32, _I32, _I32, _I32, _I32, _P],
    # dt, B, C, x, A_log, D, h_chunks, dy, dh_last (or null), ddt, dx, dB, dC,
    # dA_log, dD, workspace, its f32 elements, b, s, di, n, x dtype, dy dtype,
    # stream
    "rt_selective_scan_bwd": [*[_P] * 16, _I64, _I32, _I32, _I32, _I32, _I32, _I32, _P],
}
# name: (argtypes, restype) of the entry points that return something else
# than a CUDA status
QUERIES = {
    # b, s, di, n -> the backward's workspace in f32 elements
    "rt_selective_scan_bwd_workspace": ([_I32, _I32, _I32, _I32], _I64),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the repro_torch kernels")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> float:
    """Compile the kernels unless this source hash is built; returns the
    seconds spent compiling (0.0 when the library was already there)."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name} (rc={proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / "nvcc.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs)[-6000:])
    tmp = out_dir / (LIB_NAME + f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout[-6000:]}")
    os.replace(tmp, lib_path)
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            handle = ctypes.CDLL(str(build_dir() / LIB_NAME))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, (argtypes, restype) in QUERIES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            handle.rt_error_string.argtypes = [ctypes.c_int]
            handle.rt_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        msg = lib().rt_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg}) at launch")
