"""Build the CUDA kernels under ``csrc/`` with ``nvcc`` and load them.

Every ``csrc/*.cu`` compiles to an object (all ``nvcc`` processes start
together), the objects link into one shared library with a plain C
interface, and ``ctypes`` loads it.  The library lands in ``_build/``
(git-ignored) under a name that carries the hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing is built at import time: the first kernel launch builds.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a non-zero code (``check``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_G = ctypes.POINTER(ctypes.c_longlong)

#: C signatures of the entry points (csrc/*.cu ``extern "C"``).
SIGNATURES = {
    # x, scale, out, rows, d, eps, dtype, per, team, stream
    "tj_rmsnorm_fwd": [_P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
    # q, k, v, o, lse, B, T, Hq, Hkv, D, dtype, causal, window, scale,
    # then (b, t, h, d) strides of q, k, v and o, then the stream
    "tj_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F]
    + [_L] * 16 + [_P],
    # q, k, v, dout, lse, delta, dq, B, T, Hq, Hkv, D, dtype, causal,
    # window, scale, then (b, t, h, d) strides of q, k, v, dout and dq,
    # then the stream
    "tj_flash_bwd_dq": [_P] * 7 + [_I] * 8 + [_F] + [_L] * 20 + [_P],
    # as tj_flash_bwd_dq with dk, dv for dq and the strides of both
    "tj_flash_bwd_dkv": [_P] * 8 + [_I] * 8 + [_F] + [_L] * 24 + [_P],
    # q, k, v, o, lse, B, T, Hq, Hkv, D, causal, window, scale, the tensor-map
    # geometry of q, k and v (``geometry``), the (b, t, h, d) strides of o,
    # then the stream
    "tj_flash_fwd_wgmma": [_P] * 5 + [_I] * 7 + [_F] + [_G] * 3 + [_L] * 4
    + [_P],
    # q, k, v, dout, lse, delta, dq, B, T, Hq, Hkv, D, causal, window,
    # scale, the geometry of q, k, v and dout, the strides of dq, then the
    # stream
    "tj_flash_bwd_dq_wgmma": [_P] * 7 + [_I] * 7 + [_F] + [_G] * 4
    + [_L] * 4 + [_P],
    # q, k, v, dout, lse, delta, dk, dv, B, T, Hq, Hkv, D, causal, window,
    # scale, the geometry of q, k, v and dout, the strides of dk and dv,
    # then the stream
    "tj_flash_bwd_dkv_wgmma": [_P] * 8 + [_I] * 7 + [_F] + [_G] * 4
    + [_L] * 8 + [_P],
}

#: dtype codes the C entry points take (csrc/common.cuh kF32, kBF16).
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_tag() -> str:
    """Hash of every source, header and flag the library depends on."""
    h = hashlib.sha256()
    for path in sorted(SRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/libtj_kernels_<tag>.so`` unless
    that file exists; returns its path.  The ``-Xptxas -v`` report
    (registers, shared memory, spills per kernel) is kept beside it as
    ``<tag>.log``."""
    tag = source_tag()
    lib_path = BUILD_DIR / f"libtj_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        sources = sorted(SRC_DIR.glob("*.cu"))
        objs = [str(work / (src.stem + ".o")) for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for src, obj in zip(sources, objs)]
        report = "".join(p.communicate()[0].decode(errors="replace")
                         for p in procs)
        (BUILD_DIR / f"{tag}.log").write_text(report)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{report}")
        tmp_lib = str(work / lib_path.name)
        subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib, *objs],
                       check=True, capture_output=True)
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.tj_error_string.argtypes = [ctypes.c_int]
            lib.tj_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, kernel: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().tj_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} "
                           f"({msg})")


def dtype_code(t) -> int:
    """The C entry points' code for ``t``'s dtype (float32 or bfloat16)."""
    return DTYPE_CODES[str(t.dtype)]


def geometry(tensor_map: dict):
    """A tensor map's dims and byte strides (``flash_attention``
    ``tensor_map_geometry``) as the ``long long[7]`` the C entry points
    take."""
    return (ctypes.c_longlong * 7)(*tensor_map["dims"],
                                   *tensor_map["strides"])


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
