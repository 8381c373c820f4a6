"""Build the CUDA kernels under ``csrc/`` with ``nvcc`` and load them.

Every ``csrc/*.cu`` compiles to an object (all ``nvcc`` processes start
together), the objects link into one shared library with a plain C
interface, and ``ctypes`` loads it.  The library's name carries a tag, the
hash of the sources, the flags and the toolkit (``nvcc --version``'s
release line and ``torch.version.cuda``), so an edited source or another
toolkit rebuilds and an unchanged one loads at once.  Nothing is built at
import time: the first kernel launch builds.

Where the library is looked up, in order (``build``): the job's kernel
cache (``set_cache_dir``, which ``rendezvous.enable_compile_cache`` points
at a directory that outlives the container), then the package's
``_build/`` (git-ignored; a container image may ship it, and it is only
read), then an ``nvcc`` build into the cache directory, or into
``_build/`` where no cache directory is set.  The counterpart of the JAX
package's persistent compile cache and executable snapshot: the
kernels take no shape, so the one library serves every step.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a non-zero code (``check``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

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
    # q, k, v, ts (or null), t, out, part_acc, part_ml, B, S, Hkv, D, group,
    # group_slots, window, dtype, chunk, splits, scale, the (b, h) strides
    # of q, the (b, s, h) strides of k and v, then the stream
    "tj_decode_attention": [_P] * 4 + [_L] + [_P] * 3 + [_I] * 10 + [_F]
    + [_L] * 8 + [_P],
    # xs, w_gate, w_up, ends, h, P, D, F, E, dtype, then the stream
    "tj_moe_gate_up": [_P] * 5 + [_I] * 5 + [_P],
    # h, w_down, ends, order, y, P, F, D, E, dtype, then the stream
    "tj_moe_down": [_P] * 5 + [_I] * 5 + [_P],
}

#: dtype codes the C entry points take (csrc/common.cuh kF32, kBF16).
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: The job's kernel cache (``set_cache_dir``); None: the package's
#: ``_build/`` only.
_cache_dir: Optional[Path] = None
#: Where the last ``build`` found or made the library: ``path``, ``how``
#: ("cache hit", "package _build" or "built") and ``build_s`` (0 unless
#: built).
found: Dict[str, Any] = {}


def set_cache_dir(path) -> None:
    """Look the library up in ``path`` first, and build it there when it is
    found nowhere; a false ``path`` restores the default (the package's
    ``_build/`` only).  Call before the first kernel launch: a library
    this process already loaded stays loaded."""
    global _cache_dir
    with _lock:
        _cache_dir = Path(path) if path else None


def _nvcc() -> str:
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def toolkit() -> str:
    """The toolkit a library is built with: ``nvcc --version``'s release
    line and the CUDA version PyTorch was built for."""
    import torch

    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    release = next((line.strip() for line in out.splitlines()
                    if "release" in line), out.strip())
    return f"{release}; torch.version.cuda {torch.version.cuda}"


def source_tag() -> str:
    """Hash of every source, header and flag the library depends on, and
    of the toolkit (``toolkit``)."""
    h = hashlib.sha256()
    for path in sorted(SRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    h.update(toolkit().encode())
    return h.hexdigest()[:16]


def _compile(home: Path, tag: str, lib_path: Path) -> None:
    """Compile ``csrc/*.cu`` in a temporary directory of ``home`` and
    publish the library at ``lib_path`` by ``os.replace``, so that no
    process ever opens a half-written file.  The ``-Xptxas -v`` report
    (registers, shared memory, spills per kernel) lands beside it as
    ``<tag>.log``."""
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix="build-", dir=home))
    try:
        sources = sorted(SRC_DIR.glob("*.cu"))
        objs = [str(work / (src.stem + ".o")) for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for src, obj in zip(sources, objs)]
        report = "".join(p.communicate()[0].decode(errors="replace")
                         for p in procs)
        (work / "report.log").write_text(report)
        os.replace(work / "report.log", home / f"{tag}.log")
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed:\n{report}")
        tmp_lib = str(work / lib_path.name)
        subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib, *objs],
                       check=True, capture_output=True)
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def build() -> Path:
    """The path of ``libtj_kernels_<tag>.so``: found in the kernel cache,
    else in the package's ``_build/``, else compiled into the cache
    directory (``_build/`` without one).  Sets ``found``.

    Processes building one tag on one host take turns on an ``fcntl``
    lock file beside the library: one compiles, the others wait, find the
    published file and load it.  The lock is the kernel's, so a process
    that dies releases it.  On storage where ``flock`` is refused, each
    process compiles in its own temporary directory and the last ``os.replace``
    wins (the files are the same); where it is silently not shared across
    hosts (some NFS mounts), the same.  An unwritable cache directory or a
    failed build raises."""
    tag = source_tag()
    name = f"libtj_kernels_{tag}.so"
    for where, how in ((_cache_dir, "cache hit"),
                       (BUILD_DIR, "package _build")):
        if where is not None and (where / name).exists():
            found.update(path=where / name, how=how, build_s=0.0)
            return where / name
    home = _cache_dir if _cache_dir is not None else BUILD_DIR
    lib_path = home / name
    try:
        home.mkdir(parents=True, exist_ok=True)
        lock = open(home / f"{name}.lock", "a")
    except OSError as exc:
        raise RuntimeError(f"kernel cache {home} is not writable: {exc}") \
            from exc
    with lock:
        try:
            fcntl.flock(lock, fcntl.LOCK_EX)
        except OSError:
            pass
        if lib_path.exists():
            # Another process published it while this one waited.
            found.update(path=lib_path, build_s=0.0,
                         how="cache hit" if _cache_dir is not None
                         else "package _build")
            return lib_path
        t0 = time.perf_counter()
        _compile(home, tag, lib_path)
        found.update(path=lib_path, how="built",
                     build_s=time.perf_counter() - t0)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (``build`` on first use), announced by one
    line: ``kernels: loaded <path> (cache hit | package _build | built in
    <s> s)``."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            how = (f"built in {found['build_s']:.1f} s"
                   if found["how"] == "built" else found["how"])
            print(f"kernels: loaded {path} ({how})", flush=True)
            lib = ctypes.CDLL(str(path))
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
