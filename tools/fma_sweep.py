"""Tile shapes of the f32-FMA flash forward, dQ and dK/dV, timed on one card.

    python3 -m tools.fma_sweep [variant ...] [--csrc NAME=DIR ...]

A tuning script beside ``chip_smoke.py``, outside the port's package: it
reaches into ``ops/_build.py``'s internals to build variants of the
sources.  Each variant rewrites ``FwdCfg`` / ``DqCfg`` / ``DkvCfg`` entries
of ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` in a temporary copy and
builds ``flash_fwd.cu``, ``flash_bwd.cu`` and ``errors.cu`` into a library
of its own (every variant's ``nvcc`` at once).  ``--csrc NAME=DIR`` adds a
variant built from the ``csrc/`` directory ``DIR`` unchanged, such as
another checkout's (its entry points must take this checkout's
arguments), so that two versions of a kernel are timed in one call.
Then, case by case (the float32 rows of ``chip_smoke.FLASH_CASES`` and
bf16 at head dims 16 and 32), each variant runs the forward, dQ and dK/dV
through the port's wrappers, is held against the plain versions
(``chip_smoke.fwd_check`` / ``grad_check`` at ``chip_smoke.limits``; a
variant outside them is marked ``BAD``) and is timed by
``chip_smoke.time_ms`` (CUDA-graph replay).  One line per case: each
variant's forward, dQ and dK/dV ms and their share of the f32 bound.  The
lines are the evidence for the shapes the sources keep; ``chip_smoke.py``
measures the kept kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FWD, BWD = "flash_fwd.cu", "flash_bwd.cu"
SOURCES = (FWD, BWD, "errors.cu")


def cfg(src: str, struct: str, D: int, **fields) -> list:
    """A rewrite of ``struct<D>``'s constants in ``src``."""
    body = ", ".join(f"{k} = {v}" for k, v in fields.items())
    return [(src, rf"(struct {struct}<{D}> {{\n  static constexpr int )[^;]*;",
             rf"\g<1>{body};")]


#: Variant -> source rewrites.  "kept" is the sources as they are; the
#: others are the shapes the kept ones were chosen over (the first design's
#: 8-row thread tiles, a 32-row dK/dV warp; for dQ one K/V stage or two,
#: 8-row thread tiles, 32-key tiles at three CTAs an SM).
VARIANTS = {
    "kept": [],
    "dq_st1": cfg(BWD, "DqCfg", 64, MR=4, TC=8, SC=8, NW=4, ST=1, MINB=2),
    "dq_st2": cfg(BWD, "DqCfg", 128, MR=4, TC=8, SC=4, NW=4, ST=2, MINB=1),
    "dq_mr8": cfg(BWD, "DqCfg", 64, MR=8, TC=8, SC=4, NW=4, ST=2, MINB=2),
    "dq_bk32": cfg(BWD, "DqCfg", 64, MR=4, TC=8, SC=4, NW=4, ST=2, MINB=3),
    "fwd_mr8": (cfg(FWD, "FwdCfg", 64, MR=8, TC=8, SC=4, NW=4, MINB=3)
                + cfg(FWD, "FwdCfg", 128, MR=8, TC=16, SC=4, NW=4, MINB=2)
                + cfg(FWD, "FwdCfg", 16, MR=8, TC=4, SC=8, NW=1, MINB=4)),
    "dkv_rw32": (cfg(BWD, "DkvCfg", 64, RW=32, TRs=4, MCs=4, MRn=8, NW=4,
                     MINB=2)
                 + cfg(BWD, "DkvCfg", 16, RW=64, TRs=8, MCs=8, MRn=8, NW=1,
                       MINB=2)),
}


def smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def start_build(_build, work: Path, rewrites, src_dir=None):
    """Copy ``src_dir`` (default: this checkout's ``csrc/``) into ``work``,
    apply ``rewrites``, start one ``nvcc`` per source."""
    shutil.copytree(src_dir or _build.SRC_DIR, work / "csrc")
    for name, pattern, repl in rewrites:
        path = work / "csrc" / name
        text, n = re.subn(pattern, repl, path.read_text())
        if n != 1:
            raise ValueError(f"{name}: {pattern!r} matched {n} times")
        path.write_text(text)
    return [subprocess.Popen(
        [_build._nvcc(), *_build.ARCH_FLAGS, *_build.COMPILE_FLAGS, "-c",
         str(work / "csrc" / src), "-o", str(work / f"{src}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for src in SOURCES]


def finish_build(_build, work: Path, procs):
    """Link and load a variant's library; its ptxas registers and spill
    bytes per forward, dQ and dK/dV kernel."""
    report = "".join(p.communicate()[0].decode(errors="replace")
                     for p in procs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed:\n{report[-4000:]}")
    lib = work / "lib.so"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o",
                    str(lib), *(str(work / f"{s}.o") for s in SOURCES)],
                   check=True, capture_output=True)
    regs, lines = [], report.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"(flash_fwd|flash_bwd_dkv|flash_bwd_dq)_kernelI"
                      r"(f|13__nv_bfloat16)Li(\d+)", line)
        if m and "Compiling entry" in line:
            info = " ".join(lines[i + 1:i + 4])
            used = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores", info)
            dtype = "f32" if m.group(2) == "f" else "bf16"
            regs.append(f"{m.group(1)[6:]}-{dtype}-D{m.group(3)}:"
                        f"{used and used.group(1)}/{spill and spill.group(1)}")
    dll = ctypes.CDLL(str(lib))
    for fn in ("tj_flash_fwd", "tj_flash_bwd_dq", "tj_flash_bwd_dkv"):
        getattr(dll, fn).argtypes = _build.SIGNATURES[fn]
        getattr(dll, fn).restype = ctypes.c_int
    dll.tj_error_string.argtypes = [ctypes.c_int]
    dll.tj_error_string.restype = ctypes.c_char_p
    return dll, regs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", default=list(VARIANTS),
                        help=f"of {list(VARIANTS)} (default: all)")
    parser.add_argument("--csrc", action="append", default=[],
                        metavar="NAME=DIR",
                        help="also a variant NAME built from the csrc/ "
                             "directory DIR as it is")
    args = parser.parse_args(argv)
    sources = {name: (None, VARIANTS[name]) for name in args.variants}
    for spec in args.csrc:
        name, _, path = spec.partition("=")
        sources[name] = (Path(path).resolve(), [])
    import torch

    if not torch.cuda.is_available():
        print("fma_sweep: CUDA is not available", file=sys.stderr)
        return 2
    from trainingjob_operator_tpu_torch.ops import _build

    flash = importlib.import_module(
        "trainingjob_operator_tpu_torch.ops.flash_attention")
    smoke = smoke_module()
    torch.backends.cuda.matmul.allow_tf32 = False
    home = Path(tempfile.mkdtemp(prefix="fma_sweep_"))
    try:
        built = {}
        started = {name: start_build(_build, home / name, rewrites, src)
                   for name, (src, rewrites) in sources.items()}
        for name, procs in started.items():
            built[name] = finish_build(_build, home / name, procs)
            print(f"registers/spill bytes {name}: {' '.join(built[name][1])}",
                  flush=True)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        run_cases(torch, flash, _build, smoke, built, list(sources))
    finally:
        shutil.rmtree(home, ignore_errors=True)
    return 0


def run_cases(torch, flash, _build, smoke, built, names) -> None:
    cases = [c for c in smoke.FLASH_CASES if c[-1] == "float32"] + [
        (1, 1000, 32, 32, 16, True, 0, "bfloat16"),
        (1, 1000, 32, 32, 32, True, 0, "bfloat16")]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for B, T, H, Hkv, D, causal, window, dname in cases:
        dtype = getattr(torch, dname)
        q, do = (torch.randn(B, T, H, D, generator=gen, device=dev)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(B, T, Hkv, D, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        opts = dict(causal=causal, scale=D ** -0.5, window=window)
        want, _ = flash.flash_reference_with_lse(q, k, v, **opts)
        pairs = B * H * smoke.visible_pairs(T, causal, window)
        fwd_bound = smoke.bound(0, 4 * D * pairs, "float32")[0]
        dq_bound = smoke.bound(0, 6 * D * pairs, "float32")[0]
        dkv_bound = smoke.bound(0, 8 * D * pairs, "float32")[0]
        key = smoke.limits(dname, "fma")
        row = f"B{B} T{T} H{H}/{Hkv} D{D} w{window} {dname}:"
        for name in names:
            _build._lib = built[name][0]
            out, lse = flash.flash_kernel_with_lse(q, k, v, **opts)
            delta = flash.flash_delta(do, out)
            dq = flash.flash_bwd_dq_kernel(q, k, v, do, lse, delta, **opts)
            dk, dv = flash.flash_bwd_dkv_kernel(q, k, v, do, lse, delta,
                                                **opts)
            want_dq = flash.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                                   **opts)
            want_dk, want_dv = flash.flash_bwd_dkv_reference(
                q, k, v, do, lse, delta, **opts)
            ok = (smoke.fwd_check(torch, out, want, key)["ok"]
                  and smoke.grad_check(torch, dq, want_dq, key,
                                       smoke.DQ_ATOL_FLOOR_RMS)["ok"]
                  and smoke.grad_check(torch, dk, want_dk, key)["ok"]
                  and smoke.grad_check(torch, dv, want_dv, key)["ok"])
            iters = smoke.flash_iters(T)
            fwd_ms = smoke.time_ms(lambda: flash.flash_kernel_with_lse(
                q, k, v, **opts), iters)
            dq_ms = smoke.time_ms(lambda: flash.flash_bwd_dq_kernel(
                q, k, v, do, lse, delta, **opts), iters)
            dkv_ms = smoke.time_ms(lambda: flash.flash_bwd_dkv_kernel(
                q, k, v, do, lse, delta, **opts), iters)
            row += (f" | {name} fwd {fwd_ms:.4f} ({fwd_bound / fwd_ms:.3f})"
                    f" dq {dq_ms:.4f} ({dq_bound / dq_ms:.3f})"
                    f" dkv {dkv_ms:.4f} ({dkv_bound / dkv_ms:.3f})"
                    f"{'' if ok else ' BAD'}")
        print(row, flush=True)
        del q, k, v, do, out, lse, delta, dq, dk, dv, want, want_dq
        del want_dk, want_dv
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
