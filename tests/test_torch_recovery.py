"""The port's resume fast path and kernel cache on the CPU.

- ``rendezvous.compile_cache_dir`` resolves the cache directory as the
  JAX package's does, over a table of environments, apart from the
  subdirectory under the checkpoint root (``.torch_kernel_cache``: the
  port's kernel library, not XLA's cache).
- ``train.overlapped_restore`` keeps JAX's contract: JAX's own cases
  (tests/test_recovery.py ``TestOverlappedRestore``) run on both
  packages' functions with the same sleeping callables.
- ``ops/_build.py`` with a fake ``nvcc`` (a script on ``PATH`` that logs
  its arguments, writes its ``-o`` file and prints a version): the build
  lands in the cache directory, a second call runs no compile, a library
  in the package's ``_build/`` is found, the toolkit is part of the tag,
  two processes building one tag at once both get one complete file with
  every source compiled once, and an unwritable cache or a failed build
  raises.
- The tiny Llama trainer restarted on the CPU: ``recovery_timing`` prints
  the measured ``compile_s`` and ``resume_overlap``, the telemetry resume
  record carries them, and the losses after the restart equal an
  uninterrupted run's bit for bit, with the overlap on and off.
"""

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import pytest
import torch

from _torch_sink import Sink
from conftest import apply_jax_platform_override

apply_jax_platform_override()

from trainingjob_operator_tpu.api import constants as jconst  # noqa: E402
from trainingjob_operator_tpu.workloads import rendezvous as jrdv  # noqa: E402
from trainingjob_operator_tpu.workloads import train as jtrain  # noqa: E402
from trainingjob_operator_tpu_torch import constants  # noqa: E402
from trainingjob_operator_tpu_torch.ops import _build  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import rendezvous  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import train as ttrain  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
N_SOURCES = len(list(_build.SRC_DIR.glob("*.cu")))


# -- the cache directory ----------------------------------------------------

DIR, LEGACY = constants.COMPILE_CACHE_DIR_ENV, constants.COMPILE_CACHE_ENV

CACHE_ENVS = [
    ({DIR: "/nfs/cache"}, "/ck"),
    ({LEGACY: "/legacy"}, "/ck"),
    ({DIR: "/nfs/cache", LEGACY: "/legacy"}, "/ck"),
    ({DIR: "off"}, "/ck"),
    ({LEGACY: "off"}, "/ck"),
    ({DIR: "off", LEGACY: "/legacy"}, "/ck"),
    ({DIR: "", LEGACY: ""}, "/ck"),
    ({}, "/ck"),
    ({}, ""),
    ({LEGACY: "/legacy"}, ""),
]


@pytest.mark.parametrize("env,ckpt", CACHE_ENVS)
def test_compile_cache_dir_resolves_as_jax(monkeypatch, env, ckpt):
    monkeypatch.delenv(DIR, raising=False)
    monkeypatch.delenv(LEGACY, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    want = jrdv.compile_cache_dir(jrdv.Rendezvous(checkpoint_dir=ckpt))
    got = rendezvous.compile_cache_dir(
        rendezvous.Rendezvous(checkpoint_dir=ckpt))
    assert got == want.replace(".jax_compile_cache", ".torch_kernel_cache")
    if not env and ckpt:
        assert got == os.path.join(ckpt, rendezvous.KERNEL_CACHE_SUBDIR)


def test_the_cache_names_agree_with_the_jax_package():
    assert (DIR, LEGACY) == (jconst.COMPILE_CACHE_DIR_ENV,
                             jconst.COMPILE_CACHE_ENV)


def test_enable_compile_cache_points_the_build_at_it(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_cache_dir", None)
    monkeypatch.delenv(DIR, raising=False)
    monkeypatch.delenv(LEGACY, raising=False)
    rdv = rendezvous.Rendezvous(checkpoint_dir=str(tmp_path / "ck"))
    path = rendezvous.enable_compile_cache(rdv)
    assert path == str(tmp_path / "ck" / ".torch_kernel_cache")
    assert Path(path).is_dir() and _build._cache_dir == Path(path)
    monkeypatch.setenv(DIR, "off")
    assert rendezvous.enable_compile_cache(rdv) == ""
    assert _build._cache_dir is None


# -- overlapped_restore, JAX's cases on both packages -----------------------

RESTORES = {"jax": jtrain.overlapped_restore,
            "torch": ttrain.overlapped_restore}
FAILED = {"jax": "warm compile failed", "torch": "warm-up failed"}


@pytest.mark.parametrize("pkg", sorted(RESTORES))
class TestOverlappedRestore:
    def test_phases_actually_overlap(self, pkg):
        order = []

        def restore_fn():
            order.append("restore-start")
            time.sleep(0.25)
            order.append("restore-end")
            return "state"

        def warm_fn():
            order.append("warm-start")
            time.sleep(0.25)
            return "warm"

        restored, warmed, t = RESTORES[pkg](restore_fn, warm_fn,
                                            overlap=True)
        assert (restored, warmed) == ("state", "warm")
        assert t["overlap"]
        assert order.index("warm-start") < order.index("restore-end")
        assert t["wall_s"] < 0.9 * (t["restore_s"] + t["compile_s"])
        assert set(t) >= {"restore_s", "compile_s", "wall_s", "overlap"}

    def test_serial_mode_runs_the_warm_up_after_the_restore(self, pkg):
        order = []
        restored, warmed, t = RESTORES[pkg](
            lambda: order.append("restore") or "s",
            lambda: order.append("warm") or "w", overlap=False)
        assert (restored, warmed) == ("s", "w")
        assert not t["overlap"]
        assert order == ["restore", "warm"]

    def test_env_knob_disables_overlap(self, pkg, monkeypatch):
        monkeypatch.setenv(constants.RESUME_OVERLAP_ENV, "0")
        _, _, t = RESTORES[pkg](lambda: 1, lambda: 2)
        assert not t["overlap"]
        monkeypatch.delenv(constants.RESUME_OVERLAP_ENV)
        _, _, t = RESTORES[pkg](lambda: 1, lambda: 2)
        assert t["overlap"]

    def test_a_failed_warm_up_leaves_the_restore_intact(self, pkg, capsys):
        def bad_warm():
            raise ValueError("no cache for you")

        restored, warmed, t = RESTORES[pkg](lambda: "s", bad_warm,
                                            overlap=True)
        assert restored == "s" and warmed is None
        assert t["compile_s"] >= 0
        assert FAILED[pkg] in capsys.readouterr().out

    def test_restore_only(self, pkg):
        restored, warmed, t = RESTORES[pkg](lambda: "s")
        assert (restored, warmed) == ("s", None)
        assert t["compile_s"] == 0.0 and not t["overlap"]


def test_the_spans_keep_jax_names():
    spans = []

    class Tracer:
        def span(self, name, parent=None, **attrs):
            spans.append((name, parent))
            return mock.MagicMock()

    ttrain.overlapped_restore(lambda: 1, lambda: 2, tracer=Tracer(),
                              trace_parent="p", overlap=True)
    assert sorted(spans) == [("resume.compile", "p"),
                             ("resume.restore", "p")]


def test_warm_up_leaves_the_cpu_alone(monkeypatch):
    def must_not_run():
        raise AssertionError("the CPU needs no kernel library")

    monkeypatch.setattr(_build, "library", must_not_run)
    assert ttrain.warm_up(torch.device("cpu"))() is None


# -- the kernel library's cache, with a fake nvcc ---------------------------

FAKE_NVCC = """#!{python}
import os, sys, time
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(" ".join(args) + "\\n")
if "--version" in args:
    release = os.environ.get("FAKE_NVCC_RELEASE", "12.4")
    print("nvcc: NVIDIA (R) Cuda compiler")
    print(f"Cuda compilation tools, release {{release}}, V{{release}}.131")
    sys.exit(0)
if os.environ.get("FAKE_NVCC_FAIL"):
    print("error: the fake nvcc refuses")
    sys.exit(1)
time.sleep(float(os.environ.get("FAKE_NVCC_SLEEP", "0")))
with open(args[args.index("-o") + 1], "w") as f:
    f.write("fake " + " ".join(args))
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A fake ``nvcc`` first on ``PATH``; the package's ``_build/`` moved to
    an empty temporary directory and no cache directory set.  Yields the
    log of its calls."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    log.touch()
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "pkg_build")
    monkeypatch.setattr(_build, "_cache_dir", None)
    monkeypatch.setattr(_build, "found", {})
    yield log


def _compiles(log: Path):
    return [c for c in log.read_text().splitlines() if " -c " in f" {c} "]


def _links(log: Path):
    return [c for c in log.read_text().splitlines()
            if " -shared " in f" {c} "]


def test_builds_into_the_cache_dir(fake_nvcc, tmp_path):
    cache = tmp_path / "cache"
    _build.set_cache_dir(cache)
    path = _build.build()
    assert path.parent == cache
    assert path.name == f"libtj_kernels_{_build.source_tag()}.so"
    assert path.read_text().startswith("fake ") and "-shared" in \
        path.read_text()
    assert _build.found["how"] == "built" and _build.found["build_s"] > 0
    assert len(_compiles(fake_nvcc)) == N_SOURCES
    assert len(_links(fake_nvcc)) == 1
    assert (cache / f"{_build.source_tag()}.log").exists()
    assert not _build.BUILD_DIR.exists()
    # Nothing half-written is left beside it.
    assert not [p for p in cache.iterdir() if p.name.startswith("build-")]


def test_a_second_call_runs_no_compile(fake_nvcc, tmp_path):
    _build.set_cache_dir(tmp_path / "cache")
    first = _build.build()
    n = len(_compiles(fake_nvcc))
    assert _build.build() == first
    assert _build.found["how"] == "cache hit"
    assert len(_compiles(fake_nvcc)) == n == N_SOURCES
    assert len(_links(fake_nvcc)) == 1


def test_a_library_in_the_package_build_is_found(fake_nvcc, tmp_path):
    _build.BUILD_DIR.mkdir()
    shipped = _build.BUILD_DIR / f"libtj_kernels_{_build.source_tag()}.so"
    shipped.write_text("shipped")
    _build.set_cache_dir(tmp_path / "cache")
    assert _build.build() == shipped
    assert _build.found["how"] == "package _build"
    assert not _compiles(fake_nvcc)
    # The cache directory is only made where a build lands.
    assert not (tmp_path / "cache").exists()


def test_without_a_cache_dir_the_package_build_is_used(fake_nvcc):
    path = _build.build()
    assert path.parent == _build.BUILD_DIR
    assert _build.found["how"] == "built"
    assert _build.build() == path
    assert _build.found["how"] == "package _build"
    assert len(_compiles(fake_nvcc)) == N_SOURCES


def test_the_toolkit_is_part_of_the_tag(fake_nvcc, monkeypatch, tmp_path):
    monkeypatch.setenv("FAKE_NVCC_RELEASE", "12.4")
    tag = _build.source_tag()
    assert "release 12.4" in _build.toolkit()
    monkeypatch.setenv("FAKE_NVCC_RELEASE", "12.8")
    assert _build.source_tag() != tag
    monkeypatch.setenv("FAKE_NVCC_RELEASE", "12.4")
    assert _build.source_tag() == tag
    monkeypatch.setattr(torch.version, "cuda", "12.1")
    assert "torch.version.cuda 12.1" in _build.toolkit()
    assert _build.source_tag() != tag
    # A library of another toolkit is not loaded: it is built again.
    _build.set_cache_dir(tmp_path / "cache")
    old = _build.build()
    monkeypatch.setenv("FAKE_NVCC_RELEASE", "12.8")
    assert _build.build() != old and _build.found["how"] == "built"


BUILD_PROCESS = """
import sys
from pathlib import Path
sys.path.insert(0, {root!r})
from trainingjob_operator_tpu_torch.ops import _build
_build.BUILD_DIR = Path({pkg_build!r})
_build.set_cache_dir({cache!r})
print(_build.build(), _build.found["how"], flush=True)
"""


def test_concurrent_builds_share_one_library(fake_nvcc, tmp_path):
    cache = tmp_path / "cache"
    code = BUILD_PROCESS.format(root=str(ROOT), pkg_build=str(_build.BUILD_DIR),
                          cache=str(cache))
    env = {**os.environ, "FAKE_NVCC_SLEEP": "0.5"}
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    results = [out.strip().splitlines()[-1].split() for out in outs]
    assert results[0][0] == results[1][0]
    assert sorted(r[1] for r in results) == ["built", "cache"]
    lib = Path(results[0][0])
    assert lib.parent == cache and "-shared" in lib.read_text()
    # One process compiled every source once; the other waited and loaded.
    assert len(_compiles(fake_nvcc)) == N_SOURCES
    assert len(_links(fake_nvcc)) == 1


def test_an_unwritable_cache_dir_raises(fake_nvcc, tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    _build.set_cache_dir(blocker / "cache")
    with pytest.raises(RuntimeError, match="not writable"):
        _build.build()
    assert not _compiles(fake_nvcc)


def test_a_failed_build_raises(fake_nvcc, monkeypatch, tmp_path):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    cache = tmp_path / "cache"
    _build.set_cache_dir(cache)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert not list(cache.glob("*.so"))
    assert not [p for p in cache.iterdir() if p.name.startswith("build-")]


def test_library_announces_where_it_loaded_from(fake_nvcc, monkeypatch,
                                                tmp_path, capsys):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: mock.MagicMock())
    cache = tmp_path / "cache"
    _build.set_cache_dir(cache)
    _build.library()
    line = capsys.readouterr().out.strip()
    assert line.startswith(f"kernels: loaded {cache}{os.sep}libtj_kernels_")
    assert "(built in " in line and line.endswith(" s)")
    monkeypatch.setattr(_build, "_lib", None)
    _build.library()
    assert capsys.readouterr().out.strip().endswith("(cache hit)")


# -- the tiny trainer restarted on the CPU ----------------------------------

STEPS, HALF = 8, 4


def _trainers(sink, runs):
    """Run one trainer process per ``(job, ckpt, steps, extra env)``, all
    started together; returns each one's output lines."""
    procs = []
    try:
        for job, ckpt, steps, extra in runs:
            env = dict(os.environ)
            env.pop("PYTHONPATH", None)
            env.update({"LLAMA_CONFIG": "tiny", "LLAMA_DTYPE": "float32",
                        "LLAMA_BATCH": "4", "LLAMA_SEQ": "16",
                        "LLAMA_STEPS": str(steps), "LLAMA_CKPT_EVERY": "2",
                        "TRAININGJOB_CHECKPOINT_DIR": ckpt,
                        "TRAININGJOB_TELEMETRY_ADDR": sink.address,
                        "TRAININGJOB_NAMESPACE": "t",
                        "TRAININGJOB_NAME": job, "OMP_NUM_THREADS": "1",
                        **extra})
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "trainingjob_operator_tpu_torch.workloads.llama_elastic",
                 "--device", "cpu"], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=90)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * len(runs), outs
    return [out.splitlines() for out in outs]


@pytest.fixture(scope="module")
def restarts(tmp_path_factory):
    """An uninterrupted run beside one that stops at step HALF; then two
    restarts of copies of its checkpoint, overlapped and serial."""
    work = tmp_path_factory.mktemp("recovery")
    sink = Sink()
    out = {}
    try:
        plain, first = _trainers(sink, [
            ("plain", str(work / "plain"), STEPS, {}),
            ("first", str(work / "first"), HALF, {})])
        out["first"] = first
        shutil.copytree(work / "first", work / "serial")
        overlapped, serial = _trainers(sink, [
            ("overlapped", str(work / "first"), STEPS, {}),
            ("serial", str(work / "serial"), STEPS,
             {constants.RESUME_OVERLAP_ENV: "0"})])
        out.update(lines={"overlapped": overlapped, "serial": serial},
                   dir=work)
        out["losses"] = {job: {r["step"] + 1: r["loss"]
                               for r in sink.records_of(f"t/{job}", "step")}
                         for job in ("plain", "first", "overlapped",
                                     "serial")}
        out["resumes"] = {job: sink.records_of(f"t/{job}",
                                               "resume_restore_ms")
                          for job in ("overlapped", "serial")}
    finally:
        sink.close()
    return out


def _timing(lines):
    found = [ln for ln in lines if ln.startswith("recovery_timing init_s")]
    assert len(found) == 1, lines
    return dict(f.split("=", 1) for f in found[0].split()[1:])


@pytest.mark.parametrize("job,overlap", [("overlapped", "1"),
                                         ("serial", "0")])
def test_a_restart_prints_jax_recovery_timing(restarts, job, overlap):
    lines = restarts["lines"][job]
    assert f"resumed at step {HALF} (width 1)" in lines
    timing = _timing(lines)
    assert list(timing) == ["init_s", "setup_s", "restore_s", "compile_s",
                            "resume_phases_wall_s", "resume_overlap"]
    assert timing["resume_overlap"] == overlap
    assert float(timing["compile_s"]) >= 0
    assert float(timing["resume_phases_wall_s"]) >= 0


@pytest.mark.parametrize("job,overlap", [("overlapped", True),
                                         ("serial", False)])
def test_the_resume_record_carries_the_warm_up(restarts, job, overlap):
    records = restarts["resumes"][job]
    assert len(records) == 1
    assert records[0]["resume_compile_ms"] >= 0
    assert records[0]["resume_restore_ms"] >= 0
    assert records[0]["resume_overlapped"] is overlap


@pytest.mark.parametrize("job", ["overlapped", "serial"])
def test_a_restart_continues_bit_for_bit(restarts, job):
    want = restarts["losses"]["plain"]
    assert sorted(want) == list(range(1, STEPS + 1))
    assert restarts["losses"]["first"] == {k: want[k]
                                           for k in range(1, HALF + 1)}
    got = restarts["losses"][job]
    assert got == {k: want[k] for k in range(HALF + 1, STEPS + 1)}
    # The first start made the kernel cache under the checkpoint root.
    assert (restarts["dir"] / "first" / ".torch_kernel_cache").is_dir()
