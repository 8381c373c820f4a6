"""The port's elastic resize in place against the JAX package's.

- Plan arithmetic (``parallel/reshard.py``): ``shard_ranges``,
  ``plan_exchange`` and ``plan_pytree_exchange`` equal JAX's over a grid of
  (n, old, new, lost); the port's ``redistribute`` cuts a process's live
  blocks onto a new mesh's, on their device, and refuses a block it does
  not hold.
- The rendezvous layer (``workloads/rendezvous.py``): the cases of
  tests/test_rendezvous_live.py (fault knob, coordinator barrier, watcher
  re-entry, rebootstrap phases) and the generation-channel cases of
  tests/test_reshard.py, run against both packages and compared.
- Peer-loss classification: the same exception chains get the same
  answer in both packages, and torch.distributed's transport errors are
  peer loss.
- Telemetry: the port's rendezvous record has JAX's keys and reaches the
  JAX controller's incident recorder.
- The slice as a whole: JAX ``llama_elastic.main`` and the port's
  ``main(["--device", "cpu"])`` in process, under TestFallbackLadder's
  environment, print the same ladder (exit code, the step the resize was
  observed at, every ``resize_rung`` line, the step resumed at, the final
  width) for every fault; through a live resize the port's losses equal
  an uninterrupted run's.
"""

import json
import os
import re
import socket
import socketserver
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

from trainingjob_operator_tpu.api import constants as jconst  # noqa: E402
from trainingjob_operator_tpu.obs.goodput import GoodputTracker  # noqa: E402
from trainingjob_operator_tpu.obs.incident import IncidentRecorder  # noqa: E402
from trainingjob_operator_tpu.obs.telemetry import (  # noqa: E402
    TelemetryAggregator,
    TelemetryEmitter as JEmitter,
)
from trainingjob_operator_tpu.parallel import reshard as jreshard  # noqa: E402
from trainingjob_operator_tpu.utils.metrics import MetricsRegistry  # noqa: E402
from trainingjob_operator_tpu.workloads import rendezvous as jrdv  # noqa: E402
from trainingjob_operator_tpu.workloads import train as jtrain  # noqa: E402
from trainingjob_operator_tpu_torch import constants as tconst  # noqa: E402
from trainingjob_operator_tpu_torch.models import llama as tllama  # noqa: E402
from trainingjob_operator_tpu_torch.obs.telemetry import (  # noqa: E402
    TelemetryEmitter as TEmitter,
)
from trainingjob_operator_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import reshard as treshard  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import sharding  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import rendezvous as trdv  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import train as ttrain  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
JOB = "default/rdvjob"
#: A live resize keeps the state and the batches: the losses after it
#: equal the uninterrupted run's to the last bit; the limit allows one
#: rounding.
TRAJ_RTOL = 1e-6


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- plan arithmetic ----------------------------------------------------------

PLAN_GRID = [
    (8, 4, 2, ()), (8, 2, 4, ()), (10, 4, 3, ()), (10, 3, 4, ()),
    (2, 4, 2, ()), (3, 1, 5, ()), (0, 2, 3, ()), (4096, 7, 6, ()),
    (8, 4, 2, (3,)), (8, 4, 2, (0, 1)), (10, 3, 2, (2,)), (5, 8, 3, (6,)),
    (7, 1, 1, ()), (7, 1, 1, (0,)),
]


@pytest.mark.parametrize("n,old,new,lost", PLAN_GRID)
def test_plan_exchange_equals_jax(n, old, new, lost):
    assert treshard.shard_ranges(n, old) == jreshard.shard_ranges(n, old)
    assert treshard.shard_ranges(n, new) == jreshard.shard_ranges(n, new)
    got = treshard.plan_exchange(n, old, new, lost)
    want = jreshard.plan_exchange(n, old, new, lost)
    seg = [(s.dst, s.src, s.start, s.stop) for s in got.segments]
    assert seg == [(s.dst, s.src, s.start, s.stop) for s in want.segments]
    assert got.covered == want.covered
    for itemsize in (1, 4):
        assert got.stats(itemsize) == want.stats(itemsize)
    # The segments partition [0, n) exactly.
    assert sorted(x for s in got.segments for x in range(s.start, s.stop)) \
        == list(range(n))


@pytest.mark.parametrize("bad", [(-1, 2), (4, 0)])
def test_shard_ranges_refuse_bad_inputs(bad):
    for mod in (treshard, jreshard):
        with pytest.raises(ValueError):
            mod.shard_ranges(*bad)


@pytest.mark.parametrize("old,new,lost", [(4, 2, ()), (4, 2, (0,)),
                                          (2, 4, ()), (3, 3, (1,))])
def test_plan_pytree_exchange_equals_jax(old, new, lost):
    cfg = tllama.LlamaConfig.tiny()
    shapes = {p: tuple(s) for p, s in
              sharding.tree_paths(tllama.param_shapes(cfg))}
    shapes["scalar"] = ()
    got = treshard.plan_pytree_exchange(shapes, old, new, lost)
    want = jreshard.plan_pytree_exchange(shapes, old, new, lost)
    assert set(got["plans"]) == set(want["plans"])
    for key in ("covered", "moved_bytes", "stationary_bytes",
                "missing_bytes"):
        assert got[key] == want[key]


# -- redistribute -------------------------------------------------------------


class _FakeMesh:
    """The ``sizes`` / ``size`` / ``coord`` of one rank of a mesh, without
    a process group (block arithmetic only)."""

    def __init__(self, coords, **sizes):
        self.sizes, self._coords = sizes, coords

    def size(self, axis):
        return self.sizes.get(axis, 1)

    def coord(self, axis):
        return self._coords.get(axis, 0)


def _tree():
    gen = torch.Generator().manual_seed(0)
    return {"a": torch.randn(8, 4, generator=gen).requires_grad_(True),
            "b": {"c": torch.randn(6, generator=gen)}, "count": 3}


def test_redistribute_keeps_an_unchanged_block_as_it_is():
    tree = _tree()
    out = treshard.redistribute(tree, None, None)
    assert out["a"] is tree["a"] and out["b"]["c"] is tree["b"]["c"]
    assert out["count"] == 3


def test_redistribute_cuts_the_new_block_from_the_held_one():
    tree = _tree()
    rules = [(r"^a$", ("fsdp", None))]
    shapes = {"a": (8, 4), "b": {"c": (6,)}}
    whole = sharding.tree_blocks(shapes, rules, _FakeMesh({}, fsdp=1))
    for rank in range(2):
        new = sharding.tree_blocks(shapes, rules,
                                   _FakeMesh({"fsdp": rank}, fsdp=2))
        out = treshard.redistribute(tree, whole, new)
        assert torch.equal(out["a"], tree["a"][4 * rank:4 * rank + 4])
        assert out["a"].requires_grad and out["a"].is_leaf
        assert out["b"]["c"] is tree["b"]["c"]


def test_redistribute_refuses_a_block_it_does_not_hold():
    rules = [(r"^a$", ("fsdp", None))]
    shapes = {"a": (8, 4)}
    half = sharding.tree_blocks(shapes, rules,
                                _FakeMesh({"fsdp": 1}, fsdp=2))
    whole = sharding.tree_blocks(shapes, rules, _FakeMesh({}, fsdp=1))
    tree = {"a": torch.zeros(4, 4)}
    with pytest.raises(trdv.RebootstrapError) as ei:
        treshard.redistribute(tree, half, whole)
    assert ei.value.phase == "reshard" and not ei.value.injected


@pytest.mark.parametrize("n_dev,slices,tp", [(4, 1, 1), (4, 2, 1),
                                             (6, 4, 1), (8, 2, 2),
                                             (2, 1, 2)])
def test_resized_mesh_spec_is_the_jax_cycle_arithmetic(n_dev, slices, tp):
    spec = tmesh.resized_mesh_spec(n_dev, slices, tp)
    data = n_dev // tp
    dp = slices if data % slices == 0 else 1
    assert spec.sizes == {"dp": dp, "pp": 1, "fsdp": data // dp, "tp": tp,
                          "sp": 1}
    with pytest.raises(ValueError):
        tmesh.resized_mesh_spec(3, 1, 2)


# -- rendezvous layer, both packages ------------------------------------------

PKGS = {"jax": (jrdv, jconst, jrdv.rebootstrap_jax_distributed),
        "torch": (trdv, tconst, trdv.rebootstrap_distributed)}


def both(fn):
    """``fn(rendezvous module, constants module, rebootstrap)`` on each
    package, as {name: result or the exception's (type, phase,
    injected)}."""
    out = {}
    for name, (mod, const, reboot) in PKGS.items():
        try:
            out[name] = fn(mod, const, reboot)
        except Exception as exc:
            out[name] = (type(exc).__name__, getattr(exc, "phase", None),
                         getattr(exc, "injected", None))
    return out


def test_env_names_agree():
    for name in ("RESIZE_DIR_ENV", "RENDEZVOUS_GENERATION_ENV",
                 "RESIZE_POLL_ENV", "RESIZE_FASTPATH_ENV", "RESIZE_LIVE_ENV",
                 "RESIZE_BARRIER_ENV", "RESIZE_FAULT_ENV"):
        assert getattr(tconst, name) == getattr(jconst, name)
    assert trdv.REBOOTSTRAP_PHASES == jrdv.REBOOTSTRAP_PHASES
    assert trdv.REBOOTSTRAP_RUNGS == jrdv.REBOOTSTRAP_RUNGS


@pytest.mark.parametrize("knob", ["", "barrier@3, persist", "warpcore,barrier",
                                  "barrier@soon,reinit@2",
                                  "shutdown,barrier,reinit,reshard,persist"])
def test_resize_faults_parity(knob):
    got = both(lambda m, c, r: m.resize_faults({c.RESIZE_FAULT_ENV: knob}))
    assert got["torch"] == got["jax"]
    assert trdv.resize_faults({}) == {}


@pytest.mark.parametrize("phase,gen,faults", [
    ("barrier", 1, {"barrier": None}), ("barrier", 7, {"barrier": None}),
    ("barrier", 1, {"barrier": 2}), ("barrier", 2, {"barrier": 2}),
    ("reinit", 1, {"barrier": None}), ("reinit", 1, {})])
def test_check_fault_parity(phase, gen, faults):
    got = both(lambda m, c, r: m.check_fault(phase, gen, faults=faults))
    assert got["torch"] == got["jax"]
    fires = phase in faults and faults[phase] in (None, gen)
    assert got["torch"] == (("RebootstrapError", phase, True) if fires
                            else None)


@pytest.mark.parametrize("value", [None, "5.5", "0.0001", "soon"])
def test_barrier_timeout_parity(value):
    got = both(lambda m, c, r: m.barrier_timeout_s(
        {} if value is None else {c.RESIZE_BARRIER_ENV: value}))
    assert got["torch"] == got["jax"]


def test_unreachable_and_unparseable_coordinator_parity():
    addr = f"127.0.0.1:{free_port()}"
    got = both(lambda m, c, r: m._await_coordinator(
        addr, timeout=0.2, sleep=lambda _d: None))
    assert got["torch"] == got["jax"] == ("RebootstrapError", "barrier",
                                          False)
    got = both(lambda m, c, r: m._await_coordinator("not-an-address",
                                                    timeout=0.2))
    assert got["torch"] == got["jax"] == ("RebootstrapError", "barrier",
                                          False)


def test_live_and_late_coordinator_pass():
    for mod in (trdv, jrdv):
        with socket.socket() as srv:
            srv.bind(("127.0.0.1", 0))
            srv.listen(1)
            mod._await_coordinator("127.0.0.1:%d" % srv.getsockname()[1],
                                   timeout=2.0)
        srv = socket.socket()
        try:
            srv.bind(("127.0.0.1", 0))
            timer = threading.Timer(0.1, srv.listen, args=(1,))
            timer.start()
            try:
                mod._await_coordinator(
                    "127.0.0.1:%d" % srv.getsockname()[1], timeout=5.0)
            finally:
                timer.cancel()
        finally:
            srv.close()


def _write(path, generation, world, mtime):
    path.write_text('{"generation": %d, "world": %s}'
                    % (generation, list(world)))
    os.utime(path, (mtime, mtime))


def _watcher_script(mod, tmp_path, case):
    """One watcher scenario of the JAX suites; returns what each poll
    surfaced."""
    p = tmp_path / f"{mod.__name__.split('.')[0]}-{case}.json"
    seen = []
    if case == "second_bump":
        w = mod.GenerationWatcher(path=str(p), birth=0, interval=0.0)
        _write(p, 1, [0, 1, 2], 100.0)
        seen.append(w.poll(now=1.0))
        w.reenter(1)
        seen.append(w.pending)
        _write(p, 2, [0, 1], 200.0)
        seen.append(w.poll(now=2.0))
    elif case == "replay":
        w = mod.GenerationWatcher(path=str(p), birth=0, interval=0.0)
        _write(p, 1, [0, 1], 100.0)
        seen.append(w.poll(now=1.0))
        w.reenter(1)
        _write(p, 1, [0, 1], 300.0)
        seen.append(w.poll(now=2.0))
        _write(p, 0, [0], 400.0)
        seen.append(w.poll(now=3.0))
    elif case == "no_rewind":
        w = mod.GenerationWatcher(path=str(p), birth=5, interval=0.0)
        w.reenter(2)
        seen.append(w.seen)
        _write(p, 4, [0], 100.0)
        seen.append(w.poll(now=1.0))
    elif case == "birth":
        _write(p, 3, [0, 1], 100.0)
        w = mod.GenerationWatcher(path=str(p), birth=3, interval=0.0)
        seen.append(w.poll(now=0.0))
        _write(p, 4, [0], 200.0)
        seen.append(w.poll(now=1.0))
    elif case == "once":
        w = mod.GenerationWatcher(path=str(p), birth=0, interval=0.0)
        seen.append(w.poll(now=0.0))
        _write(p, 1, [0, 2], 100.0)
        seen.append(w.poll(now=1.0))
        seen.append(w.poll(now=2.0))
    elif case == "rate_limit":
        _write(p, 1, [0], 100.0)
        w = mod.GenerationWatcher(path=str(p), birth=0, interval=10.0)
        seen.append(w.poll(now=0.0))
        _write(p, 2, [0], 200.0)
        seen.append(w.poll(now=5.0))
        seen.append(w.poll(now=11.0))
    return seen


@pytest.mark.parametrize("case", ["second_bump", "replay", "no_rewind",
                                  "birth", "once", "rate_limit"])
def test_generation_watcher_parity(tmp_path, case):
    got = _watcher_script(trdv, tmp_path, case)
    assert got == _watcher_script(jrdv, tmp_path, case)
    assert any(x is not None for x in got)


def test_read_generation_parity(tmp_path):
    path = str(tmp_path / "generation.json")
    assert trdv.read_generation(path) is None is jrdv.read_generation(path)
    docs = ['{"generation": 2, "world": [0, 2], "num_processes": 2}',
            "not json", json.dumps([1, 2]),
            json.dumps({"generation": "2", "world": [0]}),
            json.dumps({"generation": 0, "world": [0]}),
            json.dumps({"generation": 2, "world": "0,1"})]
    for raw in docs:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(raw)
        assert trdv.read_generation(path) == jrdv.read_generation(path)
    assert trdv.read_generation(path) is None


def test_from_env_reads_the_resize_channel():
    env = {tconst.JOB_NAME_ENV: "j", tconst.RESIZE_DIR_ENV: "/rdv/j",
           tconst.RENDEZVOUS_GENERATION_ENV: "5"}
    got, want = trdv.from_env(env), jrdv.from_env(env)
    assert (got.resize_dir, got.rendezvous_generation,
            got.generation_path) == (want.resize_dir,
                                     want.rendezvous_generation,
                                     want.generation_path)
    assert trdv.Rendezvous().generation_path == ""


def _fields(rdv):
    return (rdv.num_processes, rdv.process_id, rdv.coordinator_address,
            rdv.rendezvous_generation, rdv.elastic_replicas)


def test_rebootstrap_single_process_passthrough():
    def run(m, c, reboot):
        rdv = m.Rendezvous(num_processes=1, process_id=0,
                           rendezvous_generation=0, elastic_replicas=4)
        new, timings = reboot(rdv, {"generation": 1, "world": [0, 1]})
        return _fields(new), sorted(timings)
    got = both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"] == ((1, 0, "", 1, 2),
                            ["barrier_ms", "reinit_ms", "shutdown_ms"])


def test_rebootstrap_survivor_absent_from_world_degrades_at_reinit():
    got = both(lambda m, c, reboot: reboot(
        m.Rendezvous(num_processes=2, process_id=1,
                     coordinator_address="127.0.0.1:1"),
        {"generation": 1, "world": [0]}, old_world=[0, 1]))
    assert got["torch"] == got["jax"] == ("RebootstrapError", "reinit",
                                          False)


def test_rebootstrap_dead_coordinator_degrades_at_barrier(monkeypatch):
    monkeypatch.setenv(tconst.RESIZE_BARRIER_ENV, "0.3")
    addr = f"127.0.0.1:{free_port()}"
    got = both(lambda m, c, reboot: reboot(
        m.Rendezvous(num_processes=2, process_id=1,
                     coordinator_address=addr),
        {"generation": 1, "world": [0, 1]}, old_world=[0, 1],
        sleep=lambda _d: None))
    assert got["torch"] == got["jax"] == ("RebootstrapError", "barrier",
                                          False)


@pytest.mark.parametrize("fault", ["shutdown", "barrier", "reinit",
                                   "barrier@7"])
def test_rebootstrap_injected_faults(monkeypatch, fault):
    monkeypatch.setenv(tconst.RESIZE_FAULT_ENV, fault)
    got = both(lambda m, c, reboot: _fields(reboot(
        m.Rendezvous(num_processes=1), {"generation": 1, "world": [0]})[0]))
    assert got["torch"] == got["jax"]
    if "@" in fault:
        assert got["torch"] == (1, 0, "", 1, 1)
    else:
        assert got["torch"] == ("RebootstrapError", fault, True)


def test_rebootstrap_reforms_a_group_of_one_at_one_address():
    """A coordinator at one process forms a group of one; each resize
    destroys it and forms it again at the same address (one store served
    by this process, a prefix per generation)."""
    import torch.distributed as dist

    addr = f"127.0.0.1:{free_port()}"
    rdv = trdv.Rendezvous(coordinator_address=addr)
    trdv.initialize_distributed(rdv, torch.device("cpu"))
    try:
        for generation in (1, 2):
            rdv, timings = trdv.rebootstrap_distributed(
                rdv, {"generation": generation, "world": [0],
                      "coordinator": addr})
            assert dist.is_initialized() and dist.get_world_size() == 1
            mesh = tmesh.make_mesh(tmesh.mesh_spec_from_rendezvous(rdv),
                                   "cpu")
            x = torch.ones(2)
            dist.all_reduce(x, group=mesh.group("fsdp"))
            assert x.tolist() == [1.0, 1.0]
            assert rdv.rendezvous_generation == generation
            assert set(timings) == {"shutdown_ms", "barrier_ms",
                                    "reinit_ms"}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# -- peer loss -----------------------------------------------------------------


def _chain(outer, inner, explicit):
    try:
        try:
            raise inner
        except BaseException as err:
            if explicit:
                raise outer from err
            raise outer
    except BaseException as got:
        return got


def _suppressed():
    try:
        try:
            raise ConnectionResetError("connection reset by peer")
        except ConnectionResetError:
            raise OSError("write failed") from None
    except OSError as got:
        return got


CHAINS = {
    "gloo_read": ValueError("UNKNOWN: Gloo AllGather failed: Read error "
                            "[127.0.0.1]:25483: Connection reset by peer"),
    "heartbeat": RuntimeError("Coordination service agent heartbeat "
                              "timeout"),
    "reshape": ValueError("cannot reshape array of shape (2, 32) into "
                          "(3, 3)"),
    "key": KeyError("params"),
    "gloo_closed": RuntimeError(
        "[../third_party/gloo/gloo/transport/tcp/pair.cc:534] Connection "
        "closed by peer [127.0.0.1]:40213"),
    "explicit_cause": _chain(RuntimeError("save failed for step 40"),
                             ConnectionError("connection reset by peer"),
                             True),
    "implicit_from_bug": _chain(ValueError("shape mismatch in restore"),
                                ConnectionError("connection reset by peer"),
                                False),
    "implicit_from_io": _chain(OSError("write failed"),
                               ConnectionResetError("connection reset by "
                                                    "peer"), False),
    "suppressed": _suppressed(),
    "plain_runtime": RuntimeError("CUDA error: an illegal memory access"),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_peer_loss_classification_equals_jax(name):
    exc = CHAINS[name]
    assert ttrain.looks_like_peer_loss(exc) == jtrain.looks_like_peer_loss(
        exc)


def test_torch_transport_errors_are_peer_loss():
    import torch.distributed as dist

    for cls in (dist.DistNetworkError, dist.DistBackendError):
        exc = cls("failed to recv, got 0 bytes")
        assert ttrain.looks_like_peer_loss(exc)
        assert ttrain.looks_like_peer_loss(
            _chain(RuntimeError("checkpoint write failed"), exc, True))
        # A local bug raised while handling one does not inherit it.
        assert not ttrain.looks_like_peer_loss(
            _chain(ValueError("shape mismatch"), exc, False))


def test_peer_loss_guard_lets_a_local_bug_through():
    with pytest.raises(ValueError, match="reshape"):
        with ttrain.peer_loss_guard():
            raise ValueError("cannot reshape array")
    # Without a group of more than one, even a transport error propagates.
    with pytest.raises(RuntimeError, match="Connection closed by peer"):
        with ttrain.peer_loss_guard():
            raise RuntimeError("Connection closed by peer")


# -- telemetry -----------------------------------------------------------------


def _records(emitter_cls, monkeypatch, **kw):
    monkeypatch.setenv(tconst.TELEMETRY_ADDR_ENV, "127.0.0.1:1")
    monkeypatch.setenv(tconst.JOB_NAMESPACE_ENV, "default")
    monkeypatch.setenv(tconst.JOB_NAME_ENV, "rdvjob")
    sent = []
    emitter = emitter_cls()
    monkeypatch.setattr(emitter, "_send", sent.append)
    emitter.emit_rendezvous(**kw)
    return sent


@pytest.mark.parametrize("kw", [
    {"total_ms": 600.0, "rung": "live",
     "phase_ms": {"shutdown_ms": 100.0, "barrier_ms": 450.0,
                  "reinit_ms": 50.0}},
    {"total_ms": 900.0, "rung": "checkpoint", "reason": "barrier: x"},
    {"total_ms": 12.3456, "rung": "restart_all", "reason": "persist: y"}])
def test_rendezvous_record_has_the_jax_keys(monkeypatch, kw):
    (got,) = _records(TEmitter, monkeypatch, **kw)
    (want,) = _records(JEmitter, monkeypatch, **kw)
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k != "ts"} == \
        {k: v for k, v in want.items() if k != "ts"}


def test_rendezvous_record_routes_to_the_incident(monkeypatch):
    (record,) = _records(TEmitter, monkeypatch, total_ms=600.0, rung="live",
                         phase_ms={"barrier": 450.0})
    rec = IncidentRecorder(metrics=MetricsRegistry(), ring=64, keep=4)
    metrics = MetricsRegistry()
    agg = TelemetryAggregator(metrics=metrics,
                              goodput=GoodputTracker(metrics=metrics),
                              incidents=rec)
    rec.on_interruption(JOB, "Resize", jconst.RESIZE_STARTED_REASON,
                        now=100.0)
    rec.record_event(JOB, jconst.RESIZE_STARTED_REASON, "shrink", ts=100.2)
    rec.on_running(JOB, now=101.0)
    assert agg.ingest(record, now=100.6)
    (bundle,) = rec.bundles(JOB)
    assert bundle["rung"] == "live"


# -- the slice as a whole, against JAX ------------------------------------------


def _ladder_env(monkeypatch, tmp_path, fault, ckpt):
    rdv_dir = tmp_path / "rdv"
    rdv_dir.mkdir(exist_ok=True)
    (rdv_dir / "generation.json").write_text(
        json.dumps({"generation": 1, "world": [0, 1]}))
    monkeypatch.setenv("LLAMA_STEPS", "6")
    monkeypatch.setenv("LLAMA_CKPT_EVERY", "2")
    monkeypatch.setenv("LLAMA_BATCH", "8")
    monkeypatch.setenv("LLAMA_SEQ", "32")
    monkeypatch.setenv(tconst.CHECKPOINT_DIR_ENV, str(tmp_path / ckpt))
    monkeypatch.setenv(tconst.ELASTIC_REPLICAS_ENV, "4")
    monkeypatch.setenv(tconst.RESIZE_DIR_ENV, str(rdv_dir))
    monkeypatch.setenv(tconst.RESIZE_POLL_ENV, "0")
    monkeypatch.setenv(tconst.RESIZE_FAULT_ENV, fault)
    monkeypatch.delenv(tconst.RENDEZVOUS_GENERATION_ENV, raising=False)


def ladder(out):
    """What the two packages must agree on in a run's output."""
    lines = out.splitlines()

    def first(pattern):
        found = [m.group(1) for m in map(re.compile(pattern).search, lines)
                 if m]
        return found[0] if found else None
    return {"observed": first(r"observed at step (\d+)"),
            "rungs": [ln for ln in lines if ln.startswith("resize_rung ")],
            "resuming": first(r"resuming at step (\d+)"),
            "width": first(r"^done: .* width=(\d+) ")}


@pytest.mark.parametrize("fault,rc,rungs", [
    ("", 0, ["live"]), ("barrier", 143, ["checkpoint"]),
    ("barrier,persist", 143, ["checkpoint", "restart_all"]),
    ("reshard", 143, ["checkpoint"]), ("shutdown@1", 143, ["checkpoint"]),
    ("shutdown@2", 0, ["live"])])
def test_the_ladder_equals_jax_main(monkeypatch, tmp_path, capsys, fault, rc,
                                    rungs):
    from trainingjob_operator_tpu.workloads import llama_elastic as jle
    from trainingjob_operator_tpu_torch.workloads import llama_elastic as tle

    _ladder_env(monkeypatch, tmp_path, fault, "jax")
    capsys.readouterr()
    want_rc = jle.main()
    want = ladder(capsys.readouterr().out)
    _ladder_env(monkeypatch, tmp_path, fault, "torch")
    got_rc = tle.main(["--device", "cpu"])
    got = ladder(capsys.readouterr().out)
    assert (got_rc, got) == (want_rc, want)
    assert got_rc == rc
    assert [re.search(r"rung=(\w+)", ln).group(1)
            for ln in got["rungs"]] == rungs
    if rc == 143:
        assert got["resuming"] is None and got["width"] is None
        # The checkpoint rung committed the interrupted step; a failed
        # persist left none.
        steps = ttrain.committed_steps(str(tmp_path / "torch" / "llama"))
        assert steps == ([] if "persist" in fault
                         else [int(got["observed"])])
    else:
        assert got["width"] == "2"
        assert got["resuming"] == got["observed"]


class _Sink:
    """A telemetry sink on localhost keeping every JSON record sent."""

    def __init__(self):
        records = self.records = []
        lock = self.lock = threading.Lock()

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    with lock:
                        records.append(json.loads(raw))

        self.server = socketserver.ThreadingTCPServer(("127.0.0.1", 0),
                                                      Handler)
        self.server.daemon_threads = True
        self.address = f"127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def losses(self, job):
        """Step (1-based) -> loss of ``job``, once its records stop
        coming (a step run twice keeps its last record)."""
        seen, since = -1, time.time()
        while time.time() - since < 0.5:
            with self.lock:
                got = {r["step"] + 1: r["loss"] for r in self.records
                       if r.get("job") == f"t/{job}" and "step" in r}
            if len(got) != seen:
                seen, since = len(got), time.time()
            time.sleep(0.05)
        return got

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)


@pytest.mark.parametrize("coordinator", [False, True])
def test_losses_through_a_live_resize_equal_an_uninterrupted_run(
        monkeypatch, tmp_path, capsys, coordinator):
    """tiny fp32 on the CPU: a live resize at step 3 (published while the
    run trains) keeps the state, the batch geometry and the batches, so
    the losses equal an uninterrupted run's; with a coordinator the group
    of one is destroyed and formed again at the same address."""
    from trainingjob_operator_tpu_torch.workloads import llama_elastic as tle

    sink = _Sink()
    try:
        for job, resize in (("plain", False), ("resized", True)):
            for key, value in {"LLAMA_CONFIG": "tiny",
                               "LLAMA_DTYPE": "float32", "LLAMA_STEPS": "6",
                               "LLAMA_CKPT_EVERY": "2", "LLAMA_BATCH": "4",
                               "LLAMA_SEQ": "16", "LLAMA_ACCUM": "2",
                               tconst.TELEMETRY_ADDR_ENV: sink.address,
                               tconst.JOB_NAMESPACE_ENV: "t",
                               tconst.JOB_NAME_ENV: job,
                               tconst.RESIZE_POLL_ENV: "0"}.items():
                monkeypatch.setenv(key, value)
            monkeypatch.delenv(tconst.CHECKPOINT_DIR_ENV, raising=False)
            if coordinator:
                monkeypatch.setenv(tconst.COORDINATOR_ADDRESS_ENV,
                                   f"127.0.0.1:{free_port()}")
            rdv_dir = tmp_path / job
            rdv_dir.mkdir()
            if resize:
                monkeypatch.setenv(tconst.RESIZE_DIR_ENV, str(rdv_dir))
                real = tle.make_step_fn

                def publishing(*a, **k):
                    step = real(*a, **k)
                    calls = []

                    def step_fn(tokens):
                        loss = step(tokens)
                        calls.append(1)
                        if len(calls) == 3:
                            (rdv_dir / "generation.json").write_text(
                                json.dumps({"generation": 1, "world": [0]}))
                        return loss
                    step_fn.opt = step.opt
                    return step_fn
                monkeypatch.setattr(tle, "make_step_fn", publishing)
            assert tle.main(["--device", "cpu"]) == 0
        out = capsys.readouterr().out
        got, want = sink.losses("resized"), sink.losses("plain")
    finally:
        sink.close()
    assert "resize_rung generation=1 rung=live phase=-" in out
    assert "resized in place: mesh" in out and "resuming at step 3" in out
    assert "fallback=0" in out and "moved_mb=0.0" in out
    assert sorted(got) == sorted(want) == list(range(1, 7))
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [want[k] for k in sorted(want)],
                               rtol=TRAJ_RTOL, atol=0)


def test_fast_path_off_checkpoints_and_exits_143(tmp_path):
    """``TRAININGJOB_RESIZE_FASTPATH=0``: the published generation saves
    the step it was observed at and exits 143 (the process ends by
    ``os._exit``, so it runs as its own process)."""
    rdv_dir = tmp_path / "rdv"
    rdv_dir.mkdir()
    (rdv_dir / "generation.json").write_text(
        json.dumps({"generation": 1, "world": [0]}))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update({"LLAMA_CONFIG": "tiny", "LLAMA_STEPS": "6",
                "LLAMA_BATCH": "4", "LLAMA_SEQ": "16",
                "OMP_NUM_THREADS": "1",
                tconst.CHECKPOINT_DIR_ENV: str(tmp_path / "ckpt"),
                tconst.RESIZE_DIR_ENV: str(rdv_dir),
                tconst.RESIZE_POLL_ENV: "0",
                tconst.RESIZE_FASTPATH_ENV: "0"})
    out = subprocess.run(
        [sys.executable, "-m",
         "trainingjob_operator_tpu_torch.workloads.llama_elastic",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=60)
    assert out.returncode == 143, out.stdout + out.stderr
    assert ("resize: generation 1 observed at step 1; fast path disabled, "
            "checkpointing for operator restart") in out.stdout
    assert ttrain.committed_steps(str(tmp_path / "ckpt" / "llama")) == [1]
