"""The port's trainer entry point as several processes on the CPU (gloo),
and its sharded checkpoints across widths.

The counterpart of tests/test_multiprocess.py: ``python -m
trainingjob_operator_tpu_torch.workloads.llama_elastic --device cpu`` run
as two processes through the operator's rendezvous env
(``TRAININGJOB_COORDINATOR_ADDRESS`` / ``_NUM_PROCESSES`` /
``_PROCESS_ID``) on a small corpus, the tiny config in fp32.  Per-step
losses come unrounded from each process's telemetry records.

- Both ranks train on the same global batches as one process and report
  the same losses, equal to the one-process run's within 1e-5.
- A checkpoint saved by two processes resumes at one (with a group of
  one), and one saved by one process resumes at two; the losses after the
  resume equal the uninterrupted run's within 1e-5.
- A step whose shard of one rank is missing is not restored: the restore
  falls back to the step before it.
- Elastic resize across processes: a rank whose peer is killed exits 143
  (``peer_loss_guard``); two ranks that see a new generation of the same
  world re-form their group in process and restore the last checkpoint
  (``fallback=1``); at a generation of one rank, rank 1 degrades to
  ``checkpoint`` then ``restart_all`` (143) while rank 0 restores at width
  1; and two processes rebootstrap twice at one coordinator address.

Every process gets a free port, runs under a timeout and is killed in a
``finally`` block.
"""

import json
import os
import shutil
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

from trainingjob_operator_tpu_torch.data import write_tokens
from trainingjob_operator_tpu_torch.models import llama as tllama
from trainingjob_operator_tpu_torch.parallel import sharding
from trainingjob_operator_tpu_torch.workloads import rendezvous
from trainingjob_operator_tpu_torch.workloads import train as ttrain

ROOT = Path(__file__).resolve().parent.parent
#: Two runs of the same training, one process against two, or resumed
#: against uninterrupted: the gradients are summed over ranks in another
#: order.
SELF_TOL = 1e-5
STEPS = 6
#: Seconds a trainer process may take.
TIMEOUT = 50

torch.set_num_threads(2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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

    def losses(self, job, rank):
        """Step (1-based) -> loss of one process of ``job``, once its
        records stop coming."""
        seen, since = -1, time.time()
        while time.time() - since < 0.5:
            with self.lock:
                got = {r["step"] + 1: r["loss"] for r in self.records
                       if r.get("job") == f"t/{job}" and r["rank"] == rank
                       and "step" in r}
            if len(got) != seen:
                seen, since = len(got), time.time()
            time.sleep(0.05)
        return got

    def resumes(self, job):
        with self.lock:
            return [r for r in self.records
                    if r.get("job") == f"t/{job}" and "resume_restore_ms" in r]

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)


def _train(sink, job, ckpt, world, corpus, steps=STEPS, coordinator=True,
           extra=None, rcs=None):
    """Run the trainer as ``world`` processes; returns each one's output
    lines.  ``coordinator=False`` runs one process without the rendezvous
    env (the single-process path and checkpoint format); ``extra`` is
    more env; ``rcs`` the exit codes expected (all 0 by default)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update({"LLAMA_CONFIG": "tiny", "LLAMA_DTYPE": "float32",
                "LLAMA_BATCH": "4", "LLAMA_SEQ": "16", "LLAMA_ACCUM": "2",
                "LLAMA_STEPS": str(steps), "LLAMA_CKPT_EVERY": "2",
                "LLAMA_DATA": corpus, "TRAININGJOB_CHECKPOINT_DIR": ckpt,
                "TRAININGJOB_TELEMETRY_ADDR": sink.address,
                "TRAININGJOB_NAMESPACE": "t", "TRAININGJOB_NAME": job,
                "TRAININGJOB_ELASTIC_REPLICAS": str(world),
                "OMP_NUM_THREADS": "1", **(extra or {})})
    if coordinator:
        env.update({"TRAININGJOB_COORDINATOR_ADDRESS":
                    f"127.0.0.1:{_free_port()}",
                    "TRAININGJOB_NUM_PROCESSES": str(world)})
    procs = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "trainingjob_operator_tpu_torch.workloads.llama_elastic",
                 "--device", "cpu"],
                env={**env, "TRAININGJOB_PROCESS_ID": str(rank),
                     "TRAININGJOB_REPLICA_INDEX": str(rank)},
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == (rcs or [0] * world), outs
    return [out.splitlines() for out in outs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process uninterrupted, two processes to step 4, and the two
    resumes across widths, with their checkpoint directories."""
    work = tmp_path_factory.mktemp("multiprocess")
    corpus = str(work / "c.tokens")
    write_tokens(corpus, np.random.default_rng(3).integers(0, 256, 4000),
                 vocab_size=256)
    sink = _Sink()
    out = {"dir": work, "corpus": corpus}
    try:
        out["one"] = _train(sink, "one", str(work / "one"), 1, corpus,
                            coordinator=False)
        out["two"] = _train(sink, "two", str(work / "two"), 2, corpus,
                            steps=4)
        # Two processes' checkpoint (steps 2 and 4) resumed at one; one
        # process's (steps 4 and 6) with step 6 taken away, at two.
        shutil.copytree(work / "two", work / "two_to_one")
        out["two_to_one"] = _train(sink, "two_to_one",
                                   str(work / "two_to_one"), 1, corpus)
        shutil.copytree(work / "one", work / "one_to_two")
        shutil.rmtree(work / "one_to_two" / "llama" / str(STEPS))
        out["one_to_two"] = _train(sink, "one_to_two",
                                   str(work / "one_to_two"), 2, corpus)
        out["losses"] = {(job, rank): sink.losses(job, rank)
                         for job, world in (("one", 1), ("two", 2),
                                            ("two_to_one", 1),
                                            ("one_to_two", 2))
                         for rank in range(world)}
        out["resumes"] = {job: sink.resumes(job)
                          for job in ("two_to_one", "one_to_two")}
    finally:
        sink.close()
    return out


def _close(got, want):
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [want[k] for k in sorted(want)],
                               rtol=SELF_TOL, atol=SELF_TOL)


def test_the_entry_point_as_two_processes(runs):
    want = runs["losses"][("one", 0)]
    assert sorted(want) == list(range(1, STEPS + 1))
    rank0, rank1 = (runs["losses"][("two", r)] for r in range(2))
    assert rank0 == rank1
    _close(rank0, {k: want[k] for k in range(1, 5)})
    printed = [[ln for ln in lines if ln.startswith("step ")]
               for lines in runs["two"]]
    assert printed[0] == printed[1] and len(printed[0]) == 2
    start = [ln for ln in runs["two"][0] if ln.startswith("width ")]
    assert "mesh {'dp': 1, 'pp': 1, 'fsdp': 2, 'tp': 1, 'sp': 1, " \
           "'ep': 1}" in start[0]
    assert sorted(os.listdir(runs["dir"] / "two" / "llama" / "4")) == [
        "shard-0.pt", "shard-1.pt"]


@pytest.mark.parametrize("job,world", [("two_to_one", 1), ("one_to_two", 2)])
def test_a_checkpoint_resumes_at_another_width(runs, job, world):
    want = runs["losses"][("one", 0)]
    for rank in range(world):
        _close(runs["losses"][(job, rank)],
               {k: want[k] for k in range(5, STEPS + 1)})
        assert f"resumed at step 4 (width {world})" in runs[job][rank]
    # The resume record: the image is never read across processes, and
    # the two processes' step 4 left none.  The kernels' warm-up ran
    # beside the restore (train.overlapped_restore).
    records = runs["resumes"][job]
    assert len(records) == world
    assert all(r["resume_compile_ms"] >= 0 and r["resume_overlapped"]
               for r in records)
    if world == 1:
        assert records[0]["resume_fallback"] == "missing"
    else:
        assert all("resume_fallback" not in r for r in records)


def _template():
    cfg = tllama.LlamaConfig(**{**tllama.LlamaConfig.tiny().__dict__,
                                "dtype": "float32"})
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                master=True)
    return {"params": params,
            "opt_state": ttrain.AdamW(params, 3e-4).state, "step": 0}


def test_a_sharded_step_reads_whole_in_one_process(runs):
    two = ttrain._read_step(str(runs["dir"] / "two" / "llama"), 4,
                            _template())
    one = ttrain._read_step(str(runs["dir"] / "one" / "llama"), 4,
                            _template())
    assert two["step"] == one["step"] == 4
    assert two["opt_state"]["count"] == one["opt_state"]["count"] == 4
    for (path, got), (_, want) in zip(
            sharding.tree_paths(two["params"]),
            sharding.tree_paths(one["params"])):
        # AdamW carries a near-zero gradient's rounding into its update
        # (tests/test_torch_parallel.py LOOSE).
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=path)


def test_a_step_missing_a_shard_is_not_restored(runs, tmp_path):
    ckpt = tmp_path / "ckpt"
    shutil.copytree(runs["dir"] / "two", ckpt)
    os.remove(ckpt / "llama" / "4" / "shard-1.pt")
    rdv = rendezvous.Rendezvous(checkpoint_dir=str(ckpt))
    state = ttrain.CheckpointState.restore_or_init(rdv, _template(),
                                                   subdir="llama")
    assert state.value["step"] == 2
    assert state.fallback == "corrupt_latest"
    want = ttrain._read_step(str(runs["dir"] / "two" / "llama"), 2,
                             _template())
    for got, ref in zip(ttrain.tree_leaves(state.value["params"]),
                        ttrain.tree_leaves(want["params"])):
        assert torch.equal(got, ref)


# -- elastic resize across processes ------------------------------------------


def _resize_env(tmp_path, doc):
    rdv = tmp_path / "rdv"
    rdv.mkdir()
    (rdv / "generation.json").write_text(json.dumps(doc))
    return {"TRAININGJOB_RESIZE_DIR": str(rdv),
            "TRAININGJOB_RESIZE_POLL_S": "0"}


def _resume_copy(runs, tmp_path, name):
    """The two-process run's checkpoint with step 4 taken away: a restore
    reads step 2."""
    ckpt = tmp_path / name
    shutil.copytree(runs["dir"] / "two", ckpt)
    shutil.rmtree(ckpt / "llama" / "4")
    return str(ckpt)


def test_a_killed_peer_ends_the_survivor_with_143(tmp_path):
    """The repair of the lost-peer exit: rank 1 is killed after step 2,
    and rank 0's next collective raises (gloo closes the socket), which
    ``peer_loss_guard`` turns into exit 143 (a restart), not a
    traceback and exit 1 (a failed job)."""
    corpus = str(tmp_path / "c.tokens")
    write_tokens(corpus, np.random.default_rng(3).integers(0, 256, 4000),
                 vocab_size=256)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update({"LLAMA_CONFIG": "tiny", "LLAMA_DTYPE": "float32",
                "LLAMA_BATCH": "4", "LLAMA_SEQ": "16",
                "LLAMA_STEPS": "100000", "LLAMA_CKPT_EVERY": "2",
                "LLAMA_DATA": corpus,
                "TRAININGJOB_CHECKPOINT_DIR": str(tmp_path / "ckpt"),
                "TRAININGJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
                "TRAININGJOB_NUM_PROCESSES": "2", "OMP_NUM_THREADS": "1"})
    procs = []
    try:
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "trainingjob_operator_tpu_torch.workloads.llama_elastic",
                 "--device", "cpu"],
                env={**env, "TRAININGJOB_PROCESS_ID": str(rank)}, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.time() + TIMEOUT
        for line in procs[1].stdout:
            if line.startswith("step 2/") or time.time() > deadline:
                break
        procs[1].kill()
        procs[1].wait()
        t0 = time.time()
        out = procs[0].communicate(timeout=60)[0]
        took = time.time() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert procs[0].returncode == 143, out
    assert "exiting 143 for operator restart" in out
    assert took < 60


def test_two_ranks_reform_their_group_in_process(runs, tmp_path):
    """A new generation of the same world [0, 1], published before the
    ranks start: both observe it after their first step, destroy and form
    their gloo group again at the same coordinator, and restore the last
    committed step onto the new mesh (``fallback=1``): no process
    restarts, and the losses are the uninterrupted run's."""
    sink = _Sink()
    try:
        lines = _train(sink, "reform", _resume_copy(runs, tmp_path, "ck"),
                       2, runs["corpus"], extra=_resize_env(
                           tmp_path, {"generation": 1, "world": [0, 1]}))
        got = [sink.losses("reform", rank) for rank in range(2)]
    finally:
        sink.close()
    want = runs["losses"][("one", 0)]
    for rank in range(2):
        out = lines[rank]
        assert "resumed at step 2 (width 2)" in out
        assert any(ln.startswith("resize: generation 1 (world [0, 1]) "
                                 "observed at step 3") for ln in out)
        assert "resize_rung generation=1 rung=live phase=-" in out
        timing = [ln for ln in out if ln.startswith("resize_timing ")]
        assert len(timing) == 1 and "fallback=1" in timing[0]
        assert "width=2" in timing[0]
        assert ("resized in place: mesh {'dp': 1, 'pp': 1, 'fsdp': 2, "
                "'tp': 1, 'sp': 1}, resuming at step 2") in out
        assert any(ln.startswith("done: ") and " width=2 " in ln
                   for ln in out)
        _close(got[rank], {k: want[k] for k in range(3, STEPS + 1)})


def test_a_shrink_to_one_rank(runs, tmp_path):
    """A generation of world [0]: rank 1 is absent from it and degrades at
    ``reinit`` to the checkpoint rung, whose sharded save needs the group
    it destroyed and fails, so it lands on ``restart_all`` (143, in that
    order); rank 0 forms a group of one and restores at width 1, and its
    losses equal a width-1 resume of the same step's."""
    sink = _Sink()
    try:
        plain = _train(sink, "one_from_2", _resume_copy(runs, tmp_path, "a"),
                       1, runs["corpus"])
        lines = _train(sink, "shrink", _resume_copy(runs, tmp_path, "b"), 2,
                       runs["corpus"], rcs=[0, 143],
                       extra=_resize_env(tmp_path,
                                         {"generation": 1, "world": [0]}))
        got = sink.losses("shrink", 0)
        want = sink.losses("one_from_2", 0)
    finally:
        sink.close()
    assert "resumed at step 2 (width 1)" in plain[0]
    rank0, rank1 = lines
    assert "resize_rung generation=1 rung=live phase=-" in rank0
    assert any(ln.startswith("resize_timing generation=1 width=1 ")
               and "fallback=1" in ln for ln in rank0)
    assert any(ln.startswith("done: ") and " width=1 " in ln for ln in rank0)
    rungs = [ln for ln in rank1 if ln.startswith("resize_rung ")]
    assert rungs == [
        "resize_rung generation=1 rung=checkpoint phase=reinit injected=0",
        "resize_rung generation=1 rung=restart_all phase=persist "
        "injected=0"]
    assert sorted(want) == list(range(3, STEPS + 1))
    _close({k: v for k, v in got.items() if k > 2}, want)


#: Two processes at one coordinator address: the group forms, then is
#: destroyed and formed again at generations 1 and 2; an all-reduce over
#: the rebuilt mesh checks each.
REBOOTSTRAP_TWICE = """
import sys, torch, torch.distributed as dist
from trainingjob_operator_tpu_torch.parallel import mesh as pmesh
from trainingjob_operator_tpu_torch.workloads import rendezvous
rank, addr = int(sys.argv[1]), sys.argv[2]
rdv = rendezvous.Rendezvous(num_processes=2, process_id=rank,
                            coordinator_address=addr)
rendezvous.initialize_distributed(rdv, torch.device("cpu"))
for generation in (1, 2):
    rdv, _ = rendezvous.rebootstrap_distributed(
        rdv, {"generation": generation, "world": [0, 1],
              "coordinator": addr}, old_world=[0, 1])
    mesh = pmesh.make_mesh(pmesh.mesh_spec_from_rendezvous(rdv), "cpu")
    x = torch.full((1,), float(rank + generation))
    dist.all_reduce(x, group=mesh.group("fsdp"))
    print(f"generation {generation} rank {rdv.process_id} sum {x.item()}",
          flush=True)
dist.destroy_process_group()
"""


def test_a_rebootstrap_twice_at_one_address():
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", REBOOTSTRAP_TWICE,
                               str(rank), addr], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    for rank, out in enumerate(outs):
        for generation in (1, 2):
            assert (f"generation {generation} rank {rank} sum "
                    f"{float(1 + 2 * generation)}") in out
