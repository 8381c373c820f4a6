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

from trainingjob_operator_tpu.data import write_tokens
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


def _train(sink, job, ckpt, world, corpus, steps=STEPS, coordinator=True):
    """Run the trainer as ``world`` processes; returns each one's output
    lines.  ``coordinator=False`` runs one process without the rendezvous
    env (the single-process path and checkpoint format)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update({"LLAMA_CONFIG": "tiny", "LLAMA_DTYPE": "float32",
                "LLAMA_BATCH": "4", "LLAMA_SEQ": "16", "LLAMA_ACCUM": "2",
                "LLAMA_STEPS": str(steps), "LLAMA_CKPT_EVERY": "2",
                "LLAMA_DATA": corpus, "TRAININGJOB_CHECKPOINT_DIR": ckpt,
                "TRAININGJOB_TELEMETRY_ADDR": sink.address,
                "TRAININGJOB_NAMESPACE": "t", "TRAININGJOB_NAME": job,
                "TRAININGJOB_ELASTIC_REPLICAS": str(world),
                "OMP_NUM_THREADS": "1"})
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
    assert all(p.returncode == 0 for p in procs), outs
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
    out = {"dir": work}
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
    # the two processes' step 4 left none.
    records = runs["resumes"][job]
    assert len(records) == world
    assert all(r["resume_compile_ms"] == 0 and not r["resume_overlapped"]
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
