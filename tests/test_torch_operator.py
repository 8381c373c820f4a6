"""The port's trainers run under the system's own operator, on the CPU.

The JAX package's ``TrainingJobController`` and ``LocalProcRuntime`` (as
tests/test_e2e_localproc.py drives them) launch the port's entry points as
pod processes, with the env the operator injects (identity, coordinator,
checkpoint directory) and ``TRAININGJOB_JAX_PLATFORM=cpu`` in the pod
template, as ``examples/mnist-cpu.yaml`` sets it for JAX's worker:

- A port MNIST job (``restartingExitCode: "137,128"``, as the example)
  whose worker kills itself once step 20's save has committed
  (``TRAININGJOB_KILL_AT_STEP``): the operator restarts it once, the
  restarted pod resumes at step 20 with ``restart_count=1``, and the job
  reaches ``Succeed`` on the losses of an uninterrupted in-process run.
- A 2-replica tiny Llama job over gloo, rendezvousing at the operator's
  coordinator: one worker is preempted (SIGKILL) with ``RestartScope.ALL``;
  both workers restart, resume from the same committed step and finish,
  every step's loss equal to an uninterrupted job's, bit for bit.
"""

import sys

import pytest
import torch

from trainingjob_operator_tpu.api.types import (
    ReplicaSpec,
    RestartPolicy,
    RestartScope,
    TPUTrainingJob,
    TrainingJobPhase,
)
from trainingjob_operator_tpu.client.clientset import Clientset
from trainingjob_operator_tpu.cmd.options import OperatorOptions
from trainingjob_operator_tpu.controller.controller import TrainingJobController
from trainingjob_operator_tpu.core.objects import (
    Container,
    ContainerPort,
    EnvVar,
    ObjectMeta,
    PodSpec,
    PodTemplateSpec,
)
from trainingjob_operator_tpu.runtime.localproc import LocalProcRuntime

from _torch_sink import Sink
from conftest import wait_for

#: Seconds a job may take to reach its final phase on a loaded host.
JOB_LIMIT_S = 120


@pytest.fixture
def cluster(tmp_path):
    cs = Clientset()
    tc = TrainingJobController(cs, options=OperatorOptions(resync_period=0.05))
    rt = LocalProcRuntime(cs, nodes=2, log_dir=str(tmp_path / "logs"),
                          termination_grace=5.0)
    rt.start()
    tc.run(workers=2)
    yield cs, rt, tmp_path
    tc.stop()
    rt.stop()


def port_job(name, module, env, tmp_path, replicas=1, rtype="trainer",
             **replica_kw) -> TPUTrainingJob:
    """A job of ``replicas`` pods running the port's ``module`` main
    (unbuffered), on the CPU, checkpointing under ``tmp_path``."""
    job = TPUTrainingJob(metadata=ObjectMeta(
        name=name, namespace="default",
        annotations={"checkpoint-dir": str(tmp_path / "ckpt" / name)}))
    env = {"TRAININGJOB_JAX_PLATFORM": "cpu", "OMP_NUM_THREADS": "1", **env}
    job.spec.replica_specs[rtype] = ReplicaSpec(
        replicas=replicas,
        template=PodTemplateSpec(spec=PodSpec(containers=[Container(
            name="aitj-trainer",
            command=[sys.executable, "-u", "-m",
                     f"trainingjob_operator_tpu_torch.workloads.{module}"],
            env=[EnvVar(k, v) for k, v in env.items()],
            ports=[ContainerPort(name="aitj-24446",
                                 container_port=24446)])])),
        **replica_kw)
    return job


def phase(cs, name):
    return cs.trainingjobs.get("default", name).status.phase


def pod_log(tmp_path, pod: str, attempt: int) -> str:
    path = tmp_path / "logs" / f"default_{pod}_{attempt:04d}.log"
    return path.read_text() if path.exists() else ""


def loss_lines(text: str):
    return [ln for ln in text.splitlines()
            if ln.startswith("step ") and " loss " in ln]


MNIST_ENV = {"MNIST_STEPS": "60", "MNIST_HIDDEN": "32", "MNIST_BATCH": "32"}


def test_a_port_mnist_job_restarts_under_the_operator(cluster, monkeypatch,
                                                      capsys):
    cs, rt, tmp_path = cluster
    job = port_job("tmnist", "mnist",
                   {**MNIST_ENV, "TRAININGJOB_KILL_AT_STEP": "20"}, tmp_path,
                   restart_limit=1,
                   restart_policy=RestartPolicy.ON_NODE_FAIL_WITH_EXIT_CODE,
                   complete_policy="All", fail_policy="Rank0")
    job.spec.restarting_exit_code = "137,128"
    cs.trainingjobs.create(job)

    # The uninterrupted run, in process on the CPU, while the job runs.
    from trainingjob_operator_tpu_torch.workloads import mnist

    for k, v in MNIST_ENV.items():
        monkeypatch.setenv(k, v)
    for k in ("TRAININGJOB_CHECKPOINT_DIR", "TRAININGJOB_COORDINATOR_ADDRESS",
              "TRAININGJOB_KILL_AT_STEP"):
        monkeypatch.delenv(k, raising=False)
    # One thread, as the pod's OMP_NUM_THREADS=1: a CPU BLAS splits a
    # product over the threads it is given.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert mnist.main(["--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    want = capsys.readouterr().out

    assert wait_for(lambda: phase(cs, "tmnist") in (
        TrainingJobPhase.SUCCEEDED, TrainingJobPhase.FAILED), JOB_LIMIT_S), \
        phase(cs, "tmnist")
    first = pod_log(tmp_path, "tmnist-trainer-0", 1)
    second = pod_log(tmp_path, "tmnist-trainer-0", 2)
    assert phase(cs, "tmnist") == TrainingJobPhase.SUCCEEDED, (first, second)
    assert cs.trainingjobs.get("default", "tmnist").status.restart_counts \
        == {"trainer": 1}
    assert "killed at step 20" in first
    assert loss_lines(first) == loss_lines(want)[:1]
    assert loss_lines(second) == loss_lines(want)[1:]
    done = [ln for ln in second.splitlines() if ln.startswith("done:")]
    want_done = [ln for ln in want.splitlines() if ln.startswith("done:")]
    assert len(done) == 1 and "steps=40 " in done[0]
    assert done[0].endswith("restart_count=1")
    assert (done[0].split("final_loss=")[1].split()[0]
            == want_done[0].split("final_loss=")[1].split()[0])


LLAMA_STEPS = 200


def losses(sink, job):
    """[(rank, step, loss)] of ``job``'s step records, every
    incarnation's."""
    return [(r["rank"], r["step"] + 1, r["loss"])
            for r in sink.records_of(f"default/{job}", "step")]


def test_a_two_replica_llama_job_resumes_under_the_operator(cluster):
    cs, rt, tmp_path = cluster
    sink = Sink()
    env = {"LLAMA_CONFIG": "tiny", "LLAMA_DTYPE": "float32",
           "LLAMA_BATCH": "4", "LLAMA_SEQ": "16",
           "LLAMA_STEPS": str(LLAMA_STEPS), "LLAMA_CKPT_EVERY": "10",
           "TRAININGJOB_TELEMETRY_ADDR": sink.address}
    try:
        for name in ("tllama", "tplain"):
            job = port_job(name, "llama_elastic", env, tmp_path, replicas=2,
                           rtype="worker",
                           restart_policy=RestartPolicy.EXIT_CODE,
                           restart_scope=RestartScope.ALL)
            job.spec.restarting_exit_code = "137,143"
            cs.trainingjobs.create(job)
        # Preempt worker 1 once worker 0 is past a committed step.
        assert wait_for(lambda: "step 20/" in pod_log(
            tmp_path, "tllama-worker-0", 1), JOB_LIMIT_S), \
            pod_log(tmp_path, "tllama-worker-0", 1)
        rt.preempt_pod("default", "tllama-worker-1")
        for name in ("tllama", "tplain"):
            assert wait_for(lambda: phase(cs, name) in (
                TrainingJobPhase.SUCCEEDED, TrainingJobPhase.FAILED),
                JOB_LIMIT_S), phase(cs, name)
        logs = {(name, i, a): pod_log(tmp_path, f"{name}-worker-{i}", a)
                for name in ("tllama", "tplain") for i in (0, 1)
                for a in (1, 2)}
        for name in ("tllama", "tplain"):
            assert phase(cs, name) == TrainingJobPhase.SUCCEEDED, logs
        assert cs.trainingjobs.get("default", "tllama").status \
            .restart_counts == {"worker": 1}
        assert not logs[("tplain", 0, 2)] and not logs[("tplain", 1, 2)]
        # Both restarted workers resume from the same committed step.
        resumed = set()
        for i in (0, 1):
            lines = logs[("tllama", i, 2)].splitlines()
            resumed |= {ln for ln in lines if ln.startswith("resumed at")}
            assert any(ln.startswith("done:") and "width=2" in ln
                       and ln.endswith("restart_count=1") for ln in lines)
        assert len(resumed) == 1, logs
        step = int(resumed.pop().split()[3])
        assert 10 <= step < LLAMA_STEPS and step % 10 == 0
        # Every step either incarnation ran equals the uninterrupted job's.
        want = {(rank, s): loss for rank, s, loss in losses(sink, "tplain")}
        assert sorted(want) == [(r, s) for r in (0, 1)
                                for s in range(1, LLAMA_STEPS + 1)]
        got = losses(sink, "tllama")
        assert {(r, s) for r, s, _ in got} == set(want)
        assert all(loss == want[(r, s)] for r, s, loss in got)
    finally:
        sink.close()
