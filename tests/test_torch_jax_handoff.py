"""A port worker resumes the job state that the JAX package's worker
committed (``workloads/jax_state.py``; ``train.CheckpointState``).

In every case the JAX package's own main first commits its state on the
CPU with its ``CheckpointState`` (orbax step directories and, one process,
the resume image), at the tiny configs in fp32; then the port's main
resumes from that directory:

- Llama and MoE: both mains read one token file (``write_tokens``); the
  port's next losses (its telemetry) equal the JAX main's own
  continuation on the same directory within ``LLAMA_TOL`` / ``MOE_TOL``,
  and so do its parameters at the last step.  Llama also as two gloo
  processes (fsdp), each taking its blocks of the one-process image:
  their losses equal the one-process port's within ``SELF_TOL``.
- MNIST, BERT and ResNet: the port's main, fed numpy batches, resumes at
  JAX's step; its per-step losses and last parameters equal JAX's step
  (its main's loss and optax update) replayed from the committed state on
  the same batches, within ``MNIST_TOL`` / ``BERT_TOL`` / ``RESNET_TOL``.
- ``generate`` samples from the JAX-trained parameters.
- A plain unpickle of JAX's image needs optax, which the card's machine
  lacks; the reader needs neither optax nor JAX and leaves no stand-in
  module behind.
- An orbax step without an image (``TRAININGJOB_CKPT_SNAPSHOT=0``) is
  refused in the worker's preamble: exit 1 with a message naming orbax
  and the step, before the device (``--device cuda`` here) or any
  directory is touched, the JAX steps intact.
- An image older than JAX's newest orbax step restores its own step
  (``jax_stale``); the port never commits over JAX's directory.
- A global outside the allow-list is refused (``foreign_global``), also
  a bf16 leaf's ``ml_dtypes``: no trainer's image holds one.
- ``jax_state.write_image`` (the chip phase's writer) against a real JAX
  image: the same globals, tree paths, dtypes and footer.
"""

import contextlib
import dataclasses
import hashlib
import io
import os
import pickle
import pickletools
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from test_torch_multiprocess import _Sink, _train  # noqa: E402
from trainingjob_operator_tpu.models import bert as jbert  # noqa: E402
from trainingjob_operator_tpu.models import llama as jllama  # noqa: E402
from trainingjob_operator_tpu.models import moe as jmoe  # noqa: E402
from trainingjob_operator_tpu.models import resnet as jresnet  # noqa: E402
from trainingjob_operator_tpu.parallel import sharding as jsharding  # noqa: E402
from trainingjob_operator_tpu.workloads import bert_pretrain as jbert_main  # noqa: E402
from trainingjob_operator_tpu.workloads import llama_elastic as jllama_main  # noqa: E402
from trainingjob_operator_tpu.workloads import mnist as jmnist_main  # noqa: E402
from trainingjob_operator_tpu.workloads import moe_pretrain as jmoe_main  # noqa: E402
from trainingjob_operator_tpu.workloads import resnet_dp as jresnet_main  # noqa: E402
from trainingjob_operator_tpu_torch.data import write_tokens  # noqa: E402
from trainingjob_operator_tpu_torch.models import bert as tbert  # noqa: E402
from trainingjob_operator_tpu_torch.models import decode as tdecode  # noqa: E402
from trainingjob_operator_tpu_torch.models import llama as tllama  # noqa: E402
from trainingjob_operator_tpu_torch.models import moe as tmoe  # noqa: E402
from trainingjob_operator_tpu_torch.models import resnet as tresnet  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import sharding as tsharding  # noqa: E402
from trainingjob_operator_tpu_torch.utils.metrics import METRICS  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import bert_pretrain  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import generate  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import jax_state  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import mnist as tmnist  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import moe_pretrain  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import rendezvous  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import resnet_dp  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import train as ttrain  # noqa: E402

#: Each module's stated parity tolerance against JAX in fp32 (rtol =
#: atol): tests/test_torch_train.py (Llama), test_torch_moe.py,
#: test_torch_mnist.py, test_torch_bert.py, test_torch_resnet.py.
LLAMA_TOL = 1e-4
MOE_TOL = 1e-4
MNIST_TOL = 1e-6
BERT_TOL = 1e-5
RESNET_TOL = 1e-5
#: The port against itself: two processes against one.
SELF_TOL = 1e-5

ROOT = Path(__file__).resolve().parent.parent
#: The env a test's mains must not inherit from the runner.
_WORKER_ENV = ("TRAININGJOB_CHECKPOINT_DIR", "TRAININGJOB_REPLICA_NAME",
               "TRAININGJOB_REPLICA_INDEX", "TRAININGJOB_REPLICA_RESTARTCOUNT",
               "TRAININGJOB_COORDINATOR_ADDRESS", "TRAININGJOB_NUM_PROCESSES",
               "TRAININGJOB_PROCESS_ID", "TRAININGJOB_TELEMETRY_ADDR",
               "TRAININGJOB_CKPT_SNAPSHOT", "TRAININGJOB_CKPT_FAULT",
               "TRAININGJOB_COMPILE_CACHE_DIR", "TRAININGJOB_JAX_PLATFORM")

torch.set_num_threads(2)


@contextlib.contextmanager
def _env(**values):
    """The mains' env for the block (the worker env cleared first), and a
    MonkeyPatch for what else the block patches."""
    with pytest.MonkeyPatch.context() as mp:
        for key in _WORKER_ENV:
            mp.delenv(key, raising=False)
        for key, value in values.items():
            mp.setenv(key, str(value))
        yield mp


def _fp32(mp, config_cls):
    """``config_cls.tiny()`` in fp32 (the tiny configs compute in bf16)."""
    tiny = config_cls.tiny
    mp.setattr(config_cls, "tiny", classmethod(
        lambda cls, **kw: dataclasses.replace(tiny(**kw), dtype="float32")))


def _image(path):
    """(step, tree) of a JAX image, by a plain unpickle (optax is here)."""
    raw = (Path(path) / jax_state.IMAGE).read_bytes()
    assert hashlib.sha256(raw[:-32]).digest() == raw[-32:]
    return pickle.loads(raw[:-32])


def _flat(tree, prefix=""):
    """{path: f32 numpy} of a tree of dicts (torch or numpy leaves)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = (v.detach().float().numpy()
                         if isinstance(v, torch.Tensor)
                         else np.asarray(v, np.float32))
    return out


def _assert_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=tol,
                                   atol=tol, err_msg=path)


def _port_step(ckpt, step, item="params"):
    return torch.load(Path(ckpt) / str(step) / f"{item}.pt",
                      weights_only=True)


def _tree_digest(root):
    """{relative path: sha256} of every file under ``root``, and its
    directories."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out[rel + "/"] = ""
        for name in filenames:
            with open(os.path.join(dirpath, name), "rb") as f:
                out[os.path.join(rel, name)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def _recording(make_step, losses):
    """``make_step`` whose steps append each loss (a float) to
    ``losses``; the step keeps the original's attributes (``.opt``)."""
    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(*a, **k):
            loss = step(*a, **k)
            losses.append(float(loss))
            return loss

        recorded.__dict__.update(step.__dict__)
        return recorded

    return make


# -- Llama and MoE: the JAX main's continuation ------------------------------

LM_ENV = {"BATCH": "8", "SEQ": "16", "CKPT_EVERY": "2"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("corpus") / "c.tokens")
    write_tokens(path, np.random.default_rng(3).integers(0, 256, 4000),
                 vocab_size=256)
    return path


def _jax_lm_job(work, corpus, sink, prefix, main, config_cls):
    """The JAX main to step 2 (a copy kept at ``at2``), then its own
    continuation to step 4 on the same directory (``jax``), with
    telemetry job "jax"; also a run with the snapshot pipeline off
    (``orbax_only``: no image)."""
    env = {f"{prefix}_{k}": v for k, v in LM_ENV.items()}
    with _env(**env, **{f"{prefix}_DATA": corpus, f"{prefix}_STEPS": 2,
                        "TRAININGJOB_TELEMETRY_ADDR": sink.address,
                        "TRAININGJOB_NAMESPACE": "t",
                        "TRAININGJOB_NAME": "jax",
                        "TRAININGJOB_CHECKPOINT_DIR": work / "jax"}) as mp:
        _fp32(mp, config_cls)
        assert main() == 0
        shutil.copytree(work / "jax", work / "at2")
        mp.setenv(f"{prefix}_STEPS", "4")
        mp.setenv("TRAININGJOB_REPLICA_RESTARTCOUNT", "1")
        assert main() == 0
        mp.delenv("TRAININGJOB_TELEMETRY_ADDR")
        mp.setenv(f"{prefix}_STEPS", "2")
        mp.setenv("TRAININGJOB_CKPT_SNAPSHOT", "0")
        mp.setenv("TRAININGJOB_CHECKPOINT_DIR", str(work / "orbax_only"))
        assert main() == 0


@pytest.fixture(scope="module")
def llama_job(tmp_path_factory, corpus):
    """JAX's Llama state, the port resuming it as one process and as two
    (gloo), and the losses of each."""
    work = tmp_path_factory.mktemp("llama_handoff")
    sink = _Sink()
    try:
        _jax_lm_job(work, corpus, sink, "LLAMA", jllama_main.main,
                    jllama.LlamaConfig)
        extra = {"LLAMA_BATCH": "8", "LLAMA_ACCUM": "1"}
        out = {"work": work, "image": work / "at2" / "llama"}
        for job, world in (("port", 1), ("port2", 2)):
            shutil.copytree(work / "at2", work / job)
            out[job] = _train(sink, job, str(work / job), world, corpus,
                              steps=4, coordinator=world > 1, extra=extra)
        out["losses"] = {job: sink.losses(job, 0)
                         for job in ("jax", "port")}
        out["losses"]["port2"] = [sink.losses("port2", r) for r in (0, 1)]
    finally:
        sink.close()
    return out


@pytest.fixture(scope="module")
def moe_job(tmp_path_factory, corpus):
    work = tmp_path_factory.mktemp("moe_handoff")
    sink = _Sink()
    try:
        _jax_lm_job(work, corpus, sink, "MOE", jmoe_main.main,
                    jmoe.MoEConfig)
        shutil.copytree(work / "at2", work / "port")
        env = {f"MOE_{k}": v for k, v in LM_ENV.items()}
        with _env(**env, MOE_DATA=corpus, MOE_STEPS=4,
                  TRAININGJOB_TELEMETRY_ADDR=sink.address,
                  TRAININGJOB_NAMESPACE="t", TRAININGJOB_NAME="port",
                  TRAININGJOB_CHECKPOINT_DIR=work / "port") as mp:
            mp.setitem(tmoe.CONFIGS, "tiny", lambda: dataclasses.replace(
                tmoe.MoEConfig.tiny(), dtype="float32"))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert moe_pretrain.main(["--device", "cpu"]) == 0
        out = {"work": work, "image": work / "at2" / "moe",
               "port": buf.getvalue().splitlines()}
        out["losses"] = {job: sink.losses(job, 0) for job in ("jax", "port")}
    finally:
        sink.close()
    return out


def _lm_case(job, subdir, tol):
    work, losses = job["work"], job["losses"]
    want, got = losses["jax"], losses["port"]
    assert sorted(got) == [3, 4]
    np.testing.assert_allclose([got[3], got[4]], [want[3], want[4]],
                               rtol=tol, atol=tol)
    step, tree = _image(work / "jax" / subdir)
    assert step == 4
    _assert_close(_flat(_port_step(work / "port" / subdir, 4)),
                  _flat(tree["params"]), tol)
    count = _port_step(work / "port" / subdir, 4, "opt_state")["count"]
    assert count == int(tree["opt_state"][0].count) == 4


# -- MNIST, BERT and ResNet: JAX's step replayed ---------------------------

def _mnist_loss(p, x, y):
    # mnist.py:87-90, verbatim.
    h = jax.nn.relu(x @ p["w1"] + p["b1"])
    logits = h @ p["w2"] + p["b2"]
    return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()


def _replay(loss_and_aux, tx, state, batches, with_stats=False):
    """JAX's step (value_and_grad, ``tx.update``, ``apply_updates``) from
    the committed ``state`` over ``batches``: (losses, params, stats)."""
    @jax.jit
    def step(p, s, o, b):
        if with_stats:
            (loss, s), grads = jax.value_and_grad(
                loss_and_aux, has_aux=True)(p, s, b)
        else:
            loss, grads = jax.value_and_grad(loss_and_aux)(p, b)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), s, o, loss

    p, s, o = (state["params"], state.get("stats"), state["opt_state"])
    losses = []
    for b in batches:
        p, s, o, loss = step(p, s, o, b)
        losses.append(float(loss))
    return losses, p, s


@pytest.fixture(scope="module")
def mnist_job(tmp_path_factory):
    work = tmp_path_factory.mktemp("mnist_handoff")
    steps, hidden, batch = 20, 32, 32
    with _env(MNIST_STEPS=steps, MNIST_HIDDEN=hidden, MNIST_BATCH=batch,
              TRAININGJOB_CHECKPOINT_DIR=work):
        assert jmnist_main.main() == 0
    path = work / "worker" / "0"
    step, state = _image(path)
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((2 * steps, batch, 784)).astype(np.float32)
    ys = rng.integers(0, 10, (2 * steps, batch)).astype(np.int32)
    want, params, _ = _replay(lambda p, b: _mnist_loss(p, *b),
                              optax.adam(1e-3), state,
                              [(xs[i], ys[i]) for i in range(step, 2 * steps)])
    got = []
    buf = io.StringIO()
    with _env(MNIST_STEPS=2 * steps, MNIST_HIDDEN=hidden, MNIST_BATCH=batch,
              TRAININGJOB_CHECKPOINT_DIR=work) as mp:
        mp.setattr(tmnist, "synthetic_mnist", lambda g, n, b: (
            torch.from_numpy(xs), torch.from_numpy(ys)))
        mp.setattr(tmnist, "make_step", _recording(tmnist.make_step, got))
        with contextlib.redirect_stdout(buf):
            assert tmnist.main(["--device", "cpu"]) == 0
    return {"step": step, "want": want, "got": got, "tol": MNIST_TOL,
            "image": path,
            "want_params": _flat(params),
            "got_params": _flat(_port_step(path, 2 * steps)),
            "lines": buf.getvalue().splitlines()}


def _lm_batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        targets = rng.integers(1, cfg.vocab_size, (8, 32)).astype(np.int32)
        mask = (rng.random((8, 32)) < 0.3).astype(np.int32)
        out.append({"tokens": np.where(mask == 1, 0, targets).astype(
            np.int32), "targets": targets, "mask": mask})
    return out


@pytest.fixture(scope="module")
def bert_job(tmp_path_factory):
    work = tmp_path_factory.mktemp("bert_handoff")
    common = dict(BERT_BATCH=8, BERT_SEQ=32, TRAININGJOB_CHECKPOINT_DIR=work)
    with _env(BERT_STEPS=2, **common) as mp:
        _fp32(mp, jbert.BertConfig)
        assert jbert_main.main() == 0
    jc = dataclasses.replace(jbert.BertConfig.tiny(), dtype="float32")
    step, state = _image(work / "bert")
    batches = _lm_batches(jc, 4, seed=7)
    want, params, _ = _replay(
        lambda p, b: jbert.loss_fn(p, b, jc), optax.adamw(1e-4,
                                                          weight_decay=0.01),
        state, [{k: jnp.asarray(v) for k, v in b.items()}
                for b in batches[step:]])
    got = []
    buf = io.StringIO()
    with _env(BERT_STEPS=4, **common) as mp:
        _fp32(mp, tbert.BertConfig)
        mp.setattr(bert_pretrain, "batch_at", lambda i, *a: {
            k: torch.from_numpy(v).long() for k, v in batches[i].items()})
        mp.setattr(bert_pretrain, "make_step",
                   _recording(bert_pretrain.make_step, got))
        with contextlib.redirect_stdout(buf):
            assert bert_pretrain.main(["--device", "cpu"]) == 0
    got_params = {tsharding_path: x for tsharding_path, x in
                  tsharding.tree_paths(_port_step(work / "bert", 4))}
    return {"step": step, "want": want, "got": got, "tol": BERT_TOL,
            "image": work / "bert",
            "want_params": {jsharding.path_of(kp): np.asarray(x, np.float32)
                            for kp, x in jax.tree_util.tree_flatten_with_path(
                                params)[0]},
            "got_params": {p: x.float().numpy()
                           for p, x in got_params.items()},
            "lines": buf.getvalue().splitlines()}


@pytest.fixture(scope="module")
def resnet_job(tmp_path_factory):
    work = tmp_path_factory.mktemp("resnet_handoff")
    common = dict(RESNET_BATCH=8, RESNET_IMAGE=32,
                  TRAININGJOB_CHECKPOINT_DIR=work)
    with _env(RESNET_STEPS=2, **common) as mp:
        _fp32(mp, jresnet.ResNetConfig)
        assert jresnet_main.main() == 0
    jc = dataclasses.replace(jresnet.ResNetConfig.tiny(), dtype="float32")
    path = work / "worker" / "0"
    step, state = _image(path)
    rng = np.random.default_rng(9)
    batches = [{"images": rng.standard_normal((8, 32, 32, 3)).astype(
        np.float32), "labels": rng.integers(0, 10, 8).astype(np.int32)}
        for _ in range(4)]
    want, params, stats = _replay(
        lambda p, s, b: jresnet.loss_fn(p, s, b, jc),
        optax.sgd(0.1, momentum=0.9), state,
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches[step:]],
        with_stats=True)
    got = []
    buf = io.StringIO()
    with _env(RESNET_STEPS=4, **common) as mp:
        _fp32(mp, tresnet.ResNetConfig)
        mp.setattr(resnet_dp, "batch_at", lambda i, *a: (
            torch.from_numpy(np.ascontiguousarray(
                batches[i]["images"].transpose(0, 3, 1, 2))),
            torch.from_numpy(batches[i]["labels"]).long()))
        mp.setattr(resnet_dp, "make_step", _recording(resnet_dp.make_step,
                                                      got))
        with contextlib.redirect_stdout(buf):
            assert resnet_dp.main(["--device", "cpu"]) == 0

    def jflat(tree):
        return {jsharding.path_of(kp): np.asarray(x, np.float32)
                for kp, x in jax.tree_util.tree_flatten_with_path(tree)[0]}

    return {"step": step, "want": want, "got": got, "tol": RESNET_TOL,
            "image": path,
            "want_params": {**jflat(params),
                            **{f"stats/{k}": v
                               for k, v in jflat(stats).items()}},
            "got_params": {
                **tresnet.params_to_numpy(_port_step(path, 4)),
                **{f"stats/{k}": v for k, v in tresnet.params_to_numpy(
                    _port_step(path, 4, "stats")).items()}},
            "lines": buf.getvalue().splitlines()}


@pytest.mark.parametrize("name", ["llama", "moe", "mnist", "bert",
                                  "resnet"])
def test_the_port_continues_a_job_the_jax_trainer_committed(name, request):
    job = request.getfixturevalue(f"{name}_job")
    if name in ("llama", "moe"):
        lines = job["port"][0] if name == "llama" else job["port"]
        assert "resume: step 2 restored from the JAX package's resume " \
            "image" in lines
        assert "resumed at step 2 (width 1)" in lines
        _lm_case(job, name, LLAMA_TOL if name == "llama" else MOE_TOL)
        return
    step = job["step"]
    assert f"resume: step {step} restored from the JAX package's resume " \
        f"image" in job["lines"]
    assert len(job["got"]) == len(job["want"]) > 0
    np.testing.assert_allclose(job["got"], job["want"], rtol=job["tol"],
                               atol=job["tol"])
    _assert_close(job["got_params"], job["want_params"], job["tol"])


def test_two_gloo_processes_take_their_blocks_of_the_one_process_image(
        llama_job):
    want = llama_job["losses"]["port"]
    for rank, lines in enumerate(llama_job["port2"]):
        assert "resume: step 2 restored from the JAX package's resume " \
            "image" in lines
        assert "resumed at step 2 (width 2)" in lines
        got = llama_job["losses"]["port2"][rank]
        assert sorted(got) == [3, 4]
        np.testing.assert_allclose([got[3], got[4]], [want[3], want[4]],
                                   rtol=SELF_TOL, atol=SELF_TOL)
    shards = sorted(os.listdir(llama_job["work"] / "port2" / "llama" / "4"))
    assert shards == ["shard-0.pt", "shard-1.pt"]


# -- the reader and its refusals ---------------------------------------------

def test_the_trainer_resumes_a_jax_directory_where_it_raised_before(
        llama_job, corpus, tmp_path):
    # Written before the reader: the port took orbax's step directories
    # for its own and raised reading them (no params.pt).
    shutil.copytree(llama_job["work"] / "at2", tmp_path / "ck")
    from trainingjob_operator_tpu_torch.workloads import llama_elastic

    buf = io.StringIO()
    with _env(LLAMA_BATCH=8, LLAMA_SEQ=16, LLAMA_STEPS=2, LLAMA_DATA=corpus,
              TRAININGJOB_CHECKPOINT_DIR=tmp_path / "ck"):
        with contextlib.redirect_stdout(buf):
            assert llama_elastic.main(["--device", "cpu"]) == 0
    assert "resumed at step 2 (width 1)" in buf.getvalue().splitlines()


def test_restore_or_init_on_a_jax_directory_restores_its_step(llama_job,
                                                              tmp_path):
    shutil.copytree(llama_job["work"] / "at2", tmp_path / "ck")
    rdv = rendezvous.Rendezvous(checkpoint_dir=str(tmp_path / "ck"))
    cfg = tllama.LlamaConfig(**dataclasses.replace(
        jllama.LlamaConfig.tiny(), dtype="float32").__dict__)
    params = tllama.init_params(cfg, None, "cpu", master=True)
    assert ttrain.committed_steps(str(tmp_path / "ck" / "llama")) == []
    assert ttrain.CheckpointState.has_checkpoint(rdv, subdir="llama")
    state = ttrain.CheckpointState.restore_or_init(
        rdv, {"params": params, "opt_state": ttrain.AdamW(params, 1.0).state,
              "step": 0}, subdir="llama",
        convert=__import__("trainingjob_operator_tpu_torch.workloads."
                           "llama_elastic", fromlist=["x"]).from_jax_state(
                               cfg))
    assert state.value["step"] == 2 and state.fallback == "jax_image"
    assert state.value["opt_state"]["count"] == 2
    _, tree = _image(tmp_path / "ck" / "llama")
    _assert_close(_flat(state.value["params"]), _flat(tree["params"]), 0)
    _assert_close(_flat(state.value["opt_state"]["nu"]),
                  _flat(tree["opt_state"][0].nu), 0)


_WITHOUT_OPTAX = """
import pickle, sys
sys.modules["optax"] = None
sys.modules["jax"] = None
raw = open(sys.argv[1], "rb").read()
try:
    pickle.loads(raw[:-32])
except ModuleNotFoundError as exc:
    print("plain:", exc.name.split(".")[0])
from trainingjob_operator_tpu_torch.workloads import jax_state
step, tree, _ = jax_state.read_image(sys.argv[2])
print("reader:", step, type(tree["opt_state"][0]).__name__,
      int(tree["opt_state"][0].count))
print("modules:", sorted(m for m in sys.modules
                         if m.split(".")[0] in ("optax", "jax")
                         and sys.modules[m] is not None))
"""


def test_a_plain_unpickle_needs_optax_where_the_reader_does_not(llama_job):
    path = llama_job["work"] / "at2" / "llama"
    out = subprocess.run(
        [sys.executable, "-c", _WITHOUT_OPTAX, str(path / jax_state.IMAGE),
         str(path)], cwd=ROOT, capture_output=True, text=True, timeout=60,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["plain: optax",
                                       "reader: 2 ScaleByAdamState 2",
                                       "modules: []"]


@pytest.mark.parametrize("module,family", [
    ("llama_elastic", "llama"), ("generate", "llama"), ("mnist", None)])
def test_an_orbax_step_without_an_image_is_refused_before_the_device(
        llama_job, tmp_path, module, family):
    if family is None:
        with _env(MNIST_STEPS=20, MNIST_HIDDEN=16, MNIST_BATCH=8,
                  TRAININGJOB_CKPT_SNAPSHOT=0,
                  TRAININGJOB_CHECKPOINT_DIR=tmp_path / "ck"):
            assert jmnist_main.main() == 0
        path, step = tmp_path / "ck" / "worker" / "0", 20
    else:
        shutil.copytree(llama_job["work"] / "orbax_only", tmp_path / "ck")
        path, step = tmp_path / "ck" / family, 2
    assert jax_state.orbax_steps(str(path)) == [step]
    assert not (path / jax_state.IMAGE).exists()
    before = _tree_digest(tmp_path / "ck")
    env = {k: v for k, v in os.environ.items() if k not in _WORKER_ENV}
    out = subprocess.run(
        [sys.executable, "-m",
         f"trainingjob_operator_tpu_torch.workloads.{module}",
         "--device", "cuda"], cwd=ROOT, capture_output=True, text=True,
        timeout=60, env={**env, "TRAININGJOB_CHECKPOINT_DIR":
                         str(tmp_path / "ck"), "PYTHONPATH": str(ROOT)})
    assert out.returncode == 1
    last = out.stderr.strip().splitlines()[-1]
    assert last == (f"trainingjob_operator_tpu_torch.workloads.jax_state."
                    f"UnreadableJaxState: {path} holds orbax step {step}, "
                    f"written by the JAX package, which the port cannot read "
                    f"(no resume-image.bin: a multi-process JAX job, or "
                    f"TRAININGJOB_CKPT_SNAPSHOT=0); refusing to start from "
                    f"step 0")
    # --device cuda on a machine without CUDA: resolving the device would
    # have raised "CUDA is not available" first.
    assert "CUDA" not in out.stderr
    assert _tree_digest(tmp_path / "ck") == before


def test_an_image_older_than_the_newest_orbax_step_restores_its_own(
        llama_job, corpus, tmp_path):
    # A preemption between JAX's orbax commit of step 4 and its image.
    work = llama_job["work"]
    shutil.copytree(work / "jax", tmp_path / "ck")
    shutil.copy(work / "at2" / "llama" / jax_state.IMAGE,
                tmp_path / "ck" / "llama" / jax_state.IMAGE)
    path = tmp_path / "ck" / "llama"
    orbax_before = {s: _tree_digest(path / str(s)) for s in (2, 4)}
    key = 'trainingjob_resume_image_fallbacks_total{reason="jax_stale"}'
    count = METRICS.snapshot().get(key, 0.0)
    buf = io.StringIO()
    with _env(LLAMA_BATCH=8, LLAMA_SEQ=16, LLAMA_CKPT_EVERY=2,
              LLAMA_STEPS=6, LLAMA_DATA=corpus, LLAMA_DTYPE="float32",
              TRAININGJOB_CHECKPOINT_DIR=tmp_path / "ck"):
        from trainingjob_operator_tpu_torch.workloads import llama_elastic

        with contextlib.redirect_stdout(buf):
            assert llama_elastic.main(["--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    assert ("resume: the JAX package's resume image holds step 2, its "
            "newest orbax step is 4; restoring step 2") in lines
    assert "resumed at step 2 (width 1)" in lines
    assert METRICS.snapshot()[key] == count + 1
    # Step 4's name is JAX's: not committed there; step 6 is the port's.
    assert f"ckpt: step 4 not committed: {path / '4'} holds the JAX " \
        f"package's orbax step" in lines
    assert ttrain.committed_steps(str(path)) == [6]
    assert jax_state.orbax_steps(str(path)) == [4, 2]
    assert {s: _tree_digest(path / str(s)) for s in (2, 4)} == orbax_before
    # The port's own step now wins: a restart resumes it.
    rdv = rendezvous.Rendezvous(checkpoint_dir=str(tmp_path / "ck"))
    cfg = tllama.LlamaConfig(**dataclasses.replace(
        jllama.LlamaConfig.tiny(), dtype="float32").__dict__)
    params = tllama.init_params(cfg, None, "cpu", master=True)
    state = ttrain.CheckpointState.restore_or_init(
        rdv, {"params": params, "opt_state": ttrain.AdamW(params, 1.0).state,
              "step": 0}, subdir="llama")
    assert state.value["step"] == 6 and state.fallback == ""


class _Foreign:
    def __reduce__(self):
        return (os.getcwd, ())


@pytest.mark.parametrize("what", ["datetime", "call", "bfloat16"])
def test_a_global_outside_the_allow_list_is_refused(llama_job, tmp_path,
                                                    what):
    import datetime

    import ml_dtypes

    leaf = {"datetime": datetime.date(2020, 1, 1), "call": _Foreign(),
            "bfloat16": np.zeros(3, ml_dtypes.bfloat16)}[what]
    name = {"datetime": "datetime.date", "call": f"{os.name}.getcwd",
            "bfloat16": "ml_dtypes.bfloat16"}[what]
    shutil.copytree(llama_job["work"] / "at2", tmp_path / "ck")
    path = tmp_path / "ck" / "llama"
    step, tree = _image(path)
    tree["params"]["extra"] = leaf
    payload = pickle.dumps((step, tree), protocol=pickle.HIGHEST_PROTOCOL)
    (path / jax_state.IMAGE).write_bytes(
        payload + hashlib.sha256(payload).digest())
    with pytest.raises(jax_state.ImageError,
                       match=f"foreign_global: global {name} is not"):
        jax_state.loads(payload)
    key = 'trainingjob_resume_image_fallbacks_total{reason="foreign_global"}'
    count = METRICS.snapshot().get(key, 0.0)
    rdv = rendezvous.Rendezvous(checkpoint_dir=str(tmp_path / "ck"))
    with pytest.raises(jax_state.UnreadableJaxState,
                       match=f"orbax step 2.*global {name} is not one"):
        ttrain.CheckpointState.restore_or_init(
            rdv, {"params": {}, "step": 0}, subdir="llama",
            convert=lambda t: {"params": {}})
    assert METRICS.snapshot()[key] == count + 1


@pytest.mark.parametrize("name", ["llama", "moe", "mnist", "bert",
                                  "resnet"])
def test_no_trainer_image_holds_a_bf16_leaf(name, request):
    # A bf16 leaf would name ml_dtypes, which the reader refuses.
    job = request.getfixturevalue(f"{name}_job")
    _, tree, _ = jax_state.read_image(str(job["image"]))
    leaves = jax.tree_util.tree_leaves(tree)
    dtypes = {x.dtype.name for x in leaves if isinstance(x, np.ndarray)}
    assert dtypes <= {"float32", "int32"}, dtypes
    assert all(isinstance(x, (np.ndarray, int)) for x in leaves)


def test_generate_samples_from_the_jax_trained_parameters(llama_job,
                                                          tmp_path):
    shutil.copytree(llama_job["work"] / "at2", tmp_path / "ck")
    _, tree = _image(tmp_path / "ck" / "llama")
    cfg = tllama.LlamaConfig.tiny()
    params = tllama.params_from_numpy(tree["params"], cfg, "cpu")
    want = tdecode.generate(params, torch.tensor([[3, 1, 4]]), cfg,
                            steps=6)[0].tolist()
    buf = io.StringIO()
    with _env(GEN_STEPS=6, GEN_PROMPT="3,1,4",
              TRAININGJOB_CHECKPOINT_DIR=tmp_path / "ck"):
        with contextlib.redirect_stdout(buf):
            assert generate.main(["--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    assert "sampling from checkpoint at step 2" in lines
    assert f"tokens: {','.join(map(str, want))}" in lines


def _globals(raw: bytes):
    """The (module, name) of every global a pickle names."""
    memo, pushed, out = {}, [], set()
    for op, arg, _ in pickletools.genops(raw):
        if op.name in ("SHORT_BINUNICODE", "BINUNICODE", "UNICODE"):
            pushed.append(arg)
        elif op.name in ("BINGET", "LONG_BINGET", "GET"):
            pushed.append(memo.get(arg))
        elif op.name == "MEMOIZE":
            memo[len(memo)] = pushed[-1] if pushed else None
        elif op.name == "STACK_GLOBAL":
            out.add((pushed[-2], pushed[-1]))
            pushed.append(None)
        elif op.name == "GLOBAL":
            out.add(tuple(arg.split(" ")))
        else:
            pushed.append(None)
    return out


def _layout(tree):
    return {(jax.tree_util.keystr(kp), np.asarray(x).dtype.name,
             np.asarray(x).shape)
            for kp, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_the_chip_phases_writer_equals_a_real_jax_image(llama_job, tmp_path):
    real = (llama_job["work"] / "at2" / "llama" / jax_state.IMAGE
            ).read_bytes()
    step, tree = pickle.loads(real[:-32])
    # The port's own state at the same config, as the chip phase has it.
    cfg = tllama.LlamaConfig(**jllama.LlamaConfig.tiny().__dict__)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu", master=True)
    opt = ttrain.AdamW(params, 1e-3)
    opt.state["count"] = step
    jax_state.write_image(str(tmp_path), step,
                          jax_state.adamw_tree(params, opt.state, step))
    ours = (tmp_path / jax_state.IMAGE).read_bytes()
    assert hashlib.sha256(ours[:-32]).digest() == ours[-32:]
    assert _globals(ours) == _globals(real) == {
        ("numpy._core.numeric", "_frombuffer"), ("numpy", "dtype"),
        ("optax._src.transform", "ScaleByAdamState"),
        ("optax._src.base", "EmptyState")}
    # With optax here, ours unpickles to optax's own classes.
    ours_step, ours_tree = pickle.loads(ours[:-32])
    assert ours_step == step
    assert [type(s) for s in ours_tree["opt_state"]] == \
        [type(s) for s in tree["opt_state"]]
    assert _layout(ours_tree) == _layout(tree)
    # Written without an optax module of its own: the real one untouched.
    assert sys.modules["optax"] is optax
