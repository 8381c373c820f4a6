"""The port's trainer with sequence and pipeline parallelism
(``LLAMA_SP``, ``LLAMA_PP``) as gloo processes on the CPU, its sharded
checkpoints across pipeline widths, and the refusals of the sp and pp
paths against the JAX package's.

- ``LLAMA_SP=2`` and ``LLAMA_PP=2``, each as two processes, 3 steps on a
  small corpus (tiny config, fp32): both ranks report the one-process
  run's losses within 1e-5; each prints its mesh with sp and pp, and the
  pp run its pipeline line.
- A checkpoint saved at pp=2 (step 2) restores at pp=1 (one process) and
  at tp=2 (two processes), and the losses after the resume equal the
  one-process run's within 1e-5.
- Refusals with JAX's types and messages: ``sliding_window`` with sp,
  ``return_kv`` with sp or pp, a sequence sp does not divide, and a
  resize to a device count tp*sp*pp does not divide (JAX's main in
  process against the port's two processes).  (A layer count pp does not
  divide and a batch the microbatches do not divide: in
  tests/test_torch_pipeline.py.)
- ``choose_microbatches`` equals JAX's over a grid, and
  ``pipeline_microbatches`` takes JAX's M wherever it divides a rank's
  rows; where it does not, the largest M that does.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_multiprocess import _close, _Sink, _train  # noqa: E402
from trainingjob_operator_tpu_torch.data import write_tokens  # noqa: E402
from trainingjob_operator_tpu.models import llama as jllama  # noqa: E402
from trainingjob_operator_tpu.parallel import mesh as jmesh  # noqa: E402
from trainingjob_operator_tpu_torch import constants as tconst  # noqa: E402
from trainingjob_operator_tpu_torch.models import llama as tllama  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import mesh as tmesh  # noqa: E402

STEPS = 4


class _Rank:
    """One rank's view of a mesh without a process group: what the sp and
    pp refusals read before any collective."""

    def __init__(self, **sizes):
        spec = tmesh.MeshSpec.of(**sizes)
        self.sizes = spec.sizes
        self.axis_names = spec.names

    def size(self, axis):
        return self.sizes.get(axis, 1)

    def coord(self, axis):
        return 0

    def data_size(self):
        return self.size("dp") * self.size("fsdp")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process for 4 steps; LLAMA_SP=2 and LLAMA_PP=2 as two processes
    for 3 steps; the pp run's step 2 resumed at pp=1 and at tp=2."""
    work = tmp_path_factory.mktemp("sp_pp_train")
    corpus = str(work / "c.tokens")
    write_tokens(corpus, np.random.default_rng(3).integers(0, 256, 4000),
                 vocab_size=256)
    sink = _Sink()
    out = {"dir": work}
    try:
        out["one"] = _train(sink, "one", str(work / "one"), 1, corpus,
                            steps=STEPS, coordinator=False)
        out["sp2"] = _train(sink, "sp2", str(work / "sp2"), 2, corpus,
                            steps=3, extra={"LLAMA_SP": "2"})
        out["pp2"] = _train(sink, "pp2", str(work / "pp2"), 2, corpus,
                            steps=3, extra={"LLAMA_PP": "2"})
        for job, world, extra in (("pp2_to_one", 1, {}),
                                  ("pp2_to_tp2", 2, {"LLAMA_TP": "2"})):
            shutil.copytree(work / "pp2", work / job)
            shutil.rmtree(work / job / "llama" / "3")
            out[job] = _train(sink, job, str(work / job), world, corpus,
                              steps=STEPS, coordinator=world > 1,
                              extra=extra)
        out["losses"] = {(job, rank): sink.losses(job, rank)
                         for job, world in (("one", 1), ("sp2", 2),
                                            ("pp2", 2), ("pp2_to_one", 1),
                                            ("pp2_to_tp2", 2))
                         for rank in range(world)}
    finally:
        sink.close()
    return out


@pytest.mark.parametrize("job,axes", [
    ("sp2", "'pp': 1, 'fsdp': 1, 'tp': 1, 'sp': 2"),
    ("pp2", "'pp': 2, 'fsdp': 1, 'tp': 1, 'sp': 1")])
def test_two_processes_train_as_one(runs, job, axes):
    want = runs["losses"][("one", 0)]
    for rank in range(2):
        _close(runs["losses"][(job, rank)], {k: want[k] for k in (1, 2, 3)})
        start = [ln for ln in runs[job][rank] if ln.startswith("width ")]
        assert f"mesh {{'dp': 1, {axes}, 'ep': 1}}" in start[0]
        piped = [ln for ln in runs[job][rank] if ln.startswith("pipeline:")]
        # LLAMA_BATCH 4 and accumulation 2: two rows a microbatch step,
        # JAX's default M = 8 (S - 1) capped to them.
        assert piped == (["pipeline: stages=2 microbatches=2 bubble=0.333"]
                         if job == "pp2" else [])


@pytest.mark.parametrize("job,world", [("pp2_to_one", 1),
                                       ("pp2_to_tp2", 2)])
def test_a_pp2_checkpoint_resumes_at_another_layout(runs, job, world):
    want = runs["losses"][("one", 0)]
    for rank in range(world):
        _close(runs["losses"][(job, rank)],
               {k: want[k] for k in range(3, STEPS + 1)})
        assert f"resumed at step 2 (width {world})" in runs[job][rank]


def _both(jax_fn, torch_fn):
    """(type name, message) of what each side raises."""
    out = []
    for fn in (jax_fn, torch_fn):
        with pytest.raises(Exception) as err:
            fn()
        out.append((type(err.value).__name__, str(err.value)))
    return out


def _configs(**kw):
    jc = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32",
                             **kw)
    return jc, tllama.LlamaConfig(**jc.__dict__)


def _params(jc, tc):
    jp = jllama.init_params(jc, jax.random.PRNGKey(0))
    tp = tllama.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    return jp, tp


TOKENS = np.zeros((2, 8), np.int32)


@pytest.mark.parametrize("what", ["sliding_window", "return_kv"])
def test_sequence_parallel_refusals_equal_jax(what):
    window = 4 if what == "sliding_window" else 0
    jc, tc = _configs(sliding_window=window)
    jp, tp = _params(jc, tc)
    kw = {"return_kv": what == "return_kv", "sequence_parallel": True}
    (jt, jm), (tt, tm) = _both(
        lambda: jllama.forward(jp, jnp.asarray(TOKENS), jc, **kw),
        lambda: tllama.forward(tp, torch.from_numpy(TOKENS).long(), tc,
                               **kw))
    assert (tt, tm) == (jt, jm) == ("ValueError", tm)
    assert what in tm


def test_return_kv_under_a_pipeline_is_refused_as_jax_refuses_it():
    jc, tc = _configs()
    jp, tp = _params(jc, tc)
    mesh = jmesh.make_mesh(jmesh.MeshSpec.of(pp=2), devices=jax.devices()[:2])
    got = _both(
        lambda: jllama.forward(jp, jnp.asarray(TOKENS), jc, mesh=mesh,
                               return_kv=True),
        lambda: tllama.forward(tp, torch.from_numpy(TOKENS).long(), tc,
                               mesh=_Rank(pp=2), return_kv=True))
    assert got[0] == got[1] == ("ValueError", "return_kv is not supported "
                                "under pipeline parallelism (stage-sharded "
                                "layers)")


def test_a_sequence_sp_does_not_divide_is_refused_as_jax_refuses_it():
    jc, tc = _configs()
    jp, tp = _params(jc, tc)
    tokens = np.zeros((2, 7), np.int32)
    mesh = jmesh.make_mesh(jmesh.MeshSpec.of(fsdp=2, sp=4),
                           devices=jax.devices()[:8])
    (jt, jm), (tt, tm) = _both(
        lambda: jax.jit(lambda p, t: jllama.loss_fn(
            p, {"tokens": t}, jc, mesh=mesh, sequence_parallel=True))(
                jp, jnp.asarray(tokens)),
        lambda: tllama.loss_fn(tp, {"tokens": torch.from_numpy(tokens)},
                               tc, mesh=_Rank(fsdp=2, sp=4),
                               sequence_parallel=True))
    assert tt == jt == "ValueError"
    # JAX's shard_map names its arguments' shapes; both say the split.
    for msg in (jm, tm):
        assert "not evenly divisible" in msg and \
            "4 does not evenly divide 6" in msg


def _degraded(lines):
    return [ln[ln.index("(") + 1:ln.index(")")] for ln in lines
            if ln.startswith("resize: live rebootstrap degraded")]


def test_a_resize_tp_sp_pp_does_not_divide_is_refused_as_jax_refuses_it(
        runs, monkeypatch, tmp_path, capsys):
    """A generation of one device under LLAMA_SP=2: JAX's main in process
    (its doc names the devices) and the port's two processes (one device
    each, the doc keeps rank 0) both leave the live rung at ``reshard``
    with the same ``RebootstrapError``."""
    from trainingjob_operator_tpu.workloads import llama_elastic as jle

    rdv = tmp_path / "rdv"
    rdv.mkdir()
    (rdv / "generation.json").write_text(json.dumps(
        {"generation": 1, "world": [0, 1], "devices": 1}))
    for key, value in {"LLAMA_SP": "2", "LLAMA_STEPS": "4",
                       "LLAMA_CKPT_EVERY": "2", "LLAMA_BATCH": "8",
                       "LLAMA_SEQ": "16",
                       tconst.CHECKPOINT_DIR_ENV: str(tmp_path / "jax"),
                       tconst.ELASTIC_REPLICAS_ENV: "2",
                       tconst.RESIZE_DIR_ENV: str(rdv),
                       tconst.RESIZE_POLL_ENV: "0"}.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv(tconst.RENDEZVOUS_GENERATION_ENV, raising=False)
    capsys.readouterr()
    assert jle.main() == 143
    want = _degraded(capsys.readouterr().out.splitlines())
    rdv2 = tmp_path / "rdv2"
    rdv2.mkdir()
    (rdv2 / "generation.json").write_text(json.dumps(
        {"generation": 1, "world": [0]}))
    sink = _Sink()
    try:
        rank0, _ = _train(sink, "refuse", str(tmp_path / "torch"), 2,
                          str(runs["dir"] / "c.tokens"), rcs=[143, 143],
                          extra={"LLAMA_SP": "2",
                                 tconst.RESIZE_DIR_ENV: str(rdv2),
                                 tconst.RESIZE_POLL_ENV: "0"})
    finally:
        sink.close()
    assert _degraded(rank0) == want == [
        "RebootstrapError: 1 devices not divisible by tp*sp*pp=2"]


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("stages", [2, 4])
def test_choose_microbatches_equals_jax(stages, explicit):
    for batch in range(1, 17):
        for target in (1, 2, 3, 4, 8, 16, 24):
            for n_data in (1, 2, 4):
                args = (batch, target, n_data, stages, explicit)
                assert tllama.choose_microbatches(*args) == \
                    jllama.choose_microbatches(*args), args


@pytest.mark.parametrize("rows,sizes,request_", [
    (4, {"pp": 2}, None), (8, {"pp": 4}, None), (2, {"pp": 2, "fsdp": 2}, 2),
    (4, {"pp": 2, "fsdp": 2}, None), (6, {"pp": 2}, 4),
    (16, {"pp": 2, "dp": 2, "fsdp": 2}, None)])
def test_the_port_takes_jax_microbatches_where_they_divide_its_rows(
        rows, sizes, request_):
    mesh = _Rank(**sizes)
    m, m_jax = tllama.pipeline_microbatches(rows, mesh, request_)
    S, n_data = mesh.size("pp"), mesh.data_size()
    want = jllama.choose_microbatches(
        rows * n_data, request_ or 8 * (S - 1), n_data, S,
        request_ is not None)
    assert m_jax == want and rows % want == 0 and m == want


def test_where_jax_microbatches_do_not_divide_the_rows_the_port_diverges(
        monkeypatch):
    """pp=2 x fsdp=2 and two rows a rank: JAX splits the global batch of 4
    into 4 (its flash condition gives way to a shallower bubble), which
    cannot split a rank's 2 rows; the port takes 2.  The same through
    LLAMA_PP_MICROBATCH=4; and an explicit 8 over dp=2 x fsdp=2 takes
    all 8 of JAX's global rows, 2 a rank."""
    mesh = _Rank(pp=2, fsdp=2)
    assert tllama.pipeline_microbatches(2, mesh) == (2, 4)
    monkeypatch.setenv("LLAMA_PP_MICROBATCH", "4")
    assert tllama.pipeline_microbatches(2, mesh) == (2, 4)
    assert tllama.pipeline_microbatches(2, _Rank(pp=2, dp=2, fsdp=2),
                                        8) == (2, 8)
