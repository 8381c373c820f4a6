"""The port's ``workloads/moe_pretrain.py`` on the CPU at MOE_CONFIG=tiny.

- What cannot run is refused as JAX refuses it: an MOE_EP that does not
  divide the world and an MOE_TP x MOE_EP that leaves a data axis the
  slices do not divide with JAX's ``mesh_from_rendezvous`` errors, a tp
  that does not divide the heads at startup (JAX's step raises on it).
- It trains in process and prints the JAX module's params and done lines.
- As two gloo processes with MOE_EP=2: both print the same global losses,
  which fall, and write a sharded checkpoint; it resumes on one process
  and on two at fsdp=2, the restored blocks equal to what was saved bit
  for bit, and GEN_FAMILY=moe generate samples from it.
- As its own processes on one checkpoint directory: SIGTERM commits the
  step and exits 143, and the restart resumes there and ends on the same
  parameters and AdamW state as an uninterrupted run, bit for bit; then
  the ``generate`` and ``serve`` mains with GEN_FAMILY=moe read its
  checkpoint.
"""

import os
import shutil
import signal
import subprocess
import sys
import warnings
from pathlib import Path

import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

from test_torch_parallel import _free_port, _Rank  # noqa: E402
from trainingjob_operator_tpu.models import moe as jmoe  # noqa: E402
from trainingjob_operator_tpu_torch.models import moe as tmoe  # noqa: E402
from trainingjob_operator_tpu_torch.models import moe_decode as tmd  # noqa: E402,E501
from trainingjob_operator_tpu_torch.parallel import mesh as tmesh  # noqa: E402,E501
from trainingjob_operator_tpu_torch.parallel import sharding as tsharding  # noqa: E402,E501
from trainingjob_operator_tpu_torch.workloads import llama_elastic  # noqa: E402,E501
from trainingjob_operator_tpu_torch.workloads import moe_pretrain  # noqa: E402,E501
from trainingjob_operator_tpu_torch.workloads import train as ttrain  # noqa: E402,E501

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(2)


#: refusal -> (the port's env, JAX's mesh_from_rendezvous arguments and
#: env), on 8 processes / JAX's 8 virtual devices.
REFUSALS = {
    "ep_does_not_divide_the_world": (
        {"MOE_EP": "3"}, {"expert_parallel": 3}, {}),
    "tp_ep_leave_a_data_axis_the_slices_do_not_divide": (
        {"MOE_TP": "2", "MOE_EP": "2", "MEGASCALE_NUM_SLICES": "4"},
        {"model_parallel": 2, "expert_parallel": 2},
        {"MEGASCALE_NUM_SLICES": "4"}),
    "tp_does_not_divide_the_heads": (
        {"MOE_TP": "8"}, {"model_parallel": 8}, {}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_equal_jax(monkeypatch, case):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from trainingjob_operator_tpu.parallel import mesh as jmesh
    from trainingjob_operator_tpu.parallel import sharding as jsharding
    from trainingjob_operator_tpu.workloads import rendezvous as jrdv

    env, jax_args, jax_env = REFUSALS[case]
    assert jax.device_count() == 8
    monkeypatch.setenv("TRAININGJOB_NUM_PROCESSES", "8")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError) as got:
        moe_pretrain.main(["--device", "cpu"])
    if case != "tp_does_not_divide_the_heads":
        with pytest.raises(ValueError) as want:
            jmesh.mesh_from_rendezvous(jrdv.from_env(jax_env), **jax_args)
        assert str(got.value) == str(want.value)
        return
    # JAX builds the mesh and raises at the step, where the sharded flash
    # attention cannot split 4 heads over tp=8; the port refuses at
    # startup, naming the tp and the heads.
    assert str(got.value) == "tp=8 does not divide n_heads=4"
    mesh = jmesh.mesh_from_rendezvous(jrdv.from_env(jax_env), **jax_args)
    jc = dataclasses.replace(jmoe.MoEConfig.tiny(), dtype="float32")
    params = jsharding.shard_pytree(
        jmoe.init_params(jc, jax.random.PRNGKey(0)), jmoe.SHARDING_RULES,
        mesh)
    with pytest.raises(ValueError, match="not evenly divisible"):
        jax.jit(lambda p, t: jmoe.loss_fn(p, {"tokens": t}, jc, mesh=mesh))(
            params, jnp.zeros((2, 17), jnp.int32))


def test_trains_on_the_cpu_when_asked(monkeypatch, capsys):
    monkeypatch.setenv("MOE_STEPS", "3")
    monkeypatch.setenv("MOE_BATCH", "2")
    monkeypatch.setenv("MOE_SEQ", "16")
    monkeypatch.setenv("MOE_CE_CHUNK", "8")
    monkeypatch.setenv("MOE_REMAT", "dots")
    assert moe_pretrain.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    jc = jmoe.MoEConfig.tiny()
    assert out[0] == (
        "elastic width 1, mesh {'dp': 1, 'pp': 1, 'fsdp': 1, 'tp': 1, "
        f"'sp': 1, 'ep': 1}}, {jmoe.num_params(jc) / 1e6:.1f}M params "
        f"({jmoe.active_params(jc) / 1e6:.1f}M active), restart 0")
    assert any(ln.startswith("step 3/3 loss ") for ln in out)
    assert out[-1].startswith("done: steps=2 tokens/s=")
    assert " width=1 final_loss=" in out[-1]


def _env(ckpt, steps):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update({"MOE_CONFIG": "tiny", "MOE_BATCH": "4", "MOE_SEQ": "32",
                "MOE_STEPS": str(steps), "MOE_CKPT_EVERY": "2",
                "TRAININGJOB_CHECKPOINT_DIR": str(ckpt),
                "OMP_NUM_THREADS": "2"})
    return env


def _run(env, sigterm_after=None, timeout=120):
    cmd = [sys.executable, "-m",
           "trainingjob_operator_tpu_torch.workloads.moe_pretrain",
           "--device", "cpu"]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if sigterm_after and line.startswith(sigterm_after):
                proc.send_signal(signal.SIGTERM)
                sigterm_after = None
        return proc.wait(timeout=timeout), lines
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """A run given SIGTERM after step 2, its restart to two steps past the
    committed one, and an uninterrupted run to the same step."""
    ckpt = tmp_path_factory.mktemp("moe_ckpt")
    plain = tmp_path_factory.mktemp("moe_plain")
    rc, lines = _run(_env(ckpt, 200), sigterm_after="step 2/200 ")
    assert rc == 143, lines
    assert lines[-1] == "preemption checkpoint committed; exiting 143"
    k = ttrain.committed_steps(str(ckpt / "moe"))[0]
    assert k >= 2
    last = k + 2
    rc_restart, restart = _run(_env(ckpt, last))
    rc_plain, uninterrupted = _run(_env(plain, last))
    assert rc_restart == 0 and rc_plain == 0, (restart, uninterrupted)
    return ckpt, plain, k, last, restart, uninterrupted


def _saved(root, step, name):
    return torch.load(root / "moe" / str(step) / f"{name}.pt",
                      weights_only=True)


def test_a_restart_resumes_bit_for_bit(resumed):
    ckpt, plain, k, last, restart, uninterrupted = resumed
    assert f"resumed at step {k} (width 1)" in restart
    assert any(ln.startswith(f"step {k + 1}/{last} loss ")
               and ln.endswith("(first after resume)") for ln in restart)
    final = f"step {last}/{last} loss "
    assert [ln for ln in restart if ln.startswith(final)] == \
        [ln for ln in uninterrupted if ln.startswith(final)]
    for name in ("params", "opt_state"):
        got = ttrain.tree_leaves(_saved(ckpt, last, name))
        want = ttrain.tree_leaves(_saved(plain, last, name))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), name


def test_generate_and_serve_read_the_checkpoint(resumed, monkeypatch,
                                                capsys):
    from trainingjob_operator_tpu_torch.workloads import generate, serve

    ckpt, _, _, last, _, _ = resumed
    monkeypatch.setenv("TRAININGJOB_CHECKPOINT_DIR", str(ckpt))
    monkeypatch.setenv("GEN_FAMILY", "moe")
    monkeypatch.setenv("GEN_STEPS", "4")
    monkeypatch.setenv("GEN_PROMPT", "1,2,3")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert generate.main(["--device", "cpu"]) == 0
        out = capsys.readouterr().out.splitlines()
        cfg = tmoe.MoEConfig.tiny()
        params = ttrain._onto(tmoe.init_params(cfg, None, "cpu"),
                              _saved(ckpt, last, "params"))
        want = tmd.generate(params, torch.tensor([[1, 2, 3]]), cfg,
                            steps=4)[0].tolist()
    assert f"sampling from checkpoint at step {last}" in out
    assert "tokens: " + ",".join(map(str, want)) in out

    monkeypatch.setenv("TRAININGJOB_SERVE_REQUESTS", "4")
    monkeypatch.setenv("TRAININGJOB_SERVE_SLOTS", "2")
    assert serve.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"serving the checkpoint at step {last}" in out
    assert "family=moe" in out and "completed=4" in out
    assert "stale_kv_violations=0" in out


def _run_job(envs, timeout=120):
    """(exit codes, output lines) of one trainer process per env, started
    together (the ranks of one job, or independent jobs)."""
    cmd = [sys.executable, "-m",
           "trainingjob_operator_tpu_torch.workloads.moe_pretrain",
           "--device", "cpu"]
    procs = []
    try:
        for env in envs:
            procs.append(subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], [o.splitlines() for o in outs]


def _ranks(ckpt, steps, world, **extra):
    """The envs of a ``world``-process job on checkpoint dir ``ckpt``."""
    port = _free_port()
    envs = []
    for pid in range(world):
        env = _env(ckpt, steps)
        env.update({"OMP_NUM_THREADS": "1", "MOE_LR": "3e-3",
                    "TRAININGJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                    "TRAININGJOB_NUM_PROCESSES": str(world),
                    "TRAININGJOB_PROCESS_ID": str(pid), **extra})
        envs.append(env)
    return envs


#: The MOE_EP=2 job's steps and the step its restarts run to.
SHARDED_STEPS, RESUMED_STEPS = 6, 8


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """A two-process MOE_EP=2 job's output and checkpoint dir (steps 4 and
    6 committed as shards), then, on copies of the dir and side by side,
    its resume to RESUMED_STEPS on one process (no coordinator) and on two
    at fsdp=2."""
    ckpt = tmp_path_factory.mktemp("moe_ep2")
    rcs, lines = _run_job(_ranks(ckpt, SHARDED_STEPS, 2, MOE_EP="2"))
    assert rcs == [0, 0], lines
    one = tmp_path_factory.mktemp("moe_one") / "ck"
    fsdp = tmp_path_factory.mktemp("moe_fsdp2") / "ck"
    for dst in (one, fsdp):
        shutil.copytree(ckpt, dst)
    alone = _env(one, RESUMED_STEPS)
    alone.update({"OMP_NUM_THREADS": "1", "MOE_LR": "3e-3"})
    resumed_rcs, resumed = _run_job([alone] + _ranks(fsdp, RESUMED_STEPS, 2))
    return ckpt, lines, resumed_rcs, resumed


def _mesh_line(lines):
    return next(ln for ln in lines if ln.startswith("elastic width "))


def _losses(lines):
    return [ln for ln in lines if ln.startswith("step ") and " loss " in ln]


def test_ep2_ranks_print_the_same_falling_losses(sharded):
    _, lines, _, _ = sharded
    mesh = ("mesh {'dp': 1, 'pp': 1, 'fsdp': 1, 'tp': 1, 'sp': 1, "
            "'ep': 2}")
    assert all(mesh in _mesh_line(out) for out in lines), lines
    first, second = (_losses(out) for out in lines)
    assert first == second and len(first) == SHARDED_STEPS // 2, lines
    values = [float(ln.split(" loss ")[1].split()[0]) for ln in first]
    assert values[-1] < values[0], values
    assert all(out[-1].startswith("done: steps=5 ") for out in lines)


def test_the_sharded_step_resumes_at_other_widths(sharded):
    ckpt, _, rcs, resumed = sharded
    assert rcs == [0, 0, 0], resumed
    assert ttrain.committed_steps(str(ckpt / "moe")) == [6, 4]
    for out in resumed:
        assert f"resumed at step {SHARDED_STEPS} (width 1)" in out, out
        assert out[-1].startswith("done: steps=1 "), out
    assert "'fsdp': 1," in _mesh_line(resumed[0])
    assert "'fsdp': 2," in _mesh_line(resumed[1])
    assert _losses(resumed[1]) == _losses(resumed[2])


def _saved_whole(ckpt, step):
    """Every leaf of the saved step whole, from the shards' blocks; where
    two shards hold an element (a replicated block) they agree bit for
    bit."""
    d = ckpt / "moe" / str(step)
    shards = [torch.load(d / f"shard-{r}.pt", weights_only=True)
              for r in range(2)]
    whole = {}
    for sh in shards:
        for key in ("params", "opt_state"):
            value = sh["value"][key]
            blocks = sh["blocks"][key]
            if key == "opt_state":
                value = {k: value[k] for k in ("mu", "nu")}
            for path, leaf in tsharding.tree_paths(value):
                shape, index = dict(tsharding.tree_paths(blocks))[path]
                full = whole.setdefault(f"{key}/{path}",
                                        torch.full(shape, float("nan")))
                cut = tuple(slice(a, b) for a, b in index)
                held = full[cut]
                seen = ~torch.isnan(held)
                assert torch.equal(held[seen], leaf[seen]), path
                full[cut] = leaf
    assert not any(torch.isnan(x).any() for x in whole.values())
    return whole


@pytest.mark.parametrize("width", [1, 2])
def test_restored_blocks_equal_what_was_saved(sharded, monkeypatch, width):
    from trainingjob_operator_tpu_torch.workloads import rendezvous

    ckpt = sharded[0]
    whole = _saved_whole(ckpt, SHARDED_STEPS)
    monkeypatch.setenv("TRAININGJOB_CHECKPOINT_DIR", str(ckpt))
    cfg = tmoe.MoEConfig.tiny()
    spec = tmesh.MeshSpec.of(fsdp=width, tp=1, ep=1)
    for r in range(width):
        mesh = _Rank(spec, r) if width > 1 else None
        params = tmoe.init_params(cfg, None, "cpu", master=True, mesh=mesh)
        layout = llama_elastic.shard_layout(
            rendezvous.Rendezvous(process_id=r, num_processes=width), cfg,
            mesh, tmoe)
        state = ttrain.CheckpointState.restore_or_init(
            rendezvous.from_env(),
            {"params": params, "opt_state": ttrain.AdamW(params, 1.0).state,
             "step": 0}, subdir="moe", layout=layout)
        assert state.value["step"] == SHARDED_STEPS
        blocks = llama_elastic.state_blocks(cfg, mesh, tmoe)
        for key in ("params", "opt_state/mu", "opt_state/nu"):
            tree = state.value
            for part in key.split("/"):
                tree = tree[part]
            index = dict(tsharding.tree_paths(
                blocks["params"])) if blocks else {}
            for path, leaf in tsharding.tree_paths(tree):
                full = whole[f"{key}/{path}"]
                cut = (tsharding.block_slices(index[path]) if index
                       else (slice(None),) * full.dim())
                assert torch.equal(leaf, full[cut]), (r, key, path)


def test_generate_samples_from_the_sharded_step(sharded, monkeypatch,
                                                capsys):
    from trainingjob_operator_tpu_torch.workloads import generate

    ckpt = sharded[0]
    monkeypatch.setenv("TRAININGJOB_CHECKPOINT_DIR", str(ckpt))
    monkeypatch.setenv("GEN_FAMILY", "moe")
    monkeypatch.setenv("GEN_STEPS", "4")
    monkeypatch.setenv("GEN_PROMPT", "5,6,7")
    cfg = tmoe.MoEConfig.tiny()
    whole = _saved_whole(ckpt, SHARDED_STEPS)
    params = ttrain._onto(
        tmoe.init_params(cfg, None, "cpu"),
        _nested({path[len("params/"):]: x for path, x in whole.items()
                        if path.startswith("params/")}))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert generate.main(["--device", "cpu"]) == 0
        want = tmd.generate(params, torch.tensor([[5, 6, 7]]), cfg,
                            steps=4)[0].tolist()
    out = capsys.readouterr().out.splitlines()
    assert f"sampling from checkpoint at step {SHARDED_STEPS}" in out
    assert "tokens: " + ",".join(map(str, want)) in out


def _nested(flat):
    """A nested dict from ``{"a/b": leaf}``."""
    tree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree
