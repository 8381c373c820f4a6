"""Llama-2 pretraining on one card or across processes, resized in place:
the port of the JAX package's ``workloads/llama_elastic.py``.

The loss (``models/llama.py`` ``loss_fn``), its backward through the flash
backward kernels, gradient accumulation, AdamW in optax's order, and the
step loop with checkpoints, preemption, prefetch and telemetry
(``workloads/train.py`` ``run_elastic_loop``).  With
``TRAININGJOB_CHECKPOINT_DIR`` set, ``{"params", "opt_state", "step"}``
is restored from ``<dir>/llama`` (or initialised) and saved every
LLAMA_CKPT_EVERY steps; SIGTERM saves the current step and exits 143.

Across processes (``TRAININGJOB_COORDINATOR_ADDRESS``, ``_NUM_PROCESSES``,
``_PROCESS_ID``; ``MEGASCALE_NUM_SLICES`` sets dp) each process drives one
card: the process group forms (``rendezvous.initialize_distributed``;
with a coordinator address a single process forms a group of one), the
``dp x pp x fsdp x tp x sp`` mesh is built as the JAX
``mesh_from_rendezvous`` builds it, each process initialises and keeps
only its blocks of the parameters and AdamW state, trains on its rows of
the global batch (and, under sp, its sequence block of them), and writes
its shard of each checkpoint, which restores at any width.  LLAMA_SP > 1
runs attention as ring attention over the sequence blocks, LLAMA_PP > 1
the layer stack as a GPipe pipeline over the stages (``models/llama.py``;
LLAMA_PP_MICROBATCH, or JAX's default, sets the microbatches, taken from
each process's rows: ``llama.pipeline_microbatches``).

Resize in place (``TRAININGJOB_RESIZE_DIR``): the step loop polls the
controller's ``generation.json`` (``rendezvous.GenerationWatcher``) and
leaves at the step boundary where a newer generation appears; then
``resize_cycle`` climbs JAX's ladder.  The process group is destroyed and
formed again at the published coordinator, rank and world
(``rendezvous.rebootstrap_distributed``), the mesh is rebuilt, and one
process keeps its live parameters and AdamW state on its device
(``parallel/reshard.py`` ``redistribute``: rung ``live``); processes of a
multi-process job restore the last checkpoint onto the new mesh instead
(``fallback=1``), with no process restart.  A failed phase degrades one
rung: ``checkpoint`` saves the interrupted step and exits 143, and where
that save fails too, ``restart_all`` exits 143 without one.  Each rung
prints JAX's lines (``resize_rung``, ``resize_timing``, ``resized in
place``).  The parameters start as a seeded random init
drawn on the CPU (``torch.Generator`` seed 0, not JAX's PRNGKey(0)), the
same on every device and at every width (and not drawn when a checkpoint
restores), f32 masters cast to the compute dtype at each use.

The worker first runs the pod contract (``rendezvous.prepare_worker``: a
reservation pod holds and exits 143, ``TRAININGJOB_JAX_PLATFORM`` picks
the device where ``--device`` is not given, the kernel library looks in
the job's cache), then restores inside ``train.overlapped_restore``
beside the kernels' warm-up (``train.warm_up``), and prints JAX's
``recovery_timing`` split, ``compile_s`` being the warm-up's wall time.
A job the JAX package's trainer committed resumes from its resume image
(``from_jax_state``; an orbax step without one is refused in the
preamble).  JAX's executable snapshot and ``aot_or_jit`` have no counterpart: the
eager step compiles nothing, and the kernels take no shape, so the cached
library serves every width.

Run: ``python -m trainingjob_operator_tpu_torch.workloads.llama_elastic
[--device cuda|cpu]``.  Env, as the JAX module reads it:
LLAMA_CONFIG=tiny|124m|7b, LLAMA_TP, LLAMA_SP, LLAMA_PP,
LLAMA_PP_MICROBATCH, LLAMA_STEPS, LLAMA_BATCH (global),
LLAMA_SEQ, LLAMA_LR, LLAMA_ACCUM (gradient-accumulation microbatches),
LLAMA_CKPT_EVERY (the loss-print and checkpoint cadence), LLAMA_REMAT
(none/full/attn/dots; default ``default_remat``: "attn" at 32 layers,
else "none"), LLAMA_CE_CHUNK (chunked cross-entropy;
0 = whole logits), LLAMA_WINDOW (sliding-window span; 0 = full causal),
LLAMA_DTYPE (the compute dtype, bfloat16 or float32; default the
config's: float32 makes runs on the CPU and the card comparable),
LLAMA_DATA (a ``.tokens`` corpus; default synthetic tokens), LLAMA_SEED,
LLAMA_EVAL_EVERY / LLAMA_EVAL_BATCHES / LLAMA_EVAL_FRACTION.  The
operator's worker env (``constants.py``): TRAININGJOB_CHECKPOINT_DIR,
TRAININGJOB_REPLICA_NAME / _INDEX / _RESTARTCOUNT, the rendezvous above,
the resize channel and its knobs (TRAININGJOB_RESIZE_DIR,
TRAININGJOB_RENDEZVOUS_GENERATION, _RESIZE_POLL_S, _RESIZE_FASTPATH,
_RESIZE_LIVE, _RESIZE_BARRIER_S, _RESIZE_FAULT), and the knobs of
``workloads/train.py`` (snapshot saves, fault injection, profiler, step
times, telemetry, trace).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from trainingjob_operator_tpu_torch import resolve_device


def make_step_fn(params, cfg, *, accum: int, lr: float, remat="none",
                 ce_chunk: int = 0, opt_state: Optional[dict] = None,
                 mesh=None, loss_fn: Optional[Callable] = None,
                 sequence_parallel: bool = False
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The train step of ``main``: loss and gradients of ``loss_fn``
    (default ``llama.loss_fn``; ``moe_pretrain`` passes ``moe.loss_fn``)
    over ``accum`` interleaved microbatches, then one AdamW update
    (``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1)``, as
    ``llama_elastic.py:111`` builds it) from ``opt_state`` (zeros when
    None).  ``step_fn(tokens [B, T+1])`` updates the leaves of ``params``
    (which must require grad) and the optimizer state ``step_fn.opt.state``
    in place and returns the loss.

    With a ``mesh``, ``params`` and ``opt_state`` are this process's blocks
    and ``tokens`` its rows of the global batch; the gradients reach each
    block summed over the data axes (``llama.loss_fn``), so AdamW, which is
    elementwise, updates the blocks as it would the whole leaves, and the
    loss returned is the global one.  ``sequence_parallel`` is passed to
    ``llama.loss_fn`` where set (JAX's ``llama_elastic.py:139-141``)."""
    from trainingjob_operator_tpu_torch.models import llama
    from trainingjob_operator_tpu_torch.workloads import train

    opt = train.AdamW(params, lr, b1=0.9, b2=0.95, weight_decay=0.1,
                      state=opt_state)
    model_loss = loss_fn or llama.loss_fn

    extra = {"sequence_parallel": True} if sequence_parallel else {}

    def loss(p, tokens):
        return model_loss(p, {"tokens": tokens}, cfg, remat=remat,
                          ce_chunk=ce_chunk, mesh=mesh, **extra)

    def step_fn(tokens):
        value, grads = train.accumulated_value_and_grad(loss, params, tokens,
                                                        accum)
        opt.step(params, grads)
        return value

    step_fn.opt = opt
    return step_fn


def state_blocks(cfg, mesh, model=None) -> Dict[str, Any]:
    """This process's blocks (``sharding.Block``) of the parameters and
    the AdamW moments on ``mesh``, keyed as the checkpoint tree, under the
    ``param_shapes`` and ``mesh_rules`` of the family's ``model`` module
    (default ``models.llama``, whose layers split on pp; the MoE trainer
    passes ``models.moe``); ``{}`` (every leaf whole) without a mesh."""
    if mesh is None:
        return {}
    from trainingjob_operator_tpu_torch.models import llama
    from trainingjob_operator_tpu_torch.parallel import sharding

    model = model or llama
    blocks = sharding.tree_blocks(model.param_shapes(cfg),
                                  model.mesh_rules(mesh), mesh)
    return {"params": blocks, "opt_state": {"mu": blocks, "nu": blocks}}


def shard_layout(rdv, cfg, mesh, model=None):
    """The checkpoint ``ShardLayout`` of this process on ``mesh``, laid
    out by the family's ``model`` (``state_blocks``); None without a mesh:
    the single-process format."""
    if mesh is None:
        return None
    from trainingjob_operator_tpu_torch.workloads import train

    return train.ShardLayout(rdv.process_id, rdv.num_processes,
                             state_blocks(cfg, mesh, model))


def from_jax_state(cfg):
    """``CheckpointState.restore_or_init``'s ``convert`` for the JAX
    Llama (or MoE) trainer's committed tree: f32 master parameters
    (``params_from_numpy(master=True)``) and optax's AdamW state as
    ``train.AdamW``'s, on the CPU."""
    from trainingjob_operator_tpu_torch.models import llama
    from trainingjob_operator_tpu_torch.workloads import train

    def convert(tree):
        return {"params": llama.params_from_numpy(tree["params"], cfg, "cpu",
                                                  master=True),
                "opt_state": train.adamw_state_from_numpy(tree["opt_state"],
                                                          "cpu")}

    return convert


@dataclasses.dataclass
class TrainState:
    """What a resize in place carries from one width to the next: the
    rendezvous, the device, the mesh (None on the single-process path),
    the world as replica indices, the live parameters and AdamW state
    (this process's blocks), the checkpoint state, the step to resume at,
    and the last resize's timings (``resize_cycle``)."""

    rdv: Any
    device: torch.device
    mesh: Any
    world: List[int]
    params: Dict[str, Any]
    opt_state: Dict[str, Any]
    state: Any
    start_step: int = 0
    last_resize: Dict[str, Any] = dataclasses.field(default_factory=dict)


def persist_and_exit(ts: TrainState, step: int) -> int:
    """The checkpoint rung: save the live state at ``step``, wait for it,
    and return 143 for the operator to restart the job at the new
    width."""
    from trainingjob_operator_tpu_torch.workloads import train

    ts.state.save({"params": ts.params, "opt_state": ts.opt_state,
                   "step": step}, wait=True)
    ts.state.finalize()
    return train.GracefulShutdown.EXIT_CODE


def resize_cycle(ts: TrainState, watcher, *, cfg, lr: float, tp: int,
                 rebuild: Callable[[TrainState], None], tracer,
                 trace_parent: str = "", sp: int = 1,
                 pp: int = 1) -> Optional[int]:
    """One resize in place, for the generation doc ``watcher.pending``:
    the ladder of the JAX ``llama_elastic`` loop.

    Rebootstrap the process group at the published generation (span
    ``resize.rendezvous``), build the new mesh (``resize.requod``: one
    process drives one card, so the new world has as many cards as
    processes, which tp sp pp must divide; sp and pp stay), then take the live rung where one
    process held the whole state (``redistribute`` on its device; span
    ``resize.reshard``) or restore the last committed checkpoint onto the
    new mesh (``fallback=1``; a fresh init at the interrupted step where
    none is committed), and ``rebuild(ts)`` everything the width
    determines (``resize.compile``).  ``ts`` is updated in place and None
    returned; ``ts.last_resize`` holds the rung, the timings and the
    traffic estimate.  A failure anywhere degrades one rung: ``checkpoint``
    saves at ``watcher.resume_step`` and returns 143, and where that save
    fails, ``restart_all`` returns 143 without one.  Prints the JAX
    lines, letter for letter."""
    from trainingjob_operator_tpu_torch import constants
    from trainingjob_operator_tpu_torch.models import llama
    from trainingjob_operator_tpu_torch.parallel import mesh as pmesh
    from trainingjob_operator_tpu_torch.parallel import reshard, sharding
    from trainingjob_operator_tpu_torch.workloads import rendezvous, train

    doc = watcher.pending
    watcher.pending = None
    generation = int(doc.get("generation", 0))
    t_r0 = time.time()
    rdv, world = ts.rdv, ts.world
    was_multi = rdv.num_processes > 1
    ladder_phase = "shutdown"
    try:
        if (was_multi and os.environ.get(constants.RESIZE_LIVE_ENV, "1")
                == "0"):
            raise rendezvous.RebootstrapError(
                "shutdown", f"{constants.RESIZE_LIVE_ENV}=0 forces the "
                            "checkpoint rung")
        with tracer.span("resize.rendezvous", parent=trace_parent,
                         generation=generation,
                         processes=rdv.num_processes):
            new_rdv, rdv_times = rendezvous.rebootstrap_distributed(
                rdv, doc, old_world=world)
        t_rdv = time.time()
        device = ts.device
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        new_world = [int(r) for r in doc["world"]]
        lost_ranks = [i for i, r in enumerate(world)
                      if r not in set(new_world)]
        n_dev = new_rdv.num_processes
        inner = tp * sp * pp
        if n_dev <= 0 or n_dev % inner != 0:
            raise rendezvous.RebootstrapError(
                "reshard", f"{n_dev} devices not divisible by "
                           f"tp*sp*pp={inner}")
        ladder_phase = "reshard"
        rendezvous.check_fault("reshard", generation)
        train.push_rendezvous_record(sum(rdv_times.values()),
                                     rendezvous.RUNG_LIVE,
                                     phase_ms=rdv_times)
        shapes = {path: tuple(shape) for path, shape in
                  sharding.tree_paths(llama.param_shapes(cfg)) if shape}
        agg = reshard.plan_pytree_exchange(shapes, len(world),
                                           len(new_world), lost=lost_ranks)
        # One process holds every block of the state; across processes a
        # block held by another rank would need a cross-process exchange,
        # which neither package has: those restore from the checkpoint.
        addressable = not was_multi
        with tracer.span("resize.requod", parent=trace_parent,
                         generation=generation, world=len(new_world),
                         devices=n_dev):
            spec = pmesh.resized_mesh_spec(n_dev, new_rdv.num_slices, tp,
                                           sp, pp)
            new_mesh = None
            if ts.mesh is not None or was_multi:
                new_mesh = pmesh.make_mesh(spec, device.type,
                                           new_rdv.num_slices)
        t_r1 = time.time()
        fellback = 0
        if not was_multi and (agg["covered"] or addressable):
            with tracer.span("resize.reshard", parent=trace_parent,
                             moved_bytes=agg["moved_bytes"]):
                old, new = (state_blocks(cfg, ts.mesh),
                            state_blocks(cfg, new_mesh))
                ts.params = reshard.redistribute(
                    ts.params, old.get("params"), new.get("params"))
                ts.opt_state = reshard.redistribute(
                    ts.opt_state, old.get("opt_state"),
                    new.get("opt_state"))
                ts.state.layout = shard_layout(new_rdv, cfg, new_mesh)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            ts.start_step = watcher.resume_step
        else:
            # The checkpoint restore of the fallback rung: commit a save
            # still in flight first, then drop the old state before the
            # template of the new one is allocated.
            fellback = 1
            with tracer.span("resize.reshard", parent=trace_parent,
                             fallback=True):
                ts.state.finalize()
                ts.params = ts.opt_state = None
                generator = None
                if not train.CheckpointState.has_checkpoint(new_rdv,
                                                            subdir="llama"):
                    generator = torch.Generator().manual_seed(0)
                params = llama.init_params(cfg, generator, device,
                                           master=True, mesh=new_mesh)
                ts.state = train.CheckpointState.restore_or_init(
                    new_rdv, {"params": params,
                              "opt_state": train.AdamW(params, lr).state,
                              "step": watcher.resume_step},
                    subdir="llama",
                    layout=shard_layout(new_rdv, cfg, new_mesh),
                    convert=from_jax_state(cfg))
                del params
                ts.params = ts.state.value["params"]
                ts.opt_state = ts.state.value["opt_state"]
                for leaf in train.tree_leaves(ts.params):
                    leaf.requires_grad_(True)
                ts.start_step = int(ts.state.value["step"])
        t_r2 = time.time()
        ts.rdv, ts.device, ts.mesh, ts.world = (new_rdv, device, new_mesh,
                                                new_world)
        with tracer.span("resize.compile", parent=trace_parent,
                         devices=n_dev):
            rebuild(ts)
        t_r3 = time.time()
    # The ladder guard: any failure of the guarded region (injected, a
    # torch.distributed error, a bug mid-reshard) degrades one rung.
    except Exception as exc:
        phase = getattr(exc, "phase", ladder_phase)
        injected = bool(getattr(exc, "injected", False))
        print(f"resize_rung generation={generation} "
              f"rung={rendezvous.RUNG_CHECKPOINT} phase={phase} "
              f"injected={int(injected)}", flush=True)
        print(f"resize: live rebootstrap degraded at phase "
              f"{phase} ({type(exc).__name__}: {exc}); checkpointing "
              "and exiting 143 for operator restart", flush=True)
        train.push_rendezvous_record(
            (time.time() - t_r0) * 1e3, rendezvous.RUNG_CHECKPOINT,
            reason=f"{phase}: {exc}")
        ts.last_resize = {"generation": generation,
                          "rung": rendezvous.RUNG_CHECKPOINT, "phase": phase}
        try:
            rendezvous.check_fault("persist", generation)
            return persist_and_exit(ts, watcher.resume_step)
        # The checkpoint rung degrades to restart_all on any failure of
        # the save (I/O, an injected fault, a barrier on the destroyed
        # group): a survivor never wedges.
        except Exception as exc2:
            print(f"resize_rung generation={generation} "
                  f"rung={rendezvous.RUNG_RESTART_ALL} phase=persist "
                  f"injected={int(getattr(exc2, 'injected', False))}",
                  flush=True)
            print(f"resize: checkpoint rung failed "
                  f"({type(exc2).__name__}: {exc2}); exiting 143 "
                  "without a fresh checkpoint -- restart-all recovers "
                  "from the last committed step", flush=True)
            train.push_rendezvous_record(
                (time.time() - t_r0) * 1e3, rendezvous.RUNG_RESTART_ALL,
                reason=f"persist: {exc2}")
            ts.last_resize["rung"] = rendezvous.RUNG_RESTART_ALL
            return train.GracefulShutdown.EXIT_CODE
    watcher.reenter(generation)
    print(f"resize_rung generation={generation} "
          f"rung={rendezvous.RUNG_LIVE} phase=-", flush=True)
    timing = {"rendezvous_s": t_rdv - t_r0, "requod_s": t_r1 - t_rdv,
              "reshard_s": t_r2 - t_r1,
              "moved_mb": agg["moved_bytes"] / 2 ** 20,
              "fallback": fellback, "compile_s": t_r3 - t_r2}
    ts.last_resize = {"generation": generation, "rung": rendezvous.RUNG_LIVE,
                      "width": len(new_world), "phase_ms": rdv_times,
                      "mesh": spec.sizes, **timing}
    print(f"resize_timing generation={generation} "
          f"width={len(new_world)} "
          f"rendezvous_s={timing['rendezvous_s']:.2f} "
          f"requod_s={timing['requod_s']:.2f} "
          f"reshard_s={timing['reshard_s']:.2f} "
          f"moved_mb={timing['moved_mb']:.1f} "
          f"fallback={fellback} compile_s={timing['compile_s']:.2f}",
          flush=True)
    print(f"resized in place: mesh {spec.sizes}, resuming at step "
          f"{ts.start_step}", flush=True)
    return None


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "python -m trainingjob_operator_tpu_torch.workloads.llama_elastic")
    parser.add_argument("--device", default=None,
                        help="cuda or cpu (default: the card, or what "
                             "TRAININGJOB_JAX_PLATFORM asks for)")
    args = parser.parse_args(argv)
    t_main = time.time()
    from trainingjob_operator_tpu_torch.workloads import rendezvous

    rdv, device = rendezvous.prepare_worker(args.device, subdir="llama")
    device = resolve_device(device)

    from trainingjob_operator_tpu_torch.models import llama
    from trainingjob_operator_tpu_torch.obs.trace import tracer_from_env
    from trainingjob_operator_tpu_torch.parallel import mesh as pmesh
    from trainingjob_operator_tpu_torch.parallel import pipeline, sharding
    from trainingjob_operator_tpu_torch.workloads import train

    env = os.environ
    cfg_name = env.get("LLAMA_CONFIG", "tiny")
    if cfg_name not in llama.CONFIGS:
        print(f"LLAMA_CONFIG={cfg_name!r} unknown; expected one of "
              f"{sorted(llama.CONFIGS)}", flush=True)
        return 1
    cfg = llama.CONFIGS[cfg_name]()
    dtype = env.get("LLAMA_DTYPE", "")
    if dtype:
        if dtype not in ("bfloat16", "float32"):
            raise ValueError(f"LLAMA_DTYPE={dtype!r}: expected bfloat16 or "
                             f"float32")
        cfg = dataclasses.replace(cfg, dtype=dtype)
    tp = int(env.get("LLAMA_TP", "1"))
    sp = int(env.get("LLAMA_SP", "1"))
    pp = int(env.get("LLAMA_PP", "1"))
    llama.check_tp(cfg, tp)
    llama.check_pp(cfg, pp)
    spec = pmesh.mesh_spec_from_rendezvous(rdv, model_parallel=tp,
                                           sequence_parallel=sp,
                                           pipeline_parallel=pp)
    mesh = None
    if rdv.coordinator_address or rdv.num_processes > 1:
        device = rendezvous.initialize_distributed(rdv, device)
        mesh = pmesh.make_mesh(spec, device.type, rdv.num_slices)
    t_init = time.time()
    steps = int(env.get("LLAMA_STEPS", "20"))
    batch_req = int(env.get("LLAMA_BATCH", "8"))
    seq = int(env.get("LLAMA_SEQ", "128"))
    lr = float(env.get("LLAMA_LR", "3e-4"))
    ckpt_every = int(env.get("LLAMA_CKPT_EVERY", "10"))
    accum_req = int(env.get("LLAMA_ACCUM", "1"))
    remat = llama.remat_policy(env.get("LLAMA_REMAT",
                                       train.default_remat(cfg.n_layers)))
    ce_chunk = int(env.get("LLAMA_CE_CHUNK", "0"))
    window = int(env.get("LLAMA_WINDOW", "0"))
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)

    print(f"width {rdv.elastic_replicas}, device {device}"
          f"{f', mesh {mesh.sizes}' if mesh is not None else ''}, "
          f"{llama.num_params(cfg) / 1e6:.1f}M params, restart "
          f"{rdv.restart_count}", flush=True)
    # Drawn on the CPU, so that the card and the CPU start from the same
    # parameters, as JAX's PRNG gives the same on every device; a restart
    # that restores a checkpoint draws nothing.
    generator = None
    if not train.CheckpointState.has_checkpoint(rdv, subdir="llama"):
        generator = torch.Generator().manual_seed(0)
    params = llama.init_params(cfg, generator, device, master=True,
                               mesh=mesh)
    opt_state = train.AdamW(params, lr).state
    t_setup = time.time()
    tracer, trace_parent = tracer_from_env()

    def restore_fn():
        # One checkpoint path for every process of the job, as in JAX.
        return train.CheckpointState.restore_or_init(
            rdv, {"params": params, "opt_state": opt_state, "step": 0},
            subdir="llama", layout=shard_layout(rdv, cfg, mesh),
            convert=from_jax_state(cfg))

    # The kernels' warm-up runs beside the restore (JAX's warm compile):
    # a cold kernel cache builds here, not inside the first step.
    state, _, rtimes = train.overlapped_restore(
        restore_fn, train.warm_up(device), tracer=tracer,
        trace_parent=trace_parent)
    train.push_resume_record(rtimes["restore_s"], state.fallback,
                             rtimes["compile_s"], rtimes["overlap"])
    ts = TrainState(rdv=rdv, device=device, mesh=mesh,
                    world=list(range(max(rdv.elastic_replicas, 1))),
                    params=state.value["params"],
                    opt_state=state.value["opt_state"], state=state,
                    start_step=int(state.value["step"]))
    del params, opt_state
    if ts.start_step > 0:
        print(f"resumed at step {ts.start_step} (width "
              f"{rdv.elastic_replicas})", flush=True)
    # JAX's recovery breakdown, for its log readers: init = the process
    # group, setup = the model's allocation, restore = the checkpoint read,
    # compile = the kernels' warm-up (``train.warm_up``), and
    # resume_phases_wall = the restore||warm-up region's wall clock (about
    # the larger of the two with resume_overlap=1, their sum with
    # TRAININGJOB_RESUME_OVERLAP=0).  The first step is printed by
    # run_elastic_loop.
    print(f"recovery_timing init_s={t_init - t_main:.2f} "
          f"setup_s={t_setup - t_init:.2f} "
          f"restore_s={rtimes['restore_s']:.2f} "
          f"compile_s={rtimes['compile_s']:.2f} "
          f"resume_phases_wall_s={rtimes['wall_s']:.2f} "
          f"resume_overlap={int(rtimes['overlap'])}", flush=True)
    for leaf in train.tree_leaves(ts.params):
        leaf.requires_grad_(True)

    width: Dict[str, Any] = {}

    def width_build(ts: TrainState) -> None:
        """Everything the mesh width determines, into ``width``: the batch
        geometry, the step over this process's state, the batch sources
        and eval.  Called at startup and after every resize in place."""
        mesh = ts.mesh
        n_data = mesh.data_size() if mesh is not None else 1
        global_batch, accum = train.round_global_batch(batch_req, n_data,
                                                       accum=accum_req)
        row0, local_batch = (sharding.data_rows(global_batch, mesh)
                             if mesh is not None else (0, global_batch))
        if mesh is not None and mesh.size("pp") > 1:
            rows = local_batch // accum
            m, m_jax = llama.pipeline_microbatches(rows, mesh)
            print(f"pipeline: stages={mesh.size('pp')} microbatches={m} "
                  f"bubble={pipeline.bubble_fraction(mesh.size('pp'), m):.3f}"
                  + (f" (JAX's {m_jax} does not divide this process's "
                     f"{rows} rows)" if m != m_jax else ""), flush=True)
        # Training batches are made on the host and copied to the card by
        # the loop's prefetcher; eval batches go straight to the card.
        batch_at, eval_host_at, eval_every, eval_batches = (
            train.build_batch_sources(
                prefix="LLAMA", vocab_size=cfg.vocab_size,
                global_batch=global_batch, seq=seq, synthetic_key=17,
                device="cpu", local_batch=local_batch, row0=row0))
        params, dev = ts.params, ts.device
        eval_fn = None
        if eval_host_at is not None:
            # Same remat and ce_chunk as the train step: eval fits where
            # training fits.
            eval_fn = train.mean_eval_fn(
                lambda tokens: llama.loss_fn(params, {"tokens": tokens}, cfg,
                                             remat=remat, ce_chunk=ce_chunk,
                                             mesh=mesh,
                                             sequence_parallel=sp > 1),
                lambda j: eval_host_at(j).to(dev), eval_batches)
        width.clear()
        width.update(
            global_batch=global_batch, batch_at=batch_at, eval_fn=eval_fn,
            eval_every=eval_every,
            step_fn=make_step_fn(params, cfg, accum=accum, lr=lr,
                                 remat=remat, ce_chunk=ce_chunk,
                                 opt_state=ts.opt_state, mesh=mesh,
                                 sequence_parallel=sp > 1))

    width_build(ts)
    watcher = (rendezvous.GenerationWatcher(rdv) if rdv.resize_dir
               else None)
    n_params = llama.num_params(cfg)
    try:
        while True:
            tokens_per_step = width["global_batch"] * seq
            loss, t_start = train.run_elastic_loop(
                step_fn=width["step_fn"], batch_at=width["batch_at"],
                state=ts.state, params=ts.params, opt_state=ts.opt_state,
                steps=steps, start_step=ts.start_step,
                ckpt_every=ckpt_every, eval_fn=width["eval_fn"],
                eval_every=width["eval_every"],
                units_per_step=tokens_per_step,
                flops_per_step=6.0 * n_params * tokens_per_step,
                device=ts.device, resize_watch=watcher, tracer=tracer,
                trace_parent=trace_parent)
            if watcher is None or watcher.pending is None:
                break
            # The step closes over the old width's state and mesh.
            width.clear()
            rc = resize_cycle(ts, watcher, cfg=cfg, lr=lr, tp=tp,
                              rebuild=width_build, tracer=tracer,
                              trace_parent=trace_parent, sp=sp, pp=pp)
            if rc is not None:
                return rc
    finally:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    dt = max(time.time() - (t_start or time.time()), 1e-9)
    done = max(steps - ts.start_step - 1, 1)
    print(f"done: steps={done} tokens/s={done * tokens_per_step / dt:.0f} "
          f"width={len(ts.world)} "
          f"final_loss={float(loss) if loss is not None else -1:.4f} "
          f"restart_count={rdv.restart_count}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
