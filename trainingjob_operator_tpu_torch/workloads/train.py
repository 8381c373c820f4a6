"""Training plumbing for the port: own copy of the JAX package's
``workloads/train.py``.

Gradient accumulation (``accumulated_value_and_grad``), batch geometry
(``round_global_batch``), the batch sources (``build_batch_sources``),
``default_remat``, ``mean_eval_fn``, ``throughput_line``, the AdamW of
``workloads/llama_elastic.py`` in optax's order (``AdamW``, whose state is
a tree ``{"count", "mu", "nu"}``), optax's SGD with momentum (``SGD``,
state ``{"trace"}``), the crash injection of the kill-and-resume
contract (``kill_at_step``), checkpoints (``CheckpointState``: step
directories, the resume image and their fallback ladder), the resume fast
path (``overlapped_restore`` with ``warm_up``, and its
``push_resume_record``), the preemption
handler (``GracefulShutdown``), the step profiler and telemetry
(``StepProfiler``), the step loop (``run_elastic_loop``, run by every
process of a job alike, under ``peer_loss_guard``) and the resize's
telemetry (``push_rendezvous_record``).

Parameters are a nested dict of tensors (the ``models/llama.py`` tree);
where JAX returns new trees, the port updates the leaves in place.

The durable checkpoint format is the port's own, since orbax is JAX's: a
step directory ``<path>/<step>/`` holds one ``torch.save`` file per
top-level item (``params.pt``, ``opt_state.pt``, ``step.pt``), written
under a temporary name and committed by ``os.replace``; the newest 2 are
kept (orbax ``max_to_keep=2``).  A sharded job's step directory holds
instead one ``shard-<rank>.pt`` per process: its blocks and their global
index ranges (``ShardLayout``), read back at any width.  Beside them,
``resume-image.bin`` (one process only) is the JAX package's container:
``pickle((step, tree))`` of numpy leaves and a sha256 footer.

A job the JAX package's worker committed resumes from the same path: the
JAX worker's resume image (a single-process job's, beside its orbax step
directories) is read without optax and converted by the workload's
``convert`` (``jax_state``, ``CheckpointState.restore_or_init``).  Orbax
step directories themselves are never read, pruned or committed over:
where one is the newest committed state and no image is beside it (a
multi-process JAX job, or ``TRAININGJOB_CKPT_SNAPSHOT=0``), the worker is
refused before it touches its device (``refuse_unreadable_state``).
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import math
import os
import pickle
import shutil
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from trainingjob_operator_tpu_torch import constants
from trainingjob_operator_tpu_torch.obs.logs import (
    configure_logging,
    get_logger,
)
from trainingjob_operator_tpu_torch.obs.telemetry import TelemetryEmitter
from trainingjob_operator_tpu_torch.obs.trace import tracer_from_env
from trainingjob_operator_tpu_torch.utils.metrics import METRICS
from trainingjob_operator_tpu_torch.workloads import jax_state


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``tree`` with every leaf ``x`` replaced by ``fn(x)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def trainable_copy(tree, device):
    """A copy of a parameter tree on ``device`` whose leaves require grad
    (a copy on the same device too, so that training it leaves ``tree`` as
    it was)."""
    return tree_map(lambda x: x.detach().to(device, copy=True)
                    .requires_grad_(True), tree)


def _rebuild(tree, leaves):
    """A tree shaped like ``tree`` holding the next items of ``leaves``."""
    return tree_map(lambda _: next(leaves), tree)


def accumulated_value_and_grad(loss_fn: Callable, params: Dict[str, Any],
                               tokens: torch.Tensor, accum: int):
    """(loss, grads) of ``loss_fn(params, tokens)`` over ``accum``
    microbatches, as the JAX function: microbatch ``a`` takes the rows
    ``r`` with ``r % accum == a`` (the interleaved split of
    ``train.py:1285``), losses and gradients are summed, then multiplied by
    ``1 / accum``.  Equals the full-batch gradient for a mean loss.

    The leaves of ``params`` must require grad; the gradients accumulate in
    their ``.grad`` (one buffer per leaf, added to in place), which the
    returned tree holds."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = None
    if accum <= 1:
        loss = loss_fn(params, tokens)
        loss.backward()
        return loss.detach(), _rebuild(params, iter(p.grad for p in leaves))
    B = tokens.shape[0]
    if B % accum != 0:
        raise ValueError(f"batch {B} not divisible by accum={accum}")
    micro_batches = tokens.reshape(B // accum, accum,
                                   *tokens.shape[1:]).transpose(0, 1)
    total = None
    for tb in micro_batches:
        loss = loss_fn(params, tb)
        loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
    inv = 1.0 / accum
    return total * inv, _rebuild(params,
                                 iter(p.grad.mul_(inv) for p in leaves))


class AdamW:
    """``optax.adamw(lr, b1, b2, eps, weight_decay)`` as
    ``workloads/llama_elastic.py:111`` builds it (b1 0.9, b2 0.95,
    weight decay 0.1 on every leaf, eps 1e-8), in optax's order: the
    moments, their bias corrections at step count t, then
    ``p += -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.
    ``torch.optim.AdamW`` computes the same update in another order of
    rounding (tests/test_torch_train.py).

    The state is the tree ``self.state = {"count": int, "mu": tree, "nu":
    tree}`` (``mu`` and ``nu`` shaped like the parameters, zero at the
    start; ``adamw_state_from_numpy`` converts optax's).  ``step`` updates
    the parameters and the state in place, so the dict a checkpoint was
    handed stays the live state."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 state: Optional[Dict[str, Any]] = None):
        self.lr, self.b1, self.b2 = float(lr), float(b1), float(b2)
        self.eps, self.weight_decay = float(eps), float(weight_decay)
        if state is None:
            state = {"count": 0,
                     "mu": tree_map(lambda p: torch.zeros_like(
                         p, requires_grad=False), params),
                     "nu": tree_map(lambda p: torch.zeros_like(
                         p, requires_grad=False), params)}
        self.state = state

    @torch.no_grad()
    def step(self, params, grads) -> None:
        self.state["count"] += 1
        count = self.state["count"]
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(self.state["mu"]),
                              tree_leaves(self.state["nu"])):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-self.lr)


def adamw_state_from_numpy(opt_state, device="cuda") -> Dict[str, Any]:
    """optax's ``adamw`` state (its leaves as numpy) -> the ``AdamW`` state
    tree on ``device``: the ``ScaleByAdamState`` (count, mu, nu) of the
    chain, mu and nu as f32 trees keyed like the parameters (the other
    links of optax's chain hold no state)."""
    from trainingjob_operator_tpu_torch import resolve_device

    dev = resolve_device(device)
    adam = next(s for s in opt_state
                if all(hasattr(s, f) for f in ("count", "mu", "nu")))

    def to_torch(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    return {"count": int(np.asarray(adam.count)),
            "mu": tree_map(to_torch, adam.mu),
            "nu": tree_map(to_torch, adam.nu)}


class SGD:
    """``optax.sgd(lr, momentum)`` (``workloads/resnet_dp.py:64``): the
    trace ``t = g + momentum * t``, then ``p += -lr * t``.  The state is
    the tree ``self.state = {"trace": tree}`` (zeros like the parameters
    at the start; ``sgd_state_from_numpy`` converts optax's), updated in
    place with the parameters, as ``AdamW``'s."""

    def __init__(self, params, lr: float, momentum: float = 0.9,
                 state: Optional[Dict[str, Any]] = None):
        self.lr, self.momentum = float(lr), float(momentum)
        if state is None:
            state = {"trace": tree_map(lambda p: torch.zeros_like(
                p, requires_grad=False), params)}
        self.state = state

    @torch.no_grad()
    def step(self, params, grads) -> None:
        for p, g, t in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(self.state["trace"])):
            t.mul_(self.momentum).add_(g)
            p.add_(t, alpha=-self.lr)


def sgd_state_from_numpy(opt_state, device="cuda",
                         convert: Optional[Callable] = None
                         ) -> Dict[str, Any]:
    """optax's ``sgd(lr, momentum)`` state (its leaves as numpy) -> the
    ``SGD`` state tree: the chain's ``TraceState`` trace, converted to the
    port's parameter tree by ``convert`` (a model's ``params_from_numpy``
    for the parameters; default f32 tensors of a tree of dicts) on
    ``device``."""
    from trainingjob_operator_tpu_torch import resolve_device

    dev = resolve_device(device)
    trace = next(s for s in opt_state if hasattr(s, "trace")).trace
    if convert is None:
        def convert(tree):
            return tree_map(lambda x: torch.from_numpy(
                np.array(x, dtype=np.float32)).to(dev), tree)
    return {"trace": convert(trace)}


def _ensure_workload_logging() -> None:
    """Install the structured handler once (JSON under
    ``TRAININGJOB_LOG_JSON=1``) when nothing handles the root logger, so
    the step records reach the worker's log."""
    if logging.getLogger().handlers:
        return
    configure_logging(json_output=os.environ.get(constants.LOG_JSON_ENV)
                      == "1", level=logging.INFO)


#: The "skip this top-level item on restore" marker of
#: ``CheckpointState.restore_or_init`` templates (orbax's PLACEHOLDER in
#: the JAX package).  Identity-compared, never saved.
_PLACEHOLDER = object()


def ckpt_placeholder() -> Any:
    """The marker that makes ``restore_or_init`` skip a top-level item: a
    sampler restores the parameters without reading the optimizer
    moments."""
    return _PLACEHOLDER


class CheckpointState:
    """Step-directory checkpoints of one tree, latest-step retention, and a
    background writer.

    The default is the **snapshot-donate** pipeline: ``save()`` copies the
    tree to the host at the step boundary (the only stall the loop sees)
    and a writer thread writes and commits the step directory, then the
    resume image.  ``TRAININGJOB_CKPT_SNAPSHOT=0``, or ``save(wait=True)``,
    takes the direct path: the save is written and committed before
    ``save`` returns.
    """

    #: Bounded re-check interval of the writer handshakes.
    _WAIT_S = 0.2
    #: Committed steps kept (orbax ``max_to_keep``).
    KEEP = 2

    def __init__(self, directory: str, value: Dict[str, Any],
                 layout: Optional["ShardLayout"] = None):
        self.value = value
        self._dir = directory
        self.layout = layout
        #: The last classified fallback of the restore that made this
        #: state ("" on the happy path): the resume record's ``fallback``.
        self.fallback = ""
        self._cv = threading.Condition()
        self._writer: Optional[threading.Thread] = None
        self._pending: Optional[tuple] = None
        self._busy = False
        self._error: Optional[BaseException] = None
        #: Set while a waited save supersedes the writer's write in flight.
        self._cancel = threading.Event()
        #: Last step whose write committed: the recovery point a crash in
        #: the middle of a write falls back to.
        self.committed_step: Optional[int] = None
        #: Step-visible wall time of the most recent ``save()``, ms.
        self.last_stall_ms = 0.0

    @classmethod
    def restore_or_init(cls, rdv, init_value: Dict[str, Any],
                        subdir: Optional[str] = None,
                        layout: Optional["ShardLayout"] = None,
                        convert: Optional[Callable[[Any], Dict[str, Any]]]
                        = None) -> "CheckpointState":
        """The newest committed step under the worker's path, restored onto
        ``init_value``'s devices and dtypes, or ``init_value`` itself where
        there is none.  The path is ``<checkpoint_dir>/<subdir>`` (one path
        for every process of a job: it must outlive a change of width), or
        ``<checkpoint_dir>/<replica>/<index>`` without a subdir.

        Tensor leaves of ``init_value`` are the template: a checkpoint of
        another structure or shape fails here, not in a step.  A top-level
        item that is ``ckpt_placeholder()`` is not read at all.  A full
        restore tries the resume image first (one process only), then the
        committed steps, newest first (``_restore_with_fallback``).

        With a ``layout`` the template's leaves are this process's blocks
        of the job's, and saves write them as one shard of the step
        (``ShardLayout``).  A restore, with or without one, reads the
        ranges it needs from whatever the step holds: the shards of any
        width, or the single-process files.

        Where the port has committed no step of its own and the JAX
        package's worker has, its resume image restores
        (``_restore_jax``): ``convert`` maps the JAX trainer's tree to the
        port's (CPU tensors, the keys of ``init_value``)."""
        path = _checkpoint_path(rdv, subdir)
        if not path:
            return cls("", init_value, layout)
        os.makedirs(path, exist_ok=True)
        steps = committed_steps(path)
        blocks = layout.blocks if layout is not None else {}
        reasons: List[str] = []
        if not steps:
            jax_steps = jax_state.orbax_steps(path)
            if not jax_steps:
                return cls(path, init_value, layout)
            state = cls(path, _restore_jax(path, jax_steps[0], init_value,
                                           blocks, convert, reasons), layout)
            state.fallback = reasons[-1] if reasons else "jax_image"
            return state
        latest = steps[0]
        skip = [k for k, v in init_value.items() if v is _PLACEHOLDER]
        if skip:
            template = {k: v for k, v in init_value.items() if k not in skip}
            restored = _read_step(path, latest, template, blocks)
            for k in skip:
                restored[k] = _PLACEHOLDER
        else:
            restored = None
            if layout is None or layout.world == 1:
                restored = _load_resume_image(path, latest, init_value,
                                              reasons)
            if restored is None:
                restored = _restore_with_fallback(path, latest, init_value,
                                                  blocks, reasons)
        state = cls(path, restored, layout)
        state.fallback = reasons[-1] if reasons else ""
        return state

    @staticmethod
    def has_checkpoint(rdv, subdir: Optional[str] = None) -> bool:
        """Whether ``restore_or_init`` would restore a committed step, the
        port's or the JAX package's (then the values of its template are
        never read, only their shapes, dtypes and devices)."""
        path = _checkpoint_path(rdv, subdir)
        return bool(path and (committed_steps(path)
                              or jax_state.orbax_steps(path)))

    def snapshot_mode(self) -> bool:
        """True when saves take the snapshot-donate pipeline: not across
        processes, whose shards commit together on the step loop."""
        return (os.environ.get(constants.CKPT_SNAPSHOT_ENV, "1") != "0"
                and (self.layout is None or self.layout.world == 1))

    def _write_files(self, step: int, host_value: Dict[str, Any],
                     cancel: Optional[threading.Event] = None) -> bool:
        """Write and commit step ``step``; False where it was not
        committed (``_commit``)."""
        if self.layout is None:
            return _write_step(self._dir, step, host_value, self.KEEP,
                               cancel)
        return _write_shard(self._dir, step, host_value, self.KEEP,
                            self.layout, cancel)

    def save(self, value: Dict[str, Any], wait: bool = False,
             tracer: Any = None, trace_parent: Any = None) -> float:
        """Save ``value`` at its ``step``; returns the step-visible stall in
        ms.

        Snapshot mode: the host copy here (span ``ckpt.snapshot``), the
        write on the background writer (span ``ckpt.write``).  A new
        snapshot replaces one the writer has not started (latest wins; the
        committed steps stay monotonic).  A writer failure is raised from
        the next ``save()`` or ``finalize()``.

        Direct mode (``wait=True``, ``TRAININGJOB_CKPT_SNAPSHOT=0``, or
        a layout of more than one process, every one of which must call
        ``save``): the write and commit happen here; in snapshot mode a
        waited save also writes the resume image, so a preemption
        checkpoint resumes by the fast path.  A waited save supersedes the writer's older
        snapshot: a pending one is dropped and the one in flight is given
        up at its next file (the JAX package waits for it), so a
        preemption writes one state, not two, inside the shutdown
        watchdog's window."""
        t0 = time.perf_counter()
        self.value = value
        if not self._dir:
            return 0.0
        step = int(value.get("step", 0))
        if wait or not self.snapshot_mode():
            if wait:
                with self._cv:
                    self._pending = None
                    self._cancel.set()
            try:
                self._drain()
            finally:
                self._cancel.clear()
            with _span(tracer, "ckpt.write", parent=trace_parent,
                       step=step):
                host_value = _snapshot_to_host(value)
                committed = self._write_files(step, host_value)
            if committed:
                with self._cv:
                    self.committed_step = step
                if self.snapshot_mode():
                    _write_resume_image(self._dir, step, host_value)
        else:
            with self._cv:
                self._surface_error_locked()
                # Superseded by this save: its pinned buffers go back to
                # the host allocator first, for this snapshot to reuse.
                self._pending = None
            with _span(tracer, "ckpt.snapshot", parent=trace_parent,
                       step=step):
                host_value = _snapshot_to_host(value)
            with self._cv:
                self._pending = (step, host_value, tracer, trace_parent)
                if self._writer is None:
                    self._writer = threading.Thread(
                        target=self._writer_loop, daemon=True,
                        name="ckpt-writer")
                    self._writer.start()
                self._cv.notify_all()
        self.last_stall_ms = (time.perf_counter() - t0) * 1e3
        return self.last_stall_ms

    def _writer_loop(self) -> None:
        while True:
            with self._cv:
                while self._pending is None:
                    self._cv.wait(self._WAIT_S)
                step, host_value, tracer, parent = self._pending
                self._pending = None
                self._busy = True
            try:
                self._write(step, host_value, tracer, parent)
            except _Superseded:
                pass
            # Stashed and raised from the next save()/finalize() on the step
            # loop: the writer must neither die silently nor end the process.
            except BaseException as exc:
                with self._cv:
                    self._error = exc
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _write(self, step: int, host_value: Dict[str, Any], tracer: Any,
               parent: Any) -> None:
        with _span(tracer, "ckpt.write", parent=parent, step=step):
            if not self._write_files(step, host_value, self._cancel):
                return
        with self._cv:
            self.committed_step = step
        # After the commit, so the image is never newer than the step
        # directory it mirrors.
        _write_resume_image(self._dir, step, host_value, self._cancel)

    def _surface_error_locked(self) -> None:
        """Raise a stashed writer failure (the caller holds ``_cv``)."""
        if self._error is not None:
            exc, self._error = self._error, None
            raise RuntimeError(
                f"background checkpoint write failed; last committed step: "
                f"{self.committed_step}") from exc

    def _drain(self) -> None:
        """Block until the writer is idle, then raise a stashed writer
        error.  A writer stuck on a dead filesystem blocks here; under
        preemption the ``GracefulShutdown`` watchdog exits 143 and
        recovery falls back to ``committed_step``."""
        with self._cv:
            while self._pending is not None or self._busy:
                self._cv.wait(self._WAIT_S)
            self._surface_error_locked()

    def finalize(self) -> None:
        """Wait for the background write in flight; call before exit."""
        if self._dir:
            self._drain()


def refuse_unreadable_state(rdv, subdir: Optional[str]) -> None:
    """Raise ``jax_state.UnreadableJaxState`` where the worker's path holds
    no step of the port's and the JAX package's newest committed step has
    no resume image beside it.  Reads directory listings only: nothing is
    created, no device is touched."""
    path = _checkpoint_path(rdv, subdir)
    if not path or committed_steps(path):
        return
    steps = jax_state.orbax_steps(path)
    if steps and not os.path.exists(os.path.join(path, jax_state.IMAGE)):
        raise jax_state.refusal(
            path, steps[0], f"no {jax_state.IMAGE}: a multi-process JAX "
            "job, or TRAININGJOB_CKPT_SNAPSHOT=0")


def _checkpoint_path(rdv, subdir: Optional[str]) -> str:
    """The worker's checkpoint path ("" without a checkpoint root):
    ``<checkpoint_dir>/<subdir>``, or ``<checkpoint_dir>/<replica>/<index>``
    without a subdir."""
    directory = rdv.checkpoint_dir
    if not directory:
        return ""
    if subdir is not None:
        return os.path.join(os.path.abspath(directory), subdir)
    return os.path.join(os.path.abspath(directory),
                        rdv.replica_name or "worker", str(rdv.replica_index))


def _span(tracer: Any, name: str, parent: Any = None, **attrs: Any):
    """``tracer.span`` when a tracer is wired, else a no-op context.  Spans
    of the writer thread pass ``parent`` explicitly: the current-span
    variable is empty there."""
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, parent=parent, **attrs)


def _snapshot_to_host(value: Any) -> Any:
    """Host copy of a checkpoint tree.  Every CUDA leaf is copied into a
    fresh pinned buffer with ``non_blocking=True`` (PyTorch's host
    allocator recycles the pinned blocks of earlier snapshots), all copies
    are issued before one event is waited on, so the stall is one
    overlapped transfer.  The copies have landed when this returns: AdamW
    updates the parameters in place, and the next step may overwrite the
    device buffers at once.  CPU leaves are cloned; other leaves are kept
    as they are."""
    on_card = []

    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if x.is_cuda:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
            on_card.append(x)
            return host
        return x.clone()

    host_value = tree_map(copy, value)
    if on_card:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(on_card[0].device))
        done.synchronize()
    return host_value


class _Superseded(Exception):
    """A background write given up for a newer, waited save."""


def _check(cancel: Optional[threading.Event]) -> None:
    if cancel is not None and cancel.is_set():
        raise _Superseded


def committed_steps(path: str) -> List[int]:
    """The port's committed step directories under ``path``, newest first
    (the JAX package's orbax steps are not among them)."""
    try:
        names = os.listdir(path)
    except FileNotFoundError:
        return []
    return sorted((int(n) for n in names
                   if n.isdigit() and os.path.isdir(os.path.join(path, n))
                   and not jax_state.is_orbax_step(os.path.join(path, n))),
                  reverse=True)


class ShardLayout:
    """A process's place in a sharded checkpoint: its ``rank`` of
    ``world`` and, for each tensor leaf of its state tree (by the tree's
    keys), the block it holds: ``(global shape, ((start, stop), ...))``
    (``parallel/sharding.py`` ``Block``).  A leaf without a block is
    whole."""

    def __init__(self, rank: int, world: int, blocks: Dict[str, Any]):
        self.rank, self.world, self.blocks = rank, world, blocks


def _write_dir(path: str, step: int, files: Dict[str, Any], keep: int,
               cancel: Optional[threading.Event] = None) -> bool:
    """Write ``files`` (name -> object, one ``torch.save`` each) as step
    directory ``<path>/<step>`` under a temporary name, then commit it
    (``_commit``, whose result this returns).  Once ``cancel`` is set, the
    write stops before its next file, removes what it wrote and raises
    ``_Superseded``."""
    tmp = os.path.join(path, f".tmp-{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        for name, item in files.items():
            _check(cancel)
            torch.save(item, os.path.join(tmp, name))
        _check(cancel)
    except _Superseded:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return _commit(path, step, tmp, keep)


def _commit(path: str, step: int, tmp: str, keep: int) -> bool:
    """Make the written directory ``tmp`` step ``step`` by ``os.replace``
    (a step written again replaces the old directory), then drop all but
    the ``keep`` newest of the port's committed steps; True.  Where the
    name holds the JAX package's orbax step (a job resumed from an image
    older than it), that directory stays: ``tmp`` is removed and the step
    not committed (False)."""
    final = os.path.join(path, str(step))
    if jax_state.is_orbax_step(final):
        shutil.rmtree(tmp, ignore_errors=True)
        print(f"ckpt: step {step} not committed: {final} holds the JAX "
              f"package's orbax step", flush=True)
        return False
    old = None
    if os.path.exists(final):
        old = os.path.join(path, f".old-{step}-{os.getpid()}")
        os.replace(final, old)
    os.replace(tmp, final)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    for stale in committed_steps(path)[keep:]:
        shutil.rmtree(os.path.join(path, str(stale)), ignore_errors=True)
    return True


def _write_step(path: str, step: int, host_value: Dict[str, Any],
                keep: int, cancel: Optional[threading.Event] = None) -> bool:
    """The single-process format: one ``<key>.pt`` per top-level item of
    ``host_value`` in step directory ``<path>/<step>`` (``_write_dir``)."""
    return _write_dir(path, step, {f"{key}.pt": item
                            for key, item in host_value.items()},
               keep, cancel)


def _shard_name(rank: int) -> str:
    return f"shard-{rank}.pt"


def _write_shard(path: str, step: int, host_value: Dict[str, Any],
                 keep: int, layout: ShardLayout,
                 cancel: Optional[threading.Event] = None) -> bool:
    """The sharded format: each process writes ``shard-<rank>.pt``, its
    blocks with their global index ranges (``ShardLayout``), into the
    step's shared temporary directory; rank 0 commits the step only after
    a barrier every rank passes once its shard is in place, so a step that
    lacks a shard is never committed.  Alone (world 1) a process writes
    and commits as ``_write_dir`` does.  Returns ``_commit``'s result (True
    on the ranks that do not commit)."""
    payload = {"world": layout.world, "rank": layout.rank,
               "value": host_value, "blocks": layout.blocks}
    if layout.world == 1:
        return _write_dir(path, step, {_shard_name(0): payload}, keep,
                          cancel)
    import torch.distributed as dist

    tmp = os.path.join(path, f".tmp-{step}")
    if layout.rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    dist.barrier()
    target = os.path.join(tmp, _shard_name(layout.rank))
    torch.save(payload, f"{target}.part")
    os.replace(f"{target}.part", target)
    dist.barrier()
    committed = layout.rank != 0 or _commit(path, step, tmp, keep)
    # No rank saves or restores again before the commit is done.
    dist.barrier()
    return committed


def _step_pieces(path: str, step: int, keys) -> List[tuple]:
    """What step directory ``step`` holds, as (value tree, blocks tree)
    pieces: one per shard of the sharded format (every rank of the world
    it was written at must be there), or one whole piece of the
    single-process format's ``keys``."""
    d = os.path.join(path, str(step))
    names = sorted(n for n in os.listdir(d)
                   if n.startswith("shard-") and n.endswith(".pt"))
    if not names:
        return [({key: torch.load(os.path.join(d, f"{key}.pt"),
                                  map_location="cpu", weights_only=True)
                  for key in keys}, {})]
    shards = [torch.load(os.path.join(d, n), map_location="cpu",
                         weights_only=True, mmap=True) for n in names]
    world = shards[0]["world"]
    ranks = sorted(sh["rank"] for sh in shards)
    if ranks != list(range(world)) or any(sh["world"] != world
                                          for sh in shards):
        raise ValueError(f"step {step} holds the shards of ranks {ranks}, "
                         f"not all {world}")
    return [(sh["value"], sh["blocks"]) for sh in shards]


def _assemble(template: Any, blocks: Any, pieces: List[tuple],
              where: str = "") -> Any:
    """The template's leaves from ``pieces`` ((value, blocks) trees): each
    tensor leaf is this process's block (``blocks``; whole where absent),
    copied together from the overlapping blocks of the pieces, on the
    template leaf's device and in its dtype.  Raises ``ValueError`` where
    the keys or a global shape differ, or the pieces do not cover the
    block."""
    if isinstance(template, dict):
        for value, _ in pieces:
            if not isinstance(value, dict) or set(value) != set(template):
                got = sorted(value) if isinstance(value, dict) else \
                    type(value).__name__
                raise ValueError(f"checkpoint structure at {where or '/'}: "
                                 f"{got} != template {sorted(template)}")
        blocks = blocks or {}
        return {k: _assemble(t, blocks.get(k),
                             [(v[k], (b or {}).get(k)) for v, b in pieces],
                             f"{where}/{k}")
                for k, t in template.items()}
    if not isinstance(template, torch.Tensor):
        return pieces[0][0]

    def whole(x):
        return tuple(x.shape), tuple((0, n) for n in x.shape)

    shape, mine = blocks or whole(template)
    found = []
    for value, block in pieces:
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        if not isinstance(value, torch.Tensor):
            raise ValueError(f"checkpoint leaf {where}: {type(value).__name__}"
                             f" != template {tuple(shape)}")
        their_shape, theirs = block or whole(value)
        if tuple(their_shape) != tuple(shape):
            raise ValueError(f"checkpoint leaf {where}: shape "
                             f"{tuple(their_shape)} != template "
                             f"{tuple(shape)}")
        if tuple(theirs) == tuple(mine):
            # A piece that is the block itself (the same width, or one
            # process): no assembly.
            return value.to(device=template.device, dtype=template.dtype)
        found.append((value, theirs))
    out = torch.empty(template.shape, dtype=template.dtype)
    seen, covered = set(), 0
    for value, theirs in found:
        # The blocks of one layout are equal or disjoint: a replicated
        # block is copied once.
        if tuple(theirs) in seen:
            continue
        seen.add(tuple(theirs))
        lo = [max(a, c) for (a, _), (c, _) in zip(mine, theirs)]
        hi = [min(b, d) for (_, b), (_, d) in zip(mine, theirs)]
        if any(l_ >= h for l_, h in zip(lo, hi)):
            continue
        dst = tuple(slice(l_ - a, h - a) for l_, h, (a, _) in
                    zip(lo, hi, mine))
        src = tuple(slice(l_ - c, h - c) for l_, h, (c, _) in
                    zip(lo, hi, theirs))
        out[dst] = value[src]
        covered += math.prod(h - l_ for l_, h in zip(lo, hi))
    if covered != out.numel():
        raise ValueError(f"checkpoint leaf {where}: the step covers "
                         f"{covered} of its {out.numel()} elements")
    return out.to(template.device)


def _onto(template: Any, loaded: Any, where: str = "") -> Any:
    """``loaded`` (torch or numpy leaves, whole) in the template's
    structure, each tensor leaf on the template leaf's device and in its
    dtype.  Raises ``ValueError`` where the keys or a shape differ."""
    return _assemble(template, None, [(loaded, None)], where)


def _read_step(path: str, step: int, template: Dict[str, Any],
               blocks: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The top-level items of ``template`` from step directory ``step``
    (``torch.load(weights_only=True)``), each leaf this process's block
    (``blocks``; whole where absent) assembled from what the step holds
    (``_step_pieces``)."""
    pieces = [({k: v[k] for k in template if k in v}, b)
              for v, b in _step_pieces(path, step, list(template))]
    return _assemble(template, blocks, pieces)


def resume_fastpath_enabled() -> bool:
    """Whether the resume fast path is on: a restore reads the resume image
    first, and ``overlapped_restore`` runs the warm-up beside the restore.
    ``TRAININGJOB_RESUME_OVERLAP=0`` turns both off."""
    return os.environ.get(constants.RESUME_OVERLAP_ENV, "1") != "0"


def _note_fallback_metric(metric: str, reason: str,
                          reasons: Optional[List[str]] = None) -> None:
    """Count one classified checkpoint fallback, per reason, and append the
    reason to ``reasons`` where given (the resume record's ``fallback``)."""
    METRICS.inc(metric, reason=reason)
    if reasons is not None:
        reasons.append(reason)


def _image_leaf(x: Any) -> Any:
    """A host leaf as the resume image holds it: numpy where numpy has the
    dtype (the JAX package's image holds numpy), else the tensor."""
    if isinstance(x, torch.Tensor) and x.dtype != torch.bfloat16:
        return x.numpy()
    return x


class _HashingWriter:
    """A file's ``write`` that also feeds the bytes to sha256, so the
    image's footer is computed as the pickle streams out (no copy of the
    whole payload in memory); raises ``_Superseded`` once ``cancel`` is
    set."""

    def __init__(self, f, cancel: Optional[threading.Event]):
        self._f = f
        self._cancel = cancel
        self.sha = hashlib.sha256()

    def write(self, data) -> int:
        _check(self._cancel)
        self.sha.update(data)
        return self._f.write(data)


def _write_resume_image(path: str, step: int, host_value: Any,
                        cancel: Optional[threading.Event] = None) -> None:
    """Write the host snapshot as the **resume image**: ``(step, tree)`` in
    one pickle with a sha256 footer, atomically replaced.  A restore then
    costs one sequential read.  Best-effort: the step directory is the
    durable copy, and any problem with the image falls back to it.  A
    write stopped by ``cancel`` raises ``_Superseded``."""
    if not path:
        return
    target = os.path.join(path, jax_state.IMAGE)
    tmp = f"{target}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            body = _HashingWriter(f, cancel)
            pickle.dump((step, tree_map(_image_leaf, host_value)), body,
                        protocol=pickle.HIGHEST_PROTOCOL)
            f.write(body.sha.digest())
        os.replace(tmp, target)
    except _Superseded:
        os.remove(tmp)
        raise
    # The step directory is already committed; a failed image costs the
    # next resume its fast path, never correctness.
    except Exception as exc:
        print(f"ckpt: resume image write failed ({exc!r}); "
              f"next resume will use the step directories", flush=True)
        try:
            os.remove(tmp)
        except OSError:
            pass


def _load_resume_image(path: str, latest: int, template: Any,
                       reasons: Optional[List[str]] = None) -> Any:
    """Resume fast path: the state from the image of
    ``_write_resume_image``, onto the template.  Returns None (the caller
    falls back to the step directories) with a classified reason:
    ``missing``, ``corrupt`` (read error, truncation, sha256 mismatch,
    unpickling failure), ``stale`` (the image's step is not ``latest``) or
    ``structure_mismatch`` (the template's keys or shapes differ), counted
    per reason in ``trainingjob_resume_image_fallbacks_total`` and appended
    to ``reasons``.  ``TRAININGJOB_CKPT_FAULT=resume_image`` flips one byte
    of the image after the read, to exercise the corrupt rung."""
    if not resume_fastpath_enabled():
        return None

    def fall(reason: str, detail: str = "") -> None:
        _note_fallback_metric("trainingjob_resume_image_fallbacks_total",
                              reason, reasons)
        suffix = f" ({detail})" if detail else ""
        print(f"resume: image fallback reason={reason}{suffix}; "
              f"using the step directories", flush=True)

    try:
        raw = jax_state.read_verified(
            path, os.environ.get(constants.CKPT_FAULT_ENV, "")
            == "resume_image")
    except jax_state.ImageError as exc:
        fall(exc.reason, exc.detail)
        return None
    try:
        # The image was written by an earlier run of this job, behind a
        # verified footer: the same trust boundary as the checkpoint.
        step, host_value = pickle.loads(memoryview(raw)[:-jax_state.SHA_LEN])
    # Unpickling a verified but wrong payload can raise nearly anything;
    # every failure is the corrupt rung.
    except Exception as exc:
        fall("corrupt", f"unpickle failed: {exc!r}")
        return None
    if step != latest:
        fall("stale", f"image step {step} != latest {latest}")
        return None
    try:
        restored = _onto(template, host_value)
    except ValueError as exc:
        fall("structure_mismatch", f"{exc}")
        return None
    print(f"resume: step {step} restored from resume image", flush=True)
    return restored


def _restore_with_fallback(path: str, latest: int, template: Any,
                           blocks: Optional[Dict[str, Any]] = None,
                           reasons: Optional[List[str]] = None) -> Any:
    """Restore from the committed steps, newest first: ``latest``, then
    each earlier retained step (``_read_step`` with ``blocks``).  A failed
    rung -- a step missing a shard among them -- is counted in
    ``trainingjob_ckpt_restore_fallbacks_total`` with reason
    ``corrupt_latest`` (the newest step) or ``corrupt_retained`` (an
    older one), and appended to ``reasons``.
    ``TRAININGJOB_CKPT_FAULT=corrupt_latest`` fails the newest rung.  When
    every rung fails, the first error is raised."""
    steps = committed_steps(path)
    if latest not in steps:
        steps.insert(0, latest)
    inject = os.environ.get(constants.CKPT_FAULT_ENV, "") == "corrupt_latest"
    first_err: Optional[BaseException] = None
    for step in steps:
        try:
            if inject and step == latest:
                raise ValueError(
                    "injected corrupt checkpoint (TRAININGJOB_CKPT_FAULT="
                    f"corrupt_latest, step {step})")
            restored = _read_step(path, step, template, blocks)
        # A corrupt rung can fail anywhere in the read; classify it and try
        # the next retained step.
        except Exception as exc:
            if first_err is None:
                first_err = exc
            reason = ("corrupt_latest" if step == latest
                      else "corrupt_retained")
            _note_fallback_metric("trainingjob_ckpt_restore_fallbacks_total",
                                  reason, reasons)
            print(f"resume: restore of step {step} failed reason={reason} "
                  f"({type(exc).__name__}: {str(exc)[:200]}); trying "
                  f"previous committed step", flush=True)
            continue
        if step != latest:
            print(f"resume: restored previous committed step {step} "
                  f"(latest {latest} unreadable)", flush=True)
        return restored
    raise first_err


def _restore_jax(path: str, newest: int, init_value: Dict[str, Any],
                 blocks: Dict[str, Any],
                 convert: Optional[Callable[[Any], Dict[str, Any]]],
                 reasons: List[str]) -> Dict[str, Any]:
    """The state the JAX package's worker committed at ``path`` (its newest
    orbax step ``newest``), from its resume image: ``convert`` maps the
    JAX trainer's tree to the port's, the step is the image's, and each
    leaf of ``init_value`` but its ``ckpt_placeholder()`` items is
    restored onto the template (this process's block where ``blocks``
    gives one).  An image older than ``newest`` (a preemption between the
    orbax commit and the image's write) restores its own step, counted as
    ``jax_stale`` in ``trainingjob_resume_image_fallbacks_total``.  An
    image that cannot be read (its reason counted there too) raises
    ``jax_state.UnreadableJaxState``: orbax is the one other copy."""
    if convert is None:
        raise jax_state.refusal(path, newest, "this entry point converts "
                                "no state of the JAX package's")
    try:
        step, tree, times = jax_state.read_image(path)
    except jax_state.ImageError as exc:
        _note_fallback_metric("trainingjob_resume_image_fallbacks_total",
                              exc.reason, reasons)
        raise jax_state.refusal(path, newest, f"{jax_state.IMAGE}: {exc}"
                                ) from exc
    if step < newest:
        _note_fallback_metric("trainingjob_resume_image_fallbacks_total",
                              "jax_stale", reasons)
        print(f"resume: the JAX package's resume image holds step {step}, "
              f"its newest orbax step is {newest}; restoring step {step}",
              flush=True)
    t0 = time.perf_counter()
    template = {k: v for k, v in init_value.items() if v is not _PLACEHOLDER}
    converted = {k: v for k, v in dict(convert(tree), step=step).items()
                 if k in template}
    restored = _assemble(template, blocks, [(converted, None)])
    for k in init_value:
        if k not in template:
            restored[k] = _PLACEHOLDER
    print(f"resume: jax image bytes={times['bytes']:.0f} "
          f"read_s={times['read_s']:.3f} "
          f"unpickle_s={times['unpickle_s']:.3f} "
          f"convert_s={time.perf_counter() - t0:.3f}", flush=True)
    print(f"resume: step {step} restored from the JAX package's resume "
          f"image", flush=True)
    return restored


class GracefulShutdown:
    """Preemption-aware step loop: SIGTERM sets a flag, and the loop saves
    at the *current* step and exits 143, so recovery replays no step.  143
    is in the operator's default restarting exit codes, so a preempted
    worker is restarted, not failed.

    The handler only sets the flag (a save from signal context would race
    the background writer); the loop polls it between steps.  A watchdog
    exits 143 anyway when the loop does not surface in ``stuck_grace``
    seconds, or its save does not finish in 3 x that.
    """

    EXIT_CODE = 143

    def __init__(self, stuck_grace: float = 3.0) -> None:
        self.requested = False
        self._surfaced = False
        self._save_done = False
        self._prev: Any = None
        self._stuck_grace = stuck_grace

    def install(self) -> "GracefulShutdown":
        def _watchdog():
            time.sleep(self._stuck_grace)
            if self._surfaced:
                time.sleep(3 * self._stuck_grace)
                if self._save_done:
                    return
                print("shutdown watchdog: preemption checkpoint stuck; "
                      f"force-exiting {self.EXIT_CODE}", flush=True)
            else:
                print("shutdown watchdog: step loop stuck past "
                      f"{self._stuck_grace}s; force-exiting {self.EXIT_CODE}",
                      flush=True)
            os._exit(self.EXIT_CODE)

        def _handler(signum, frame):
            self.requested = True
            threading.Thread(target=_watchdog, daemon=True).start()

        self._prev = signal.signal(signal.SIGTERM, _handler)
        return self

    def uninstall(self) -> None:
        """Put back the SIGTERM handler ``install`` replaced."""
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None

    def checkpoint_and_exit(self, save: Callable[[], None]) -> None:
        """Call from the step loop once ``requested`` is seen."""
        self._surfaced = True
        save()
        self._save_done = True
        print("preemption checkpoint committed; exiting 143", flush=True)
        # os._exit, not SystemExit: teardown would join the daemon threads
        # (prefetcher, writer) for nothing.
        os._exit(self.EXIT_CODE)


def _hbm_bytes_in_use(device: torch.device) -> Optional[float]:
    """Device memory PyTorch holds in tensors on ``device``; None off the
    card."""
    if device.type != "cuda":
        return None
    return float(torch.cuda.memory_allocated(device))


class StepProfiler:
    """Env-gated profiling and per-step telemetry of the step loop.

    ``TRAININGJOB_PROFILE_DIR=/path`` with ``TRAININGJOB_PROFILE_STEPS=a:b``
    (default 2:5) wraps steps [a, b) in ``torch.profiler`` and writes a
    Chrome trace there; ``TRAININGJOB_STEP_TIMES=1`` logs each step's wall
    time.  With ``TRAININGJOB_TELEMETRY_ADDR`` (and the job identity) set,
    every step is pushed to the controller's aggregator: index, wall ms,
    tokens, FLOPs, loss, the checkpoint stall of the save before it, and
    every ``TRAININGJOB_HBM_SAMPLE_STEPS`` steps (default 32) the device
    memory in use as ``hbm_bytes``.  The fence of a timed step is a read
    of its loss.
    """

    def __init__(self, units_per_step: float = 0.0,
                 flops_per_step: float = 0.0, device="cuda") -> None:
        from trainingjob_operator_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.trace_dir = os.environ.get(constants.PROFILE_DIR_ENV, "")
        rng = os.environ.get(constants.PROFILE_STEPS_ENV, "2:5")
        try:
            a, b = rng.split(":")
            self.start_step, self.stop_step = int(a), int(b)
        except ValueError:
            self.start_step, self.stop_step = 2, 5
        self.step_times = os.environ.get(constants.STEP_TIMES_ENV) == "1"
        self.emitter = TelemetryEmitter(units_per_step=units_per_step,
                                        flops_per_step=flops_per_step)
        if self.step_times or self.emitter.enabled:
            _ensure_workload_logging()
        self._log = get_logger("trainingjob.workload.steps")
        self._prof: Any = None
        self._t0 = 0.0
        #: Every step-visible checkpoint stall of this run, ms.
        self.ckpt_stalls: List[float] = []
        self._ckpt_stall_ms: Optional[float] = None
        try:
            self.hbm_sample_steps = int(os.environ.get(
                constants.HBM_SAMPLE_STEPS_ENV, "32") or "0")
        except ValueError:
            self.hbm_sample_steps = 32

    def step_start(self, i: int) -> None:
        if self.trace_dir and self._prof is None and i == self.start_step:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
        self._t0 = time.perf_counter()

    def step_end(self, i: int, sync: Any = None) -> None:
        """``sync``: the step's loss; reading it is the completion fence
        of a timed step (and the loss of its telemetry record)."""
        stopping = self._prof is not None and i + 1 >= self.stop_step
        loss = None
        if sync is not None and (self.step_times or stopping
                                 or self.emitter.enabled):
            loss = float(sync)
        if stopping:
            self._stop_trace()
        ms = (time.perf_counter() - self._t0) * 1e3
        if self.step_times:
            self._log.info("step_time step=%d ms=%.2f", i, ms)
        if self.emitter.enabled:
            hbm = None
            if self.hbm_sample_steps > 0 and i % self.hbm_sample_steps == 0:
                hbm = _hbm_bytes_in_use(self.device)
            self.emitter.emit(i, ms, loss=loss, ckpt_ms=self._ckpt_stall_ms,
                              hbm_bytes=hbm)
            self._ckpt_stall_ms = None

    def _stop_trace(self) -> None:
        self._prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(
            self.trace_dir,
            f"profile-{os.getpid()}-steps{self.start_step}-"
            f"{self.stop_step}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        print(f"profiler trace written to {path} "
              f"(steps {self.start_step}:{self.stop_step})", flush=True)

    def record_checkpoint_stall(self, ms: float) -> None:
        """A save's step-visible stall: kept for the end-of-run summary
        and sent on the next step's record (the loop saves after
        ``step_end``)."""
        self.ckpt_stalls.append(ms)
        self._ckpt_stall_ms = ms

    def log_throughput(self, prefix: str, steps_done: int,
                       units_per_step: float, seconds: float) -> None:
        _ensure_workload_logging()
        self._log.info("%s", throughput_line(prefix, steps_done,
                                             units_per_step, seconds))

    def close(self) -> None:
        if self._prof is not None:
            self._stop_trace()
        self.emitter.close()


#: Substrings identifying transport/collective failures caused by a LOST
#: PEER (Gloo/gRPC/coordination-service surfaces); a deterministic local bug
#: (shape error, checkpoint mismatch) matches none of these and must crash
#: normally so exit-code policy can mark the job Failed instead of
#: restart-looping it forever.
_PEER_LOSS_MARKERS = (
    "gloo", "grpc", "connection reset", "connection refused", "broken pipe",
    "socket closed", "unavailable", "deadline exceeded", "peer",
    "coordination service", "barrier", "heartbeat", "disconnect",
)


#: torch.distributed's transport error types (by class name, so that no
#: import of torch.distributed is needed): a collective or store operation
#: that lost its peer raises one of them whatever its message says.
_PEER_LOSS_TYPES = ("DistNetworkError", "DistBackendError")


def looks_like_peer_loss(exc: BaseException) -> bool:
    """Match the exception and its EXPLICIT cause chain: a wrapper (a
    failed save, a background write) raises from the underlying gloo or
    NCCL error (``raise X from err``) and the marker often lives only on
    the cause.  Besides JAX's markers, a node whose type is one of
    torch.distributed's transport errors (``_PEER_LOSS_TYPES``) matches.

    Implicit context (``__context__``) is followed only from a node that is
    itself transport-shaped (OSError/ConnectionError/TimeoutError): library
    code that re-raises inside an ``except`` block around a socket error
    chains implicitly (no ``from``), and skipping that hop would classify a
    genuine peer preemption as a local crash.  From any OTHER exception
    type the implicit context is deliberately NOT followed -- a
    deterministic local bug raised while HANDLING a transport error would
    inherit the transport marker and restart-loop forever instead of
    reaching the exit-code policy as a failure."""
    io_shaped = (OSError, ConnectionError, TimeoutError)
    seen = set()
    node: Optional[BaseException] = exc
    while node is not None and id(node) not in seen:
        seen.add(id(node))
        text = f"{type(node).__name__}: {node}".lower()
        if any(marker in text for marker in _PEER_LOSS_MARKERS):
            return True
        if any(cls.__name__ in _PEER_LOSS_TYPES
               for cls in type(node).__mro__):
            return True
        nxt = node.__cause__
        if (nxt is None and isinstance(node, io_shaped)
                and not node.__suppress_context__):
            # `raise X from None` sets __suppress_context__: the raiser
            # explicitly disclaimed the context -- honor that, or a
            # deterministic local bug would restart-loop as 143 again.
            nxt = node.__context__
        node = nxt
    return False


class peer_loss_guard:
    """Context manager around the step loop: a PEER-LOSS-shaped exception
    in a multi-process job (``dist.is_initialized()`` and a world of more
    than one) exits 143 via ``os._exit`` (restart-worthy, and no
    interpreter teardown to hang on a dead peer's threads), as does any
    exception once SIGTERM was seen.  Covers the collectives outside the
    step too: a sharded save's barriers die just as loudly when a peer is
    lost mid-save.  Exceptions that do not look like transport failures
    propagate (a deterministic bug must reach the exit-code policy as a
    failure, not crash-loop as 143)."""

    def __init__(self, shutdown: Any = None) -> None:
        self._shutdown = shutdown

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is None or exc_type in (KeyboardInterrupt, SystemExit):
            return False
        import torch.distributed as dist

        sigterm_seen = (self._shutdown is not None
                        and self._shutdown.requested)
        multi = (dist.is_available() and dist.is_initialized()
                 and dist.get_world_size() > 1)
        if sigterm_seen or (multi and looks_like_peer_loss(exc)):
            print(f"distributed section failed ({exc_type.__name__}: "
                  f"{str(exc)[:300]}); exiting 143 for operator restart",
                  flush=True)
            os._exit(GracefulShutdown.EXIT_CODE)
        return False


def run_elastic_loop(*, step_fn: Callable[[torch.Tensor], torch.Tensor],
                     batch_at: Callable[[int], torch.Tensor],
                     state: CheckpointState, params: Dict[str, Any],
                     opt_state: Dict[str, Any], steps: int, start_step: int,
                     ckpt_every: int, eval_fn: Optional[Callable] = None,
                     eval_every: int = 0, units_per_step: float = 0.0,
                     flops_per_step: float = 0.0, device="cuda",
                     resize_watch: Optional[Any] = None,
                     tracer: Optional[Any] = None, trace_parent: str = ""):
    """The step loop of the JAX ``run_elastic_loop`` at a fixed width.
    Every process of a job runs it alike and prints and emits its own
    lines and records, as the JAX processes do.

    ``step_fn(tokens)`` runs one step, updating ``params`` and
    ``opt_state`` in place, and returns the loss; ``batch_at(i)`` is step
    i's host batch, prefetched one step ahead onto ``device`` (the card
    unless the caller asks for the CPU).  Steps run
    from ``start_step`` to ``steps``.  Every ``ckpt_every`` steps and at
    the last the loop prints ``step i/N loss x`` and saves
    ``{"params", "opt_state", "step"}``; the first step prints
    ``recovery_timing first_step_s=`` (and, after a resume, its loss);
    SIGTERM saves at the current step and exits 143
    (``GracefulShutdown``); the end prints the ``ckpt_stall`` summary,
    waits for the last save and logs ``train_done``.  Spans ``train.run``,
    ``train.compile`` (the first step), ``train.step`` and
    ``train.checkpoint``.  The whole loop, saves included, runs under
    ``peer_loss_guard``: across processes a lost peer exits 143.

    ``resize_watch`` (a ``rendezvous.GenerationWatcher``) arms the resize
    in place: when the controller publishes a newer generation, the loop
    drains the step just run (a read of its loss) and leaves at that step
    boundary with ``resize_watch.pending`` set to the doc and
    ``resize_watch.resume_step`` to the next step, without waiting for a
    background save (the caller keeps the live state; its fallback rung
    finalizes).  With ``TRAININGJOB_RESIZE_FASTPATH=0`` it saves the step
    and exits 143 instead.

    Returns ``(loss, t_start)``, ``t_start`` the wall time after the first
    step (its time is set-up: the kernels build there)."""
    from trainingjob_operator_tpu_torch import resolve_device
    from trainingjob_operator_tpu_torch.data.loader import Prefetcher

    device = resolve_device(device)
    shutdown = GracefulShutdown().install()
    profiler = StepProfiler(units_per_step=units_per_step,
                            flops_per_step=flops_per_step, device=device)
    if tracer is None:
        tracer, trace_parent = tracer_from_env()
    loss = None
    t_start = None
    t_loop = time.time()
    try:
        with tracer.span("train.run", parent=trace_parent,
                         start_step=start_step, steps=steps), \
                peer_loss_guard(shutdown=shutdown), \
                Prefetcher(batch_at, start_step, steps,
                           device=device) as batches:
            for i, batch in batches:
                profiler.step_start(i)
                with tracer.span("train.compile" if i == start_step
                                 else "train.step", step=i):
                    loss = step_fn(batch)
                    if i == start_step:
                        float(loss)  # the first step's fence
                if i == start_step:
                    t_start = time.time()
                    print(f"recovery_timing first_step_s="
                          f"{t_start - t_loop:.2f}", flush=True)
                    if start_step > 0:
                        print(f"step {i+1}/{steps} loss {float(loss):.4f} "
                              f"(first after resume)", flush=True)
                profiler.step_end(i, sync=loss)

                def save(step, wait=False):
                    with tracer.span("train.checkpoint", step=step,
                                     wait=wait) as ckpt_span:
                        stall_ms = state.save(
                            {"params": params, "opt_state": opt_state,
                             "step": step}, wait=wait, tracer=tracer,
                            trace_parent=ckpt_span)
                    profiler.record_checkpoint_stall(stall_ms)

                if shutdown.requested:
                    shutdown.checkpoint_and_exit(
                        lambda: save(i + 1, wait=True))
                doc = (resize_watch.poll() if resize_watch is not None
                       else None)
                if doc is not None:
                    # Drain the step just dispatched, so that its device
                    # time is not billed to the resize.
                    float(loss)
                    if (os.environ.get(constants.RESIZE_FASTPATH_ENV, "")
                            == "0"):
                        print(f"resize: generation {doc['generation']} "
                              f"observed at step {i+1}; fast path "
                              f"disabled, checkpointing for operator "
                              f"restart", flush=True)
                        shutdown.checkpoint_and_exit(
                            lambda: save(i + 1, wait=True))
                    resize_watch.pending = doc
                    resize_watch.resume_step = i + 1
                    print(f"resize: generation {doc['generation']} "
                          f"(world {doc['world']}) observed at step "
                          f"{i+1}; leaving step loop for in-place reshard",
                          flush=True)
                    break
                if (i + 1) % ckpt_every == 0 or i == steps - 1:
                    print(f"step {i+1}/{steps} loss {float(loss):.4f}",
                          flush=True)
                    save(i + 1)
                if (eval_fn is not None and eval_every > 0
                        and (i + 1) % eval_every == 0):
                    print(f"eval step {i+1} loss {eval_fn():.4f}",
                          flush=True)
            if profiler.ckpt_stalls:
                stalls = profiler.ckpt_stalls
                mode = "snapshot" if state.snapshot_mode() else "sync"
                print(f"ckpt_stall mode={mode} n={len(stalls)} "
                      f"avg_ms={sum(stalls) / len(stalls):.1f} "
                      f"max_ms={max(stalls):.1f}", flush=True)
            profiler.close()
            if resize_watch is None or resize_watch.pending is None:
                state.finalize()
    finally:
        shutdown.uninstall()
    if units_per_step and t_start is not None:
        profiler.log_throughput(
            "train_done", max(steps - start_step - 1, 1), units_per_step,
            max(time.time() - t_start, 1e-9))
    _maybe_export_trace(tracer)
    return loss, t_start


#: Crash injection of the port's trainers (the JAX package has none, so
#: it is not among ``constants``' shared names): a trainer SIGKILLs itself
#: once the save of this step has committed (a node lost right after a
#: checkpoint).
KILL_AT_STEP_ENV = "TRAININGJOB_KILL_AT_STEP"


def kill_at_step(state: "CheckpointState", step: int) -> None:
    """Crash injection for the kill-and-resume contract: where
    ``TRAININGJOB_KILL_AT_STEP`` names ``step``, wait for the save of
    ``step`` to commit, then SIGKILL this process (exit -9: no handler, no
    cleanup, as a lost node).  A restart resumes from that step."""
    if os.environ.get(KILL_AT_STEP_ENV, "") != str(step):
        return
    state.finalize()
    print(f"killed at step {step}", flush=True)
    os.kill(os.getpid(), signal.SIGKILL)


def warm_up(device) -> Callable[[], None]:
    """``overlapped_restore``'s ``warm_fn`` for a step on ``device``: the
    counterpart of JAX's warm compile, holding what the first step would
    otherwise pay once per process (``workloads/first_step_probe.py``
    splits it on the card):

    - the import of ``torch.fx.experimental.symbolic_shapes`` (and sympy,
      about 480 modules), which the first backward triggers;
    - on the card, the kernel library (``ops/_build.py`` ``library``:
      loaded from the job's cache, or built by ``nvcc`` in subprocesses,
      which leaves the interpreter to the restore);
    - on the card, a cuBLAS handle: PyTorch returns a thread's handles to
      a pool when the thread ends, and the step's first product takes
      one from there instead of making its own.

    Nothing in it touches the step's tensors or numerics."""
    dev = torch.device(device)

    def run() -> None:
        if dev.type == "cuda":
            from trainingjob_operator_tpu_torch.ops import _build

            _build.library()
        import torch.fx.experimental.symbolic_shapes  # noqa: F401

        if dev.type == "cuda":
            a = torch.zeros(64, 64, device=dev, dtype=torch.bfloat16)
            torch.mm(a, a)
            torch.cuda.synchronize(dev)

    return run


def overlapped_restore(restore_fn: Callable[[], Any],
                       warm_fn: Optional[Callable[[], Any]] = None,
                       tracer: Any = None, trace_parent: Any = None,
                       overlap: Optional[bool] = None):
    """Run the checkpoint restore and the warm-up of the step's kernels as
    overlapped phases, so that a resume costs about max(restore, warm-up)
    instead of their sum: the JAX ``overlapped_restore``, with the warm
    compile replaced by ``warm_fn`` (``warm_up``: the kernel library
    loaded from the job's cache, or built by ``nvcc`` in subprocesses).

    ``restore_fn()`` -> the restored state, on the calling thread (span
    ``resume.restore``).  ``warm_fn()`` on a helper thread (span
    ``resume.compile``, JAX's name, for its readers).  ``overlap=False``
    (or ``TRAININGJOB_RESUME_OVERLAP=0``) runs the same two phases one
    after the other, still timed.

    A failed warm-up never fails the resume: the error is printed and the
    first kernel launch builds again (and raises if that fails too).

    Returns ``(restored, warmed, timings)``: ``warmed`` is what
    ``warm_fn`` returned (None after a failure); timings ``restore_s``,
    ``compile_s`` (the warm-up's wall time), ``wall_s`` and ``overlap``
    (whether the phases ran concurrently)."""
    if overlap is None:
        overlap = resume_fastpath_enabled()
    result: Dict[str, Any] = {}

    def run_warm() -> None:
        t0 = time.perf_counter()
        try:
            with _span(tracer, "resume.compile", parent=trace_parent):
                result["warmed"] = warm_fn()
        # The warm-up is an optimization: whatever it raises (a failed
        # build, a missing toolkit), the first kernel launch tries again.
        except Exception as exc:
            result["error"] = exc
        result["compile_s"] = time.perf_counter() - t0

    t_wall = time.perf_counter()
    thread: Optional[threading.Thread] = None
    if overlap and warm_fn is not None:
        thread = threading.Thread(target=run_warm, daemon=True,
                                  name="resume-compile")
        thread.start()
    t0 = time.perf_counter()
    try:
        with _span(tracer, "resume.restore", parent=trace_parent):
            restored = restore_fn()
        restore_s = time.perf_counter() - t0
    finally:
        if thread is not None:
            thread.join()
    if thread is None and warm_fn is not None:
        run_warm()
    if "error" in result:
        err = result["error"]
        print(f"resume: warm-up failed ({type(err).__name__}: "
              f"{str(err)[:200]}); the first kernel launch will build",
              flush=True)
    timings = {"restore_s": restore_s,
               "compile_s": result.get("compile_s", 0.0),
               "wall_s": time.perf_counter() - t_wall,
               "overlap": thread is not None}
    return restored, result.get("warmed"), timings


def push_resume_record(restore_s: float, fallback: str = "",
                       compile_s: float = 0.0, overlap: bool = False
                       ) -> None:
    """Send one restore's record to the controller's telemetry sink (a
    short-lived emitter; nothing without the telemetry env), as the JAX
    ``_push_resume_record``: the restore's and the warm-up's wall times
    (``overlapped_restore``'s ``restore_s`` and ``compile_s``), whether
    they overlapped, and the fallback the restore took."""
    emitter = TelemetryEmitter()
    if not emitter.enabled:
        return
    try:
        emitter.emit_resume(restore_s * 1e3, compile_s * 1e3, bool(overlap),
                            fallback=fallback)
    finally:
        emitter.close()


def push_rendezvous_record(total_ms: float, rung: str, reason: str = "",
                           phase_ms: Optional[Dict[str, float]] = None
                           ) -> None:
    """Send one resize rebootstrap's outcome (the rung taken, its wall
    time and each phase's) to the controller's telemetry sink, with a
    short-lived emitter as ``push_resume_record``; sent on success (rung
    ``live``) and again on a degrade, so the latest record names the rung
    that ran."""
    emitter = TelemetryEmitter()
    if not emitter.enabled:
        return
    try:
        emitter.emit_rendezvous(total_ms, rung, reason=reason,
                                phase_ms=phase_ms)
    finally:
        emitter.close()


def _maybe_export_trace(tracer) -> None:
    """Write the workload trace (Chrome trace_event JSON) to
    ``$TRAININGJOB_TRACE_DIR/trace-<pid>.json`` when that is set.
    Best-effort: an unwritable directory never fails a finished run."""
    trace_dir = os.environ.get(constants.TRACE_DIR_ENV, "")
    if not trace_dir or not tracer.enabled:
        return
    try:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"trace-{os.getpid()}.json")
        with open(path, "w") as f:
            f.write(tracer.export_chrome())
        print(f"workload trace written to {path}", flush=True)
    except OSError as exc:
        print(f"trace export failed: {exc}", flush=True)


def round_global_batch(global_batch: int, shards: int,
                       accum: int = 1) -> "tuple[int, int]":
    """(batch, accum): largest multiple of ``shards * accum`` <= the request.

    Accumulation is the shedable factor: it is clamped down first so the
    global batch never exceeds the request.  When even one row per data
    shard does not fit (batch < shards) the batch is inflated to exactly
    one row per shard, loudly.  The same rule as the JAX package's."""
    shards = max(shards, 1)
    accum = max(accum, 1)
    if global_batch < shards:
        print(f"WARNING: global batch {global_batch} < {shards} data "
              f"shards; inflating to {shards} (one row per shard) -- the "
              f"loss trajectory changes at this width. Keep elastic max "
              f"width <= global batch to avoid this.", flush=True)
        return shards, 1
    # The accum <= requested that yields the largest rounded batch (on ties,
    # the largest accum).
    requested = accum
    best = None
    for a in range(min(accum, global_batch // shards), 0, -1):
        step = shards * a
        rounded = global_batch // step * step
        if best is None or rounded > best[0]:
            best = (rounded, a)
    rounded, accum = best
    if accum != requested:
        print(f"using gradient accumulation {accum} (requested {requested}) "
              f"for {shards} data shards at global batch {rounded}",
              flush=True)
    if rounded != global_batch:
        print(f"rounded global batch {global_batch} -> {rounded} to tile "
              f"{shards} data shards x {accum} accumulation", flush=True)
    return rounded, accum


def _synthetic_seed(key_base: int, step: int, row: int) -> int:
    """A 63-bit seed from (key_base, step, row): splitmix64 finalizer over
    their golden-ratio-weighted sum."""
    mask = (1 << 64) - 1
    x = (key_base * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9
         + row * 0x94D049BB133111EB) & mask
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & mask
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & mask
    x ^= x >> 31
    return x >> 1


def build_batch_sources(*, prefix: str, vocab_size: int, global_batch: int,
                        seq: int, synthetic_key: int, device,
                        local_batch: Optional[int] = None, row0: int = 0):
    """(batch_at, eval_batch_at | None, eval_every, eval_batches) from env,
    as the JAX function reads it: ``{P}_DATA`` (.tokens corpus; default
    synthetic), ``{P}_SEED``, ``{P}_EVAL_EVERY`` / ``{P}_EVAL_BATCHES`` /
    ``{P}_EVAL_FRACTION``, with the same startup errors.  ``batch_at(i)``
    is this process's rows ``[row0, row0 + local_batch)`` (default: the
    whole global batch) of step i's [global_batch, seq + 1] int64 batch,
    on ``device``.

    Both sources are stateless functions of (source, step) with no input
    from the process layout, so every width sees the same global batches.
    A corpus batch is the JAX package's, byte for byte.  Synthetic tokens
    come from a ``torch.Generator`` per row, seeded from (key, step, row),
    so a row is a pure function of its global index; they are not JAX's
    threefry stream, so the two packages train on different synthetic
    tokens."""
    if local_batch is None:
        local_batch = global_batch
    rows = range(row0, row0 + local_batch)
    data_path = os.environ.get(f"{prefix}_DATA", "")
    seed = int(os.environ.get(f"{prefix}_SEED", str(synthetic_key)))
    eval_every = int(os.environ.get(f"{prefix}_EVAL_EVERY", "0"))
    eval_batches = int(os.environ.get(f"{prefix}_EVAL_BATCHES", "2"))
    eval_frac = float(os.environ.get(f"{prefix}_EVAL_FRACTION", "0.1"))
    if eval_every > 0:
        if eval_batches < 1:
            raise ValueError(
                f"{prefix}_EVAL_BATCHES={eval_batches} with eval enabled: "
                f"a zero-batch eval would print a bogus 0.0 loss")
        if not 0.0 < eval_frac < 1.0:
            raise ValueError(
                f"{prefix}_EVAL_FRACTION={eval_frac} must be in (0, 1)")
        if not data_path:
            raise ValueError(
                f"{prefix}_EVAL_EVERY={eval_every} without {prefix}_DATA: "
                f"eval on the synthetic random-token stream measures "
                f"nothing; point {prefix}_DATA at a .tokens corpus or "
                f"disable eval")
    train_region = (0.0, 1.0 - eval_frac) if eval_every > 0 else (0.0, 1.0)

    ds = eval_ds = None
    if data_path:
        from trainingjob_operator_tpu_torch.data import TokenDataset

        ds = TokenDataset(data_path, seed=seed, region=train_region)
        if ds.vocab_size > vocab_size:
            # An out-of-range id would fail the embedding lookup mid-run.
            raise ValueError(
                f"{data_path}: corpus vocab {ds.vocab_size} exceeds model "
                f"vocab {vocab_size}")
        ds.check_window(seq + 1)
        if eval_every > 0:
            eval_ds = TokenDataset(data_path, seed=seed,
                                   region=(1.0 - eval_frac, 1.0))
            eval_ds.check_window(seq + 1)

    def make_batch_at(dataset, key_base):
        if dataset is not None:
            def fetch(i):
                batch = torch.from_numpy(dataset.batch(
                    i, global_batch, seq, rows=slice(rows.start, rows.stop)))
                return batch.long().to(device, non_blocking=True)
        else:
            def fetch(i):
                gen = torch.Generator()
                batch = []
                for r in rows:
                    gen.manual_seed(_synthetic_seed(key_base, i, r))
                    batch.append(torch.randint(0, vocab_size, (seq + 1,),
                                               generator=gen))
                return torch.stack(batch).to(device, non_blocking=True)
        return fetch

    batch_at = make_batch_at(ds, synthetic_key)
    eval_batch_at = (make_batch_at(eval_ds, synthetic_key ^ 0x5EED)
                     if eval_every > 0 else None)
    return batch_at, eval_batch_at, eval_every, eval_batches


def default_remat(n_layers: int) -> str:
    """The JAX package's workload default: "attn" for full-depth configs,
    "none" below 32 layers."""
    return "attn" if n_layers >= 32 else "none"


def mean_eval_fn(eval_loss, eval_batch_at, eval_batches: int):
    """Average ``eval_loss(tokens)`` over the fixed held-out batches
    j = 0..N-1, under ``torch.no_grad``."""
    def eval_fn():
        total = 0.0
        with torch.no_grad():
            for j in range(eval_batches):
                total += float(eval_loss(eval_batch_at(j)))
        return total / eval_batches
    return eval_fn


def throughput_line(prefix: str, steps_done: int, units_per_step: int,
                    seconds: float, unit: str = "tokens") -> str:
    rate = steps_done * units_per_step / max(seconds, 1e-9)
    return f"{prefix} steps={steps_done} {unit}/s={rate:.0f}"
