"""The worker's identity and its job's rendezvous from the operator's env,
and their re-forming in place: own copy of the JAX package's
``workloads/rendezvous.py``.

- ``Rendezvous`` / ``from_env``: the fields training reads (the checkpoint
  path, the startup line, the process group, the mesh, the resize
  channel and the reservation flag), and ``initialize_distributed``, the
  counterpart of ``initialize_jax_distributed``'s process-group half.
- The worker's pod contract, which every port main runs first
  (``prepare_worker``, the rest of ``initialize_jax_distributed``):
  ``Rendezvous.hold_reservation_if_needed`` verbatim, the platform
  override (``platform_device``: ``TRAININGJOB_JAX_PLATFORM`` picks the
  device where ``--device`` is not given) and the kernel cache
  (``compile_cache_dir`` / ``enable_compile_cache``, which point
  ``ops/_build.py`` at the job's directory).
- The resize channel: ``read_generation`` and ``GenerationWatcher`` (the
  step loop's poll of the controller's ``generation.json``), verbatim.
- The rebootstrap ladder: ``RebootstrapError``, ``resize_faults`` /
  ``check_fault``, ``barrier_timeout_s`` / ``_await_coordinator``
  verbatim, and ``rebootstrap_distributed``, the counterpart of
  ``rebootstrap_jax_distributed`` on ``torch.distributed``:
  ``destroy_process_group``, then ``init_process_group`` at the published
  coordinator, rank and world.  JAX's backend clear (which
  ``destroy_process_group`` covers) and its partitioner (GSPMD) have no
  torch counterpart.

One process drives one card: ``num_processes`` is the world size of the
process group and ``process_id`` its rank.  Every generation forms its
group on the coordinator's one ``TCPStore`` under its own prefix
(``_group_store``): the controller publishes the same coordinator address
each generation, and a surviving rank 0 keeps serving the store on it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import sys
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from trainingjob_operator_tpu_torch import constants

#: Rebootstrap ladder phases, in execution order (docs/ELASTIC.md "Live
#: re-rendezvous").  ``shutdown``/``barrier``/``reinit`` live here;
#: ``reshard`` and ``persist`` are guarded by the workload's ladder
#: (llama_elastic) but share the same fault-injection knob.
REBOOTSTRAP_PHASES = ("shutdown", "barrier", "reinit", "reshard", "persist")

#: Fallback ladder rungs, best first.  ``live``: the survivors re-formed
#: the distributed world in place.  ``checkpoint``: a phase failed, the
#: survivors committed a checkpoint at the interrupted step and exited 143
#: for the operator to restart at the published width.  ``restart_all``:
#: even the checkpoint failed -- exit anyway and let recovery replay from
#: the last committed step.
RUNG_LIVE = "live"
RUNG_CHECKPOINT = "checkpoint"
RUNG_RESTART_ALL = "restart_all"
REBOOTSTRAP_RUNGS = (RUNG_LIVE, RUNG_CHECKPOINT, RUNG_RESTART_ALL)


#: Seconds a collective or the rendezvous of the process group waits for
#: its peers (``init_process_group(timeout=)``, the store's timeout).  Gloo
#: raises at once when a peer's socket closes; NCCL's watchdog aborts the
#: process (SIGABRT) once a collective has waited this long for a dead
#: peer, which no guard in the process sees.
GROUP_TIMEOUT_S = 300.0


@dataclass
class Rendezvous:
    """Where a worker stands in its job."""

    replica_name: str = ""
    replica_index: int = 0
    restart_count: int = 0
    checkpoint_dir: str = ""
    elastic_replicas: int = 1
    num_processes: int = 1
    process_id: int = 0
    coordinator_address: str = ""
    slice_id: int = 0
    num_slices: int = 1
    is_reservation: bool = False
    #: Seconds a reservation pod holds before it exits 143 (0: no end).
    reservation_ttl: float = 0.0
    resize_dir: str = ""
    rendezvous_generation: int = 0

    def hold_reservation_if_needed(
            self, sleep: Callable[[float], None] = time.sleep) -> None:
        """Re-expand reservation pods (capacity canaries) idle here instead
        of joining a rendezvous they are not part of; the operator restarts
        them with a real rank once the resize commits.  Call first in every
        main, before anything touches the device.

        The hold is bounded: past the injected TTL the canary exits 143
        (pod Failed, and the controller's probe-failed path cancels the
        probe), so a probe orphaned by a dead controller frees its host;
        without a TTL it holds until it is killed."""
        if not self.is_reservation:
            return
        ttl = self.reservation_ttl
        deadline = time.time() + ttl if ttl > 0 else None
        while deadline is None or time.time() < deadline:
            sleep(min(5.0, max(deadline - time.time(), 0.01))
                  if deadline is not None else 3600)
        sys.exit(143)

    @property
    def generation_path(self) -> str:
        """Where the controller republishes the rendezvous generation; ""
        when resize is not wired for this job."""
        return (os.path.join(self.resize_dir, "generation.json")
                if self.resize_dir else "")


def read_generation(path: str) -> Optional[Dict[str, Any]]:
    """Parse a published generation doc; None on absence or garble.

    The writer is atomic (tmp + os.replace) so a partial read means an
    out-of-band scribble, not a torn write -- either way the contract is the
    same: ignore anything that is not a well-formed doc and keep training at
    the current generation."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
        if (isinstance(doc, dict)
                and isinstance(doc.get("generation"), int)
                and isinstance(doc.get("world"), list)
                and doc["generation"] > 0):
            return doc
    except (OSError, ValueError):
        pass
    return None


class GenerationWatcher:
    """Cheap per-step poll of the controller's generation channel.

    Survivors call ``poll()`` at every step boundary; it is rate-limited to
    ``TRAININGJOB_RESIZE_POLL_S`` (default 0.5 s) and stat-gated (a read only
    happens when the file's mtime moved), so the steady-state cost is one
    ``os.stat`` every poll interval.  A doc is surfaced once, and only when
    its generation is beyond both the process's birth epoch (the injected
    ``TRAININGJOB_RENDEZVOUS_GENERATION``) and the last surfaced doc --
    a freshly (re)started pod never reacts to the generation it was born
    into.
    """

    def __init__(self, rdv: Optional[Rendezvous] = None,
                 path: Optional[str] = None,
                 birth: Optional[int] = None,
                 interval: Optional[float] = None) -> None:
        if rdv is None and (path is None or birth is None):
            rdv = from_env()
        self.path = path if path is not None else rdv.generation_path
        self.seen = birth if birth is not None else rdv.rendezvous_generation
        if interval is None:
            try:
                interval = float(
                    os.environ.get(constants.RESIZE_POLL_ENV, "") or 0.5)
            except ValueError:
                interval = 0.5
        self.interval = max(interval, 0.0)
        self._next_check = 0.0
        self._mtime: Optional[float] = None
        #: Set by train.run_elastic_loop when a poll fires mid-run: the doc
        #: that interrupted the step loop, and the step to resume at after
        #: the in-place reshard.
        self.pending: Optional[Dict[str, Any]] = None
        self.resume_step: int = 0

    def poll(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """The freshest unseen generation doc, or None."""
        if not self.path:
            return None
        now = time.monotonic() if now is None else now
        if now < self._next_check:
            return None
        self._next_check = now + self.interval
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            return None
        if mtime == self._mtime:
            return None
        self._mtime = mtime
        doc = read_generation(self.path)
        if doc is not None and doc["generation"] > self.seen:
            self.seen = doc["generation"]
            return doc
        return None

    def reenter(self, generation: int) -> None:
        """Mark a completed rebootstrap at ``generation``: the watcher keeps
        polling for LATER bumps in the same process lifetime, but docs at or
        below this epoch are now stale -- a slow NFS replay of the doc that
        triggered the rendezvous must not trigger it twice."""
        self.seen = max(self.seen, generation)
        self.pending = None


def from_env(env: Optional[Dict[str, str]] = None) -> Rendezvous:
    e = os.environ if env is None else env
    return Rendezvous(
        replica_name=e.get(constants.REPLICA_NAME_ENV, ""),
        replica_index=int(e.get(constants.REPLICA_INDEX_ENV, "0") or 0),
        restart_count=int(
            e.get(constants.REPLICA_RESTART_COUNT_ENV, "0") or 0),
        checkpoint_dir=e.get(constants.CHECKPOINT_DIR_ENV, ""),
        elastic_replicas=int(e.get(constants.ELASTIC_REPLICAS_ENV, "1")
                             or 1),
        num_processes=int(e.get(constants.NUM_PROCESSES_ENV, "1") or 1),
        process_id=int(e.get(constants.PROCESS_ID_ENV, "0") or 0),
        coordinator_address=e.get(constants.COORDINATOR_ADDRESS_ENV, ""),
        slice_id=int(e.get(constants.SLICE_ID_ENV, "0") or 0),
        num_slices=int(e.get(constants.NUM_SLICES_ENV, "1") or 1),
        is_reservation=e.get(constants.RESERVATION_ENV, "") == "1",
        # Read only for a reservation pod, as JAX reads it in its hold.
        reservation_ttl=(float(e.get(constants.RESERVATION_TTL_ENV, "0")
                               or 0)
                         if e.get(constants.RESERVATION_ENV, "") == "1"
                         else 0.0),
        resize_dir=e.get(constants.RESIZE_DIR_ENV, ""),
        rendezvous_generation=int(
            e.get(constants.RENDEZVOUS_GENERATION_ENV, "0") or 0))


#: The values of ``TRAININGJOB_JAX_PLATFORM`` a port main takes, and the
#: device each asks for.
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}

#: The kernel cache's directory under the checkpoint root where no cache
#: variable names one (JAX's is ``.jax_compile_cache``: the two hold
#: different artefacts).
KERNEL_CACHE_SUBDIR = ".torch_kernel_cache"


def platform_device(default: str = "cuda",
                    env: Optional[Dict[str, str]] = None) -> str:
    """The device a main runs on where its caller passed no ``--device``:
    the platform the operator's ``TRAININGJOB_JAX_PLATFORM`` asks for
    (``cpu``; ``gpu`` or ``cuda`` for the card), else ``default``.  The
    counterpart of JAX's ``apply_platform_override``.  Any other value
    raises ``ValueError``; unset, nothing picks the CPU on its own."""
    e = os.environ if env is None else env
    plat = e.get(constants.JAX_PLATFORM_ENV, "").strip()
    if not plat:
        return default
    if plat.lower() not in PLATFORMS:
        raise ValueError(
            f"{constants.JAX_PLATFORM_ENV}={plat!r}: expected one of "
            f"{', '.join(PLATFORMS)}")
    return PLATFORMS[plat.lower()]


def compile_cache_dir(rdv: Rendezvous) -> str:
    """The job's kernel-cache directory ("" when disabled), resolved as
    JAX resolves its compile cache: ``TRAININGJOB_COMPILE_CACHE_DIR`` (a
    job-survivable location, such as a cluster volume), then
    ``TRAININGJOB_COMPILE_CACHE``, then
    ``<checkpoint_dir>/.torch_kernel_cache`` (it lives as long as the
    checkpoint); ``off`` in either variable disables it."""
    path = (os.environ.get(constants.COMPILE_CACHE_DIR_ENV, "")
            or os.environ.get(constants.COMPILE_CACHE_ENV, ""))
    if not path and rdv.checkpoint_dir:
        path = os.path.join(rdv.checkpoint_dir, KERNEL_CACHE_SUBDIR)
    return "" if (not path or path == "off") else path


def enable_compile_cache(rdv: Rendezvous) -> str:
    """Point the kernel library (``ops/_build.py``) at the job's cache
    directory (``compile_cache_dir``), made here; a disabled cache leaves
    it at the package's ``_build/``.  A restarted worker in a fresh
    container then loads the library its job built before instead of
    running ``nvcc`` inside its first step.  Returns the directory."""
    from trainingjob_operator_tpu_torch.ops import _build

    path = compile_cache_dir(rdv)
    if path:
        os.makedirs(path, exist_ok=True)
    _build.set_cache_dir(path)
    return path


def prepare_worker(device: Optional[str] = None,
                   rdv: Optional[Rendezvous] = None,
                   subdir: Optional[str] = None) -> Tuple[Rendezvous, str]:
    """The preamble every port main runs first, before any CUDA call, as
    JAX's ``initialize_jax_distributed`` begins: a reservation pod holds
    here and exits (``hold_reservation_if_needed``), a checkpoint path
    that holds only the JAX package's orbax steps is refused
    (``train.refuse_unreadable_state``; ``subdir`` as
    ``CheckpointState.restore_or_init`` takes it), the platform override
    picks the device where ``device`` (``--device``) is None
    (``platform_device``), and the kernel cache is enabled
    (``enable_compile_cache``).  Returns the rendezvous and the device's
    name; the process group forms later (``initialize_distributed``),
    once the device is resolved."""
    rdv = from_env() if rdv is None else rdv
    rdv.hold_reservation_if_needed()
    from trainingjob_operator_tpu_torch.workloads import train

    train.refuse_unreadable_state(rdv, subdir)
    device = device or platform_device()
    enable_compile_cache(rdv)
    return rdv, device


#: The coordinator store this process holds: {"address", "master",
#: "store"}.  A master store is kept across generations (its port stays
#: bound by this process); a client store is made anew each time.
_STORE: Dict[str, Any] = {}


def _group_store(address: str, rank: int, generation: int):
    """The store generation ``generation`` forms its group on: a
    ``PrefixStore`` of the coordinator's ``TCPStore``, so that the keys of
    one generation's rendezvous (which restart from the same names once a
    group is destroyed) never meet another's.  Rank 0 serves the store on
    ``address``, keeping the one it already serves there; the other ranks
    connect to it, retrying until the store's timeout."""
    import torch.distributed as dist

    host, _, port_s = address.rpartition(":")
    master = rank == 0
    held = _STORE.get("store")
    if not (held is not None and master and _STORE.get("master")
            and _STORE.get("address") == address):
        # Drop the old store first: a master must release its port
        # before another process can serve the address.
        _STORE.clear()
        held = dist.TCPStore(host or "127.0.0.1", int(port_s),
                             is_master=master,
                             timeout=timedelta(seconds=GROUP_TIMEOUT_S),
                             wait_for_workers=False)
        _STORE.update(address=address, master=master, store=held)
    return dist.PrefixStore(f"generation-{generation}/", held)


def _form_group(address: str, rank: int, world: int, generation: int,
                device: torch.device) -> torch.device:
    """``init_process_group`` of rank ``rank`` in a world of ``world`` on
    the coordinator's store (``_group_store``), with an explicit timeout:
    NCCL on a CUDA device (the card ``rank`` modulo the host's cards, made
    current first), gloo on the CPU.  Returns the device this process
    drives."""
    import torch.distributed as dist

    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, store=_group_store(address, rank, generation), rank=rank,
        world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    return device


def initialize_distributed(rdv: Rendezvous,
                           device: torch.device) -> torch.device:
    """Form the job's process group from the injected env and return the
    device this process drives.

    ``init_process_group`` at the coordinator ``rdv.coordinator_address``
    with rank ``process_id`` and world ``num_processes`` (``_form_group``:
    NCCL on the card, gloo on the CPU), in the generation the process was
    started under.  Unlike JAX, which skips initialization for one
    process, a coordinator address at one process forms a group of one, so
    that a single card runs the multi-process path and its collectives.  A
    multi-process job without a coordinator raises; a group that fails to
    form raises from ``init_process_group``.
    """
    if not rdv.coordinator_address:
        raise ValueError(
            f"{constants.COORDINATOR_ADDRESS_ENV} is not set; a job of "
            f"{rdv.num_processes} processes needs it")
    if not 0 <= rdv.process_id < rdv.num_processes:
        raise ValueError(f"process id {rdv.process_id} outside a world of "
                         f"{rdv.num_processes}")
    return _form_group(rdv.coordinator_address, rdv.process_id,
                       rdv.num_processes, rdv.rendezvous_generation, device)


# -- live re-rendezvous: coordinator rebootstrap -----------------------------

class RebootstrapError(RuntimeError):
    """A guarded rebootstrap phase failed.  Carries the phase name for
    incident attribution and whether the failure was injected
    (``TRAININGJOB_RESIZE_FAULT``) -- the ladder degrades one rung
    either way; tests tell the two apart."""

    def __init__(self, phase: str, message: str,
                 injected: bool = False) -> None:
        super().__init__(message)
        self.phase = phase
        self.injected = injected


def resize_faults(env: Optional[Dict[str, str]] = None
                  ) -> Dict[str, Optional[int]]:
    """Parse ``TRAININGJOB_RESIZE_FAULT`` into {phase: generation-or-None}.

    The knob is a comma-separated list of ladder phase names, each
    optionally pinned to a single generation as ``phase@N`` (unpinned
    phases fire at every generation).  Unknown phase names and garbled
    pins are ignored -- a typo'd injection knob must never change what a
    production resize does."""
    e = os.environ if env is None else env
    spec: Dict[str, Optional[int]] = {}
    for token in (e.get(constants.RESIZE_FAULT_ENV, "") or "").split(","):
        token = token.strip()
        if not token:
            continue
        phase, _, pin = token.partition("@")
        if phase not in REBOOTSTRAP_PHASES:
            continue
        if pin:
            try:
                spec[phase] = int(pin)
            except ValueError:
                continue
        else:
            spec[phase] = None
    return spec


def check_fault(phase: str, generation: int,
                faults: Optional[Dict[str, Optional[int]]] = None) -> None:
    """Raise the injected fault when the knob arms ``phase`` (for this
    generation, or unpinned).  Deterministic: same env + same generation
    always fails at the same point -- the property the rung tests and
    ``chip_smoke.py``'s ladder phase rely on."""
    faults = resize_faults() if faults is None else faults
    if phase in faults and faults[phase] in (None, generation):
        raise RebootstrapError(
            phase, f"injected fault ({constants.RESIZE_FAULT_ENV}) at "
                   f"phase {phase}, generation {generation}", injected=True)


def shutdown_distributed() -> Optional[str]:
    """Tear down this process's process group (the process, its tensors
    and its built kernels stay).  Returns the group's backend, or None
    where no group was formed."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    backend = str(dist.get_backend())
    dist.destroy_process_group()
    return backend


def barrier_timeout_s(env: Optional[Dict[str, str]] = None) -> float:
    """The coordinator-barrier budget (``TRAININGJOB_RESIZE_BARRIER_S``,
    default 30 s; floored at 0.1 s so a typo cannot spin-fail)."""
    e = os.environ if env is None else env
    try:
        return max(float(e.get(constants.RESIZE_BARRIER_ENV, "") or 30.0),
                   0.1)
    except ValueError:
        return 30.0


def _await_coordinator(address: str, timeout: float,
                       sleep: Callable[[float], None] = time.sleep) -> None:
    """Block until ``address`` accepts a TCP connection, with exponential
    backoff inside ``timeout`` seconds.  The bumped-generation coordinator
    (new rank 0) serves its store from ``_form_group``; the other
    survivors probe here first so that their ``init_process_group`` does
    not spend the group's whole timeout against a coordinator that is
    still tearing down."""
    host, _, port_s = address.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        raise RebootstrapError(
            "barrier", f"unparseable coordinator address {address!r}")
    deadline = time.monotonic() + timeout
    delay = 0.05
    while True:
        try:
            probe_budget = max(min(1.0, deadline - time.monotonic()), 0.05)
            socket.create_connection((host or "127.0.0.1", port),
                                     timeout=probe_budget).close()
            return
        except OSError:
            if time.monotonic() + delay >= deadline:
                raise RebootstrapError(
                    "barrier", f"coordinator {address} unreachable after "
                               f"{timeout:.1f}s")
            sleep(delay)
            delay = min(delay * 2.0, 1.0)


def rebootstrap_distributed(
        rdv: Rendezvous, doc: Dict[str, Any],
        old_world: Optional[List[int]] = None,
        sleep: Callable[[float], None] = time.sleep,
) -> Tuple[Rendezvous, Dict[str, float]]:
    """Re-enter the process group at a published generation, live: the
    counterpart of JAX ``rebootstrap_jax_distributed``, with its three
    guarded phases and its timings (ms).

    ``shutdown`` destroys this process's group (``shutdown_distributed``);
    ``barrier`` waits for the published coordinator (ranks other than the
    new rank 0 of a world of more than one, with timeout and backoff);
    ``reinit`` forms the group again (``_form_group``) at the published
    coordinator, this process's new rank and the new world, on the
    backend of the group it destroyed.  A survivor's
    identity is its entry in ``old_world``, its new rank that entry's
    position in the published world; a survivor absent from it raises at
    ``reinit``.  One process passes through as it does in JAX (rank 0 of
    1), except that a group of one it had formed is formed again.  Fault
    injection fires in every case.  Raises ``RebootstrapError`` with the
    failing phase; returns the updated Rendezvous and the timings."""
    generation = int(doc.get("generation", 0))
    world = [int(r) for r in (doc.get("world") or [])]
    faults = resize_faults()
    timings: Dict[str, float] = {}
    multi = rdv.num_processes > 1

    t0 = time.perf_counter()
    check_fault("shutdown", generation, faults)
    backend = shutdown_distributed()
    timings["shutdown_ms"] = (time.perf_counter() - t0) * 1e3

    coordinator = (str(doc.get("coordinator") or "")
                   or rdv.coordinator_address)
    if multi:
        ident = (old_world[rdv.process_id]
                 if old_world and 0 <= rdv.process_id < len(old_world)
                 else rdv.process_id)
        if ident not in world:
            # Not part of the published world: the controller is draining
            # this process.  The checkpoint rung parks its state.
            raise RebootstrapError(
                "reinit", f"replica {ident} absent from published world "
                          f"{world} (generation {generation})")
        new_pid = world.index(ident)
        new_num = int(doc.get("num_processes") or len(world) or 1)
    else:
        # One process: the published world is logical (its width sets the
        # log lines, not the group).
        new_pid, new_num = 0, 1

    t1 = time.perf_counter()
    check_fault("barrier", generation, faults)
    if multi and new_num > 1 and coordinator and new_pid != 0:
        _await_coordinator(coordinator, barrier_timeout_s(), sleep=sleep)
    timings["barrier_ms"] = (time.perf_counter() - t1) * 1e3

    t2 = time.perf_counter()
    check_fault("reinit", generation, faults)
    if backend is not None:
        if not coordinator:
            raise RebootstrapError(
                "reinit", f"generation {generation} doc published no "
                          "coordinator address")
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
        try:
            _form_group(coordinator, new_pid, new_num, generation, device)
        # Whatever init_process_group raises (a store timeout, a backend
        # error) degrades one rung.
        except Exception as exc:
            raise RebootstrapError(
                "reinit", f"init_process_group at generation {generation} "
                          f"failed: {exc}")
    timings["reinit_ms"] = (time.perf_counter() - t2) * 1e3

    new_rdv = dataclasses.replace(
        rdv,
        num_processes=new_num,
        process_id=new_pid,
        coordinator_address=coordinator,
        rendezvous_generation=max(generation, rdv.rendezvous_generation),
        elastic_replicas=len(world) or rdv.elastic_replicas,
    )
    return new_rdv, timings
