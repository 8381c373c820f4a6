"""The JAX package's committed job state, as the port reads it.

A single-process JAX worker (``workloads/train.py`` ``CheckpointState``
in the JAX package) commits each step twice under the job's checkpoint
path: as an orbax step directory ``<path>/<step>/`` (its
``_CHECKPOINT_METADATA`` marks it committed) and, after that commit, as
``<path>/resume-image.bin``: ``pickle((step, tree))`` of numpy leaves with
a sha256 footer.  The port cannot read orbax (no orbax or tensorstore
beside it), so the image is the one route in:

- ``orbax_steps`` finds the JAX package's step directories, which the
  port never takes for its own (``train.committed_steps``), never prunes
  and never commits over.
- ``read_image`` verifies the footer, then unpickles with ``_Unpickler``:
  numpy's array and dtype globals and optax's state classes as the
  stand-ins below, and nothing else, so no ``optax`` is needed.
- ``write_image`` writes a tree in that layout (the JAX package's own
  container), for the checks that hold the reader against it.

A JAX job without an image (several processes, or
``TRAININGJOB_CKPT_SNAPSHOT=0``) is refused with ``UnreadableJaxState``,
before the worker touches its device (``refuse_unreadable``).
"""

from __future__ import annotations

import hashlib
import importlib
import io
import os
import pickle
import time
from collections import namedtuple
from typing import Any, Dict, List, Tuple

import numpy as np

#: The file orbax writes into a step directory once the step is committed.
ORBAX_MARKER = "_CHECKPOINT_METADATA"
#: The resume image's name (the port's and the JAX package's), and its
#: sha256 footer's length: the footer is checked before the unpickle, so
#: a torn or flipped image is "corrupt", not an unpickling error or
#: silently wrong state.
IMAGE = "resume-image.bin"
SHA_LEN = 32

#: Stand-ins for the optax states a JAX trainer's image holds, with
#: optax's field names: ``adam``/``adamw``'s ``ScaleByAdamState`` (Llama,
#: MoE, BERT, MNIST), ``sgd`` with momentum's ``TraceState`` (ResNet), and
#: the ``EmptyState`` of a chain's stateless links.
ScaleByAdamState = namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
TraceState = namedtuple("TraceState", ["trace"])
EmptyState = namedtuple("EmptyState", [])

#: Where optax 0.2 defines them: the globals the image names.
OPTAX_GLOBALS = {
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.base", "EmptyState"): EmptyState,
    ("optax.transforms._accumulation", "TraceState"): TraceState,
}
#: numpy's globals in a pickled array, scalar or dtype, by the module
#: under ``numpy._core`` (numpy 2) or ``numpy.core`` (numpy 1).
_NUMPY_CORE = {("numeric", "_frombuffer"), ("multiarray", "_reconstruct"),
               ("multiarray", "scalar")}
_NUMPY_TOP = {"dtype", "ndarray"}


class ImageError(Exception):
    """The image cannot be read; ``reason`` classifies it: ``missing``,
    ``corrupt`` (read error, truncation, sha256 mismatch, unpickling
    failure) or ``foreign_global`` (a global outside the allow-list)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason, self.detail = reason, detail


class UnreadableJaxState(RuntimeError):
    """The newest committed state of the job is the JAX package's, in a
    form the port cannot read."""


def _numpy_core(tail: str, name: str):
    for root in ("numpy._core", "numpy.core"):
        try:
            return getattr(importlib.import_module(f"{root}.{tail}"), name)
        except (ImportError, AttributeError):
            continue
    raise ImportError(f"numpy has no {tail}.{name}")


class _Unpickler(pickle.Unpickler):
    """Unpickles the JAX package's image without optax.  The allow-list is
    what the JAX trainers' trees pickle to (jax 0.9, optax 0.2.6, numpy
    2.0): numpy's ``_frombuffer``/``_reconstruct``/``scalar``/``dtype``/
    ``ndarray`` and optax's three state classes; every other global is
    refused."""

    def find_class(self, module: str, name: str):
        if (module, name) in OPTAX_GLOBALS:
            return OPTAX_GLOBALS[(module, name)]
        if module == "numpy" and name in _NUMPY_TOP:
            return getattr(np, name)
        for root in ("numpy._core.", "numpy.core."):
            tail = module[len(root):]
            if module.startswith(root) and (tail, name) in _NUMPY_CORE:
                return _numpy_core(tail, name)
        raise ImageError("foreign_global", f"global {module}.{name} is not "
                         "one the JAX package's resume image holds")


def loads(data: bytes) -> Tuple[int, Any]:
    """``(step, tree)`` of an image's pickle (the footer may follow it:
    unpickling stops at the pickle's end); the step as an int, whether the
    image holds an int or a 0-d array."""
    try:
        step, tree = _Unpickler(io.BytesIO(data)).load()
    except ImageError:
        raise
    # Unpickling a verified but wrong payload can raise nearly anything.
    except Exception as exc:
        raise ImageError("corrupt", f"unpickle failed: {exc!r}") from exc
    return int(np.asarray(step)), tree


def read_verified(path: str, fault: bool = False) -> bytes:
    """The bytes of ``<path>/resume-image.bin`` (the port's or the JAX
    package's), once its sha256 footer holds: the footer is checked before
    anything is unpickled.  ``fault`` flips the first byte after the read
    (the corrupt rung's injection).  Raises ``ImageError``."""
    target = os.path.join(path, IMAGE)
    if not os.path.exists(target):
        raise ImageError("missing")
    try:
        with open(target, "rb") as f:
            raw = f.read()
    except OSError as exc:
        raise ImageError("corrupt", f"read failed: {exc!r}") from exc
    if fault and raw:
        raw = bytes([raw[0] ^ 0xFF]) + raw[1:]
    if len(raw) <= SHA_LEN:
        raise ImageError("corrupt", f"truncated ({len(raw)} bytes)")
    if hashlib.sha256(memoryview(raw)[:-SHA_LEN]).digest() \
            != raw[-SHA_LEN:]:
        raise ImageError("corrupt", "sha256 mismatch")
    return raw


def read_image(path: str) -> Tuple[int, Any, Dict[str, float]]:
    """``(step, tree, timings)`` of the JAX package's image at ``path``, in
    its order: the footer (``read_verified``), then the restricted
    unpickle.  Timings: the image's ``bytes``, ``read_s`` (the read and
    the sha256) and ``unpickle_s``.  Raises ``ImageError``."""
    t0 = time.perf_counter()
    raw = read_verified(path)
    t1 = time.perf_counter()
    step, tree = loads(raw)
    return step, tree, {"bytes": float(len(raw)), "read_s": t1 - t0,
                        "unpickle_s": time.perf_counter() - t1}


class _Sha256Writer:
    """A file's ``write`` that also feeds sha256 (the image's footer)."""

    def __init__(self, f):
        self._f = f
        self.sha = hashlib.sha256()

    def write(self, data) -> int:
        self.sha.update(data)
        return self._f.write(data)


class _Pickler(pickle._Pickler):
    """Names each stand-in by optax's module and class, as optax's own
    classes pickle, without an ``optax`` module to look them up in."""

    _NAMES = {cls: key for key, cls in OPTAX_GLOBALS.items()}

    def save_global(self, obj, name=None):
        key = self._NAMES.get(obj)
        if key is None:
            return super().save_global(obj, name)
        self.save(key[0])
        self.save(key[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def write_image(path: str, step: int, tree: Any) -> None:
    """Write ``(step, tree)`` (numpy leaves, the stand-ins above for
    optax's states) as ``<path>/resume-image.bin``: the JAX package's
    layout, footer included, replaced atomically."""
    target = os.path.join(path, IMAGE)
    tmp = f"{target}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        out = _Sha256Writer(f)
        _Pickler(out, protocol=5).dump((step, tree))
        f.write(out.sha.digest())
    os.replace(tmp, target)


def adamw_tree(params: Any, opt_state: Dict[str, Any], step: int
               ) -> Dict[str, Any]:
    """A Llama-family trainer's state (the port's f32 master ``params``
    and ``train.AdamW`` state) as the JAX trainer's image holds it: f32
    numpy leaves, and ``optax.adamw``'s chain state (scale_by_adam,
    add_decayed_weights, scale_by_learning_rate) with an int32 count."""
    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return tree.detach().float().cpu().numpy()

    adam = ScaleByAdamState(np.asarray(opt_state["count"], np.int32),
                            host(opt_state["mu"]), host(opt_state["nu"]))
    return {"params": host(params),
            "opt_state": (adam, EmptyState(), EmptyState()), "step": step}


def is_orbax_step(directory: str) -> bool:
    """Whether ``directory`` is an orbax step directory (committed by the
    JAX package)."""
    return os.path.isfile(os.path.join(directory, ORBAX_MARKER))


def orbax_steps(path: str) -> List[int]:
    """The JAX package's committed step directories under ``path``,
    newest first."""
    try:
        names = os.listdir(path)
    except (FileNotFoundError, NotADirectoryError):
        return []
    return sorted((int(n) for n in names if n.isdigit()
                   and is_orbax_step(os.path.join(path, n))), reverse=True)


def refusal(path: str, step: int, why: str) -> UnreadableJaxState:
    """The refusal of a JAX job's state: names the step, orbax and why."""
    return UnreadableJaxState(
        f"{path} holds orbax step {step}, written by the JAX package, which "
        f"the port cannot read ({why}); refusing to start from step 0")
