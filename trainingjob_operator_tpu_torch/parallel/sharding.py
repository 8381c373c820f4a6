"""Parameter and batch sharding rules: own copy of the JAX package's
``parallel/sharding.py``.

Rules map regex patterns over a leaf's path (``"layers/attn/wq"``) to a
partition spec: a tuple with one entry per dim, each ``None``
(replicated), an axis name, or a tuple of axis names (major first).  The
first match wins; no match is replicated.  ``fit_spec`` adapts a rule to a
leaf and a mesh as the JAX function does.

Where JAX hands the spec to the compiler, the port keeps each rank's block
of every leaf itself (``block_of``, ``shard_tree``) and its models gather
what they use (``parallel/collectives.py``).  A batch's rows are split over
the data axes (``data_rows``, in place of ``batch_spec`` and
``globalize_batch``), and each row's sequence over sp
(``sequence_block``, in place of the ring's ``shard_map`` specs).
"""

from __future__ import annotations

import math
import re
from typing import Any, Iterable, Optional, Sequence, Tuple

import torch

Rules = Sequence[Tuple[str, Tuple[Optional[object], ...]]]
#: A leaf's spec: per dim None, an axis name or a tuple of axis names.
Spec = Tuple[Optional[object], ...]
#: A block of a leaf: the leaf's global shape, and per dim the block's
#: [start, stop).
Block = Tuple[Tuple[int, ...], Tuple[Tuple[int, int], ...]]


def spec_for_path(path: str, rules: Rules) -> Spec:
    """The first matching rule's spec for a leaf path; replicated (``()``)
    by default."""
    for pattern, spec in rules:
        if re.search(pattern, path):
            return tuple(spec)
    return ()


def axes_of(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def fit_spec(spec: Spec, shape: Sequence[int], mesh) -> Spec:
    """Adapt a rule's spec to a leaf on ``mesh`` (anything with ``sizes``,
    axis name -> size): align it to the trailing dims when it is longer
    than the rank, drop the axes the mesh lacks, collapse a one-axis tuple
    to its name, and replicate a dim its axes do not divide."""
    entries = list(spec)
    if len(entries) > len(shape):
        entries = entries[len(entries) - len(shape):]
    fitted = []
    for i, entry in enumerate(entries):
        names = tuple(n for n in axes_of(entry) if n in mesh.sizes)
        if not names:
            fitted.append(None)
            continue
        size = math.prod(mesh.sizes[n] for n in names)
        entry = names if len(names) > 1 else names[0]
        fitted.append(entry if size and shape[i] % size == 0 else None)
    return tuple(fitted)


def leaf_spec(path: str, shape: Sequence[int], rules: Rules, mesh) -> Spec:
    """``fit_spec(spec_for_path(path, rules), shape, mesh)`` padded with
    ``None`` to the leaf's rank."""
    spec = fit_spec(spec_for_path(path, rules), shape, mesh)
    return spec + (None,) * (len(shape) - len(spec))


def block_of(spec: Spec, shape: Sequence[int], mesh) -> Block:
    """This rank's block of a leaf of global ``shape`` under a fitted
    ``spec``: a dim split over axes (a0, a1, ...) is cut into
    prod(sizes) equal parts, and the rank takes part
    ``((c0 * s1) + c1) * s2 + ...`` of its coordinates ``c`` (JAX's
    layout of a multi-axis entry)."""
    index = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        part, parts = 0, 1
        for axis in axes_of(entry):
            part = part * mesh.size(axis) + mesh.coord(axis)
            parts *= mesh.size(axis)
        step = dim // parts
        index.append((part * step, (part + 1) * step))
    return tuple(int(d) for d in shape), tuple(index)


def block_slices(block: Block) -> Tuple[slice, ...]:
    return tuple(slice(a, b) for a, b in block[1])


def tree_paths(tree, prefix: str = "") -> Iterable[Tuple[str, Any]]:
    """(path, leaf) of a nested dict, paths joined by "/" as the JAX
    ``path_of`` joins dict keys."""
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            yield from tree_paths(value, path)
        else:
            yield path, value


def map_with_path(fn, tree, prefix: str = ""):
    """``tree`` with each leaf ``x`` at ``path`` replaced by
    ``fn(path, x)``."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        out[key] = (map_with_path(fn, value, path) if isinstance(value, dict)
                    else fn(path, value))
    return out


def tree_blocks(shapes, rules: Rules, mesh):
    """The blocks (``block_of``) of a tree of global shapes on ``mesh``."""
    def one(path, shape):
        return block_of(leaf_spec(path, shape, rules, mesh), shape, mesh)
    return map_with_path(one, shapes)


def shard_tree(tree, rules: Rules, mesh):
    """This rank's block of every tensor leaf of a global tree (a copy)."""
    def one(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        block = block_of(leaf_spec(path, x.shape, rules, mesh), x.shape,
                         mesh)
        return x[block_slices(block)].clone()
    return map_with_path(one, tree)


def data_rows(global_batch: int, mesh) -> Tuple[int, int]:
    """(row0, local_batch): the contiguous rows of a global batch this rank
    trains on.  Rows are split over the data axes (dp major, then fsdp, as
    the JAX ``batch_spec``); ranks that differ only on tp take the same
    rows."""
    n = mesh.data_size()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} does not tile {n} "
                         f"data shards")
    local = global_batch // n
    return mesh.data_index() * local, local


def sequence_block(tokens: torch.Tensor, mesh, axis: str = "sp"):
    """(inputs, targets) of this rank's sequence block of ``[B, T+1]``
    token rows: with ``Tl = T / sp`` and ``r`` the rank's index on
    ``axis``, inputs ``tokens[:, r Tl:(r+1) Tl]`` and targets
    ``tokens[:, r Tl+1:(r+1) Tl+1]``, so that a target crosses a block's
    edge as it does in the whole sequence.  ``ValueError`` where sp does
    not divide T (JAX's ``shard_map`` refuses such a split too)."""
    sp, r = mesh.size(axis), mesh.coord(axis)
    T = tokens.shape[1] - 1
    if T % sp != 0:
        raise ValueError(f"a sequence of {T} tokens is not evenly divisible "
                         f"by mesh axis {axis!r}: {sp} does not evenly "
                         f"divide {T}")
    n = T // sp
    return tokens[:, r * n:(r + 1) * n], tokens[:, r * n + 1:(r + 1) * n + 1]
