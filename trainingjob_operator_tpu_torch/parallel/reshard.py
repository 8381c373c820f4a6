"""Shard redistribution for an elastic resize in place: own copy of the
JAX package's ``parallel/reshard.py``.

- **Plan arithmetic** (pure, the JAX functions verbatim): ``shard_ranges``
  / ``plan_exchange`` model one array axis chunked JAX-style (ceil
  division, last shard ragged) across the old and new shard counts, and
  emit per-destination segments tagged with the old shard that holds them;
  a segment whose only source was lost is ``missing``, and
  ``plan_pytree_exchange`` sums the plans of a tree's leaves (its
  ``covered`` and ``moved_bytes`` are the resize's gate and the traffic
  it reports).
- **Live executor** (``redistribute``): where JAX ``device_put``s the live
  tree onto the new mesh's shardings, the port holds each rank's block of
  every leaf itself (``parallel/sharding.py``), so the new block is cut
  from the one this process holds, on its device: the same tensor where
  the block does not change, a device copy of a slice where it shrinks.
  A block that needs elements this process does not hold raises
  ``RebootstrapError("reshard")``: the port has no cross-process live
  exchange (nor has JAX), and the resize falls back to the checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from trainingjob_operator_tpu_torch.workloads.rendezvous import (
    RebootstrapError,
)


@dataclass(frozen=True)
class Segment:
    """One contiguous run of elements destined for shard ``dst``.

    ``src`` is the old shard that holds the run, or None when that shard
    was lost with the dead replica (checkpoint fallback required).
    """

    dst: int
    src: Optional[int]
    start: int
    stop: int

    @property
    def size(self) -> int:
        return self.stop - self.start


@dataclass(frozen=True)
class ExchangePlan:
    """The full segment list for one axis of one (logical) array."""

    n: int
    old_shards: int
    new_shards: int
    segments: Tuple[Segment, ...]

    @property
    def stationary(self) -> Tuple[Segment, ...]:
        """Runs already resident on their destination shard: zero traffic."""
        return tuple(s for s in self.segments
                     if s.src is not None and s.src == s.dst)

    @property
    def moves(self) -> Tuple[Segment, ...]:
        """Runs that cross shards: the peer-to-peer traffic."""
        return tuple(s for s in self.segments
                     if s.src is not None and s.src != s.dst)

    @property
    def missing(self) -> Tuple[Segment, ...]:
        """Runs whose only source died: survivors cannot supply them."""
        return tuple(s for s in self.segments if s.src is None)

    @property
    def covered(self) -> bool:
        """True when the survivors hold every element of the new layout --
        the gate for the in-place fast path (else: orbax fallback)."""
        return not self.missing

    def bytes_moved(self, itemsize: int = 4) -> int:
        return sum(s.size for s in self.moves) * itemsize

    def stats(self, itemsize: int = 4) -> Dict[str, int]:
        return {
            "moved_bytes": self.bytes_moved(itemsize),
            "stationary_bytes": sum(s.size for s in self.stationary) * itemsize,
            "missing_bytes": sum(s.size for s in self.missing) * itemsize,
        }


def shard_ranges(n: int, shards: int) -> List[Tuple[int, int]]:
    """Per-shard [start, stop) element ranges, jax-style ceil chunking:
    every shard but possibly the last holds ``ceil(n/shards)`` elements,
    trailing shards may be empty when ``shards > n``."""
    if n < 0 or shards <= 0:
        raise ValueError(f"need n >= 0 and shards > 0, got n={n}, "
                         f"shards={shards}")
    chunk = -(-n // shards) if n else 0
    return [(min(i * chunk, n), min((i + 1) * chunk, n))
            for i in range(shards)]


def plan_exchange(n: int, old_shards: int, new_shards: int,
                  lost: Iterable[int] = ()) -> ExchangePlan:
    """Plan the old->new redistribution of one axis of ``n`` elements.

    ``lost`` are OLD shard indices that died with the resize: their runs
    come out as ``src=None`` (missing).  The segments partition [0, n)
    exactly -- every element of the new layout is accounted for, covered
    or not.
    """
    dead = frozenset(lost)
    old = shard_ranges(n, old_shards)
    segments: List[Segment] = []
    for dst, (a, b) in enumerate(shard_ranges(n, new_shards)):
        for src, (oa, ob) in enumerate(old):
            start, stop = max(a, oa), min(b, ob)
            if stop > start:
                segments.append(Segment(
                    dst=dst, src=None if src in dead else src,
                    start=start, stop=stop))
    return ExchangePlan(n=n, old_shards=old_shards, new_shards=new_shards,
                        segments=tuple(segments))


def plan_pytree_exchange(shapes: Dict[str, Tuple[int, ...]],
                         old_shards: int, new_shards: int,
                         lost: Iterable[int] = (), axis: int = 0,
                         itemsize: int = 4) -> Dict[str, Any]:
    """Aggregate exchange plans over a pytree's leaf shapes.

    ``shapes`` maps leaf path -> array shape (as the checkpoint layout
    tool reports them); the sharded ``axis`` of each leaf is planned
    independently, the off-axis extent scales the byte counts.  Returns
    ``{"plans": {path: plan}, "covered": bool, "moved_bytes": int,
    "stationary_bytes": int, "missing_bytes": int}`` -- the caller's one
    fast-path/fallback decision plus the traffic it should expect.
    """
    plans: Dict[str, ExchangePlan] = {}
    totals = {"moved_bytes": 0, "stationary_bytes": 0, "missing_bytes": 0}
    for path, shape in sorted(shapes.items()):
        if not shape:
            continue
        ax = axis if axis < len(shape) else 0
        row = itemsize
        for i, dim in enumerate(shape):
            if i != ax:
                row *= dim
        plan = plan_exchange(shape[ax], old_shards, new_shards, lost)
        plans[path] = plan
        for key, value in plan.stats(row).items():
            totals[key] += value
    return {"plans": plans,
            "covered": all(p.covered for p in plans.values()),
            **totals}


def _whole(x: torch.Tensor):
    return tuple(x.shape), tuple((0, n) for n in x.shape)


def redistribute(tree: Any, old_blocks: Any, new_blocks: Any,
                 where: str = "") -> Any:
    """This process's live ``tree`` (its blocks under ``old_blocks``, a
    tree of ``sharding.Block`` keyed like ``tree``; whole where absent)
    cut to its blocks under ``new_blocks``, with no host copy and no
    checkpoint.  A leaf whose block does not change is returned as it is;
    one whose new block lies inside the old is a copy of that slice on the
    same device, keeping ``requires_grad``.  Raises
    ``RebootstrapError("reshard", ...)`` where a new block needs elements
    the old one does not hold."""
    if isinstance(tree, dict):
        old_blocks, new_blocks = old_blocks or {}, new_blocks or {}
        return {k: redistribute(v, old_blocks.get(k), new_blocks.get(k),
                                f"{where}/{k}")
                for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    old = old_blocks or _whole(tree)
    new = new_blocks or (old[0], tuple((0, n) for n in old[0]))
    if tuple(old[0]) != tuple(new[0]):
        raise RebootstrapError(
            "reshard", f"leaf {where or '/'}: global shape {old[0]} != "
                       f"{new[0]}")
    if tuple(old[1]) == tuple(new[1]):
        return tree
    if any(c < a or d > b for (a, b), (c, d) in zip(old[1], new[1])):
        raise RebootstrapError(
            "reshard", f"leaf {where or '/'}: block {new[1]} is not local "
                       f"(this process holds {old[1]})")
    index = tuple(slice(c - a, d - a) for (a, _), (c, d) in
                  zip(old[1], new[1]))
    out = tree.detach()[index].clone()
    return out.requires_grad_(tree.requires_grad)
