"""Collectives of a sharded step over the mesh's process groups: the
counterparts of the JAX package's ``parallel/collectives.py`` (``psum``,
``pmean``, ``axis_size``), which XLA inserts there and the port calls by
hand, each as a ``torch.autograd.Function``:

- ``gather`` -- a sharded leaf made whole for its use: the forward casts
  the local block to the compute dtype and all-gathers it; the backward
  reduce-scatters the gradient, in the leaf's own dtype (f32 masters), as
  a sum over the data axes the leaf is split on, takes its own block back
  on a model axis, and all-reduces over the data axes it is replicated on
  (a replicated leaf -- a norm scale -- is the case with nothing to
  gather).
- ``copy_to_tp`` / ``reduce_from_tp`` -- Megatron's pair around a
  column- then row-parallel product: identity with an all-reduce of the
  gradient over tp, and an all-reduce over tp with an identity backward.
  Both take a tuple of model axes too (the MoE experts' ``("tp", "ep")``:
  one all-reduce per axis, which together sum over the sub-mesh).
- ``sum_over_data`` -- a per-rank loss summed over the mesh's summed
  axes (``Mesh.summed_axes``: the data axes, sp and pp; each rank's loss
  is its tokens' mean divided by the number of ranks holding other
  tokens, so the sum is the global mean), with an identity backward:
  every rank's graph gets the gradient of its own tokens, and the leaves'
  collectives sum them.
- ``all_reduce_data`` -- replicated leaves' gradients (MNIST's and
  ResNet's data parallelism) summed over the summed axes in one bucket.
- ``psum_data`` -- a statistic summed over the summed axes whose
  gradient is summed over them as well: the sums of ResNet's batch norm
  over the global batch, which every rank's loss reads.
- ``ppermute_next`` / ``ppermute_prev`` -- a block shifted one hop around
  the ring of an axis (JAX's ``ppermute`` over ``ring_permutation``): one
  ``batch_isend_irecv`` of a send to the next rank and a receive from the
  previous one, whose backward is the reverse shift.  Ring attention
  (``parallel/ringattention.py``) rotates K and V with it over sp, the
  pipeline (``parallel/pipeline.py``) hands a stage's output on over pp.

Only ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce`` and ``batch_isend_irecv`` are used.  Each call counts one
launch (``collective_counts``; a shift counts under ``p2p``).  The mesh
checks of JAX's module (``require_axis``, ``require_ici_axis``) come with
them.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from trainingjob_operator_tpu_torch.parallel.mesh import (
    DATA_AXES,
    axis_crosses_slices,
)
from trainingjob_operator_tpu_torch.parallel.sharding import Spec, axes_of

_counts = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0, "p2p": 0}


def collective_counts() -> Dict[str, int]:
    """Collective launches since the last ``reset_collective_counts``."""
    return dict(_counts)


def reset_collective_counts() -> None:
    for key in _counts:
        _counts[key] = 0


def _all_gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, contiguous: gathered as
    [size, *x.shape] and flattened into ``dim`` (a copy only where ``dim``
    is not the leading dim and ``size`` > 1), so that the product reading
    it sees the layout it would see without a mesh."""
    import torch.distributed as dist

    x = x.contiguous()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    # torch 2.13 deprecates the *_tensor spellings for *_single, which
    # older releases lack.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x, group=group)
    _counts["all_gather"] += 1
    out = out.view((size,) + tuple(x.shape))
    return out.movedim(0, dim).flatten(dim, dim + 1).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group,
                    size: int) -> torch.Tensor:
    """This rank's part along ``dim`` of the ranks' ``x`` summed: the
    adjoint of ``_all_gather``."""
    import torch.distributed as dist

    parts = x.unflatten(dim, (size, x.shape[dim] // size)).movedim(dim, 0)
    out = x.new_empty(parts.shape[1:])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, parts.contiguous().flatten(0, 1),
                                   group=group)
    _counts["reduce_scatter"] += 1
    return out


def _all_reduce(x: torch.Tensor, group, fresh: bool = False) -> torch.Tensor:
    """The sum over ``group`` of ``x``: in place where ``x`` is ``fresh``
    (made by the caller and read by no one else), else into a copy (the
    input may be a tensor a selective checkpoint keeps, or a gradient
    autograd hands to others too)."""
    import torch.distributed as dist

    out = x.contiguous() if fresh else x.clone(
        memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    _counts["all_reduce"] += 1
    return out


#: One gather step: (dim, axis) -- all-gather ``dim`` over ``axis``.
Step = Tuple[int, str]


def gather_steps(spec: Spec, keep: Sequence[str] = ()) -> List[Step]:
    """The all-gathers that make a leaf of fitted ``spec`` whole except on
    the axes in ``keep``, in forward order: on each dim its minor axis
    first, so that each gather concatenates blocks that are adjacent in
    the leaf."""
    steps = []
    for dim, entry in enumerate(spec):
        for axis in reversed(axes_of(entry)):
            if axis not in keep:
                steps.append((dim, axis))
    return steps


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, steps, reduce_axes, dtype):
        ctx.mesh, ctx.steps, ctx.reduce_axes = mesh, steps, reduce_axes
        ctx.master = x.dtype
        # A new tensor even where there is nothing to cast or gather: a
        # Function's output must not be its input.
        y = x.view_as(x) if dtype in (None, x.dtype) else x.to(dtype)
        for dim, axis in steps:
            y = _all_gather(y, dim, mesh.group(axis), mesh.size(axis))
        return y

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        g = grad.to(ctx.master, copy=True)
        for dim, axis in reversed(ctx.steps):
            size = mesh.size(axis)
            if axis in DATA_AXES:
                g = _reduce_scatter(g, dim, mesh.group(axis), size)
            else:
                step = g.shape[dim] // size
                g = g.narrow(dim, mesh.coord(axis) * step, step)
        for axis in ctx.reduce_axes:
            g = _all_reduce(g, mesh.group(axis), fresh=True)
        return g, None, None, None, None


def gather(x: torch.Tensor, spec: Spec, mesh,
           dtype: Optional[torch.dtype] = None,
           keep: Sequence[str] = ()) -> torch.Tensor:
    """The leaf ``x`` (this rank's block under the fitted ``spec``) cast to
    ``dtype`` and all-gathered on every axis of its spec but those in
    ``keep``, which stay split (a layer leaf's tp columns, and the stage
    block of a leaf split on pp, whose spec may have left that entry out).
    Its gradient comes back summed over every summed axis of the mesh
    (``Mesh.summed_axes``): reduce-scattered over those the leaf is split
    on, all-reduced over the others but those in ``keep``.  On a gathered
    model axis (tp) the ranks' gradients are equal, and each takes its own
    block."""
    split = {a for entry in spec for a in axes_of(entry)} | set(keep)
    reduce_axes = tuple(a for a in mesh.summed_axes() if a not in split)
    return _Gather.apply(x, mesh, gather_steps(spec, keep), reduce_axes,
                         dtype)


#: Model axes a copy_to_tp / reduce_from_tp pair sums over: one axis name
#: or a tuple of them.
Axes = Union[str, Tuple[str, ...]]


def _sum_over(x: torch.Tensor, mesh, axes: Tuple[str, ...]) -> torch.Tensor:
    """``x`` summed over each axis of ``axes`` in turn (a copy; the first
    all-reduce makes it, the others reduce it in place)."""
    for i, axis in enumerate(axes):
        x = _all_reduce(x, mesh.group(axis), fresh=i > 0)
    return x


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.mesh, ctx.axes), None, None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _sum_over(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def copy_to_tp(x: torch.Tensor, mesh, axes: Axes = "tp") -> torch.Tensor:
    """Megatron's f: the input of column-parallel products, whose gradient
    is a partial sum on each rank of the model ``axes`` (default tp)."""
    return _CopyToTp.apply(x, mesh, _axes(axes))


def reduce_from_tp(x: torch.Tensor, mesh, axes: Axes = "tp") -> torch.Tensor:
    """Megatron's g: the partial products of a row-parallel product summed
    over the model ``axes`` (default tp)."""
    return _ReduceFromTp.apply(x, mesh, _axes(axes))


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        for axis in mesh.summed_axes():
            x = _all_reduce(x, mesh.group(axis))
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the mesh's summed axes; identity backward."""
    return _SumOverData.apply(x, mesh)


def all_reduce_data(tensors: Sequence[torch.Tensor], mesh) -> None:
    """Each tensor (no autograd) summed in place over the mesh's summed
    axes: one all-reduce an axis of their concatenation, the bucket of a
    data-parallel step's replicated gradients."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for axis in mesh.summed_axes():
        flat = _all_reduce(flat, mesh.group(axis), fresh=True)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


class _PsumData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        for axis in mesh.summed_axes():
            x = _all_reduce(x, mesh.group(axis))
        return x

    @staticmethod
    def backward(ctx, grad):
        for axis in ctx.mesh.summed_axes():
            grad = _all_reduce(grad, ctx.mesh.group(axis))
        return grad, None


def psum_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the mesh's summed axes, whose gradient is summed
    over them too: every rank's share of the loss reads the sum (a batch
    statistic of the global batch), so each rank's input gets the
    gradient of all the shares."""
    return _PsumData.apply(x, mesh)


def ring_permutation(axis_size: int,
                     reverse: bool = False) -> Tuple[Tuple[int, int], ...]:
    """(source, destination) pairs of one hop around the ring: i -> i + 1,
    or i -> i - 1 with ``reverse`` (JAX's ``ring_permutation``)."""
    if reverse:
        return tuple((i, (i - 1) % axis_size) for i in range(axis_size))
    return tuple((i, (i + 1) % axis_size) for i in range(axis_size))


def _shift(x: torch.Tensor, mesh, axis: str, reverse: bool) -> torch.Tensor:
    """The block of the previous rank on ``axis`` (of the next one with
    ``reverse``): this rank's ``x`` sent one hop along
    ``ring_permutation`` and the neighbour's received, in one
    ``batch_isend_irecv`` on the axis's group.  ``x`` itself at an axis of
    size 1: a rank never sends to itself."""
    size = mesh.size(axis)
    if size == 1:
        return x
    import torch.distributed as dist

    group = mesh.group(axis)
    me = mesh.coord(axis)
    perm = ring_permutation(size, reverse)
    dst = dist.get_global_rank(group, dict(perm)[me])
    src = dist.get_global_rank(group, {d: s for s, d in perm}[me])
    x = x.contiguous()
    out = torch.empty_like(x)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dst, group=group),
        dist.P2POp(dist.irecv, out, src, group=group)])
    for work in works:
        work.wait()
    _counts["p2p"] += 1
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, reverse):
        ctx.mesh, ctx.axis, ctx.reverse = mesh, axis, reverse
        y = _shift(x, mesh, axis, reverse)
        # A Function's output must not be its input (size 1).
        return x.view_as(x) if y is x else y

    @staticmethod
    def backward(ctx, grad):
        return (_shift(grad, ctx.mesh, ctx.axis, not ctx.reverse), None,
                None, None)


def ppermute_next(x: torch.Tensor, mesh, axis: str = "sp") -> torch.Tensor:
    """Rotate a block one hop around the ring of ``axis`` (rank i's ``x``
    goes to rank i + 1; this rank gets rank i - 1's); the backward rotates
    the gradient back."""
    return _Shift.apply(x, mesh, axis, False)


def ppermute_prev(x: torch.Tensor, mesh, axis: str = "sp") -> torch.Tensor:
    """Rotate one hop the other way (rank i's ``x`` goes to rank i - 1)."""
    return _Shift.apply(x, mesh, axis, True)


def require_axis(mesh, axis: str) -> int:
    """The size of ``axis``; ``ValueError`` where the mesh lacks it (JAX's
    ``require_axis``, message and all)."""
    if axis not in mesh.axis_names:
        raise ValueError(
            f"mesh has axes {mesh.axis_names}, no {axis!r}; build the mesh "
            f"with MeshSpec.of(..., {axis}=n) (parallel/mesh.py)")
    return mesh.size(axis)


def require_ici_axis(mesh, axis: str) -> int:
    """As ``require_axis``, and ``ValueError`` (JAX's message) where
    ``axis`` crosses slices (``mesh.axis_crosses_slices`` over the mesh's
    ``num_slices``): a ring over the network between slices would wait on
    it at every hop."""
    size = require_axis(mesh, axis)
    if axis_crosses_slices(mesh.spec, axis, mesh.num_slices):
        raise ValueError(
            f"mesh axis {axis!r} crosses slice boundaries (DCN); ring/"
            f"per-layer collectives must ride ICI -- put the DCN hop on the "
            f"leading dp axis instead (parallel/mesh.py axis convention)")
    return size
