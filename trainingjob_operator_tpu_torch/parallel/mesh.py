"""The device mesh of a multi-process job: own copy of the JAX package's
``parallel/mesh.py`` (axis order, ``MeshSpec``, the arithmetic of
``mesh_from_rendezvous``), built on ``torch.distributed``'s
``DeviceMesh``.

One process drives one card, so the mesh's size is the process group's
world size.  The axes, in DCN-outermost order:

- ``dp``   -- data parallel across slices; gradients all-reduce.
- ``fsdp`` -- data parallel whose ranks each hold a block of every
              parameter and its optimizer state; layers are gathered one at
              a time, gradients reduce-scattered.
- ``tp``   -- tensor (Megatron) parallel: heads and ffn columns split.
- ``ep``   -- expert parallel: the MoE family's experts split
              (``models/moe.py``); each ep rank of a data shard runs its
              experts on the shard's rows, and their outputs are summed.
- ``pp``   -- pipeline parallel: each rank holds one stage's contiguous
              block of the stacked layers, and the layer stack runs as a
              GPipe schedule over the stages (``parallel/pipeline.py``).
- ``sp``   -- sequence parallel: the ranks of a data shard hold the same
              rows and different sequence blocks, and attention runs as
              ring attention over them (``parallel/ringattention.py``).

Two sets of axes, which the JAX package leaves to GSPMD:

- ``DATA_AXES`` (dp, fsdp) split a batch's rows (``data_size``,
  ``data_index``, ``sharding.data_rows``).
- ``summed_axes`` are the axes whose ranks hold other work on the batch:
  the data axes, and sp and pp where they are above 1 (other sequence
  blocks; other stages, of which only the first reads the embedding and
  only the last the head).  The loss and the gradient of every leaf that
  is not split on such an axis are summed over it
  (``parallel/collectives.py``).

``resized_mesh_spec`` has no ``ep``: JAX's MoE trainer has no resize in
place.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, Tuple

#: DCN-outermost order, as in the JAX package.
AXIS_ORDER = ("dp", "pp", "fsdp", "tp", "sp", "ep")
#: The data axes: a batch's rows are split over them, major first.
DATA_AXES = ("dp", "fsdp")
#: Axes whose ranks hold other tokens of the same rows (sp) or other
#: stages of the same layer stack (pp): summed over beside the data axes.
TOKEN_AXES = ("pp", "sp")


@dataclass(frozen=True)
class MeshSpec:
    """Axis sizes, in DCN-outermost order."""

    axes: Tuple[Tuple[str, int], ...]

    @classmethod
    def of(cls, **sizes: int) -> "MeshSpec":
        extra = set(sizes) - set(AXIS_ORDER)
        if extra:
            raise ValueError(f"unknown mesh axes {sorted(extra)}; "
                             f"known: {AXIS_ORDER}")
        return cls(tuple((name, int(sizes[name])) for name in AXIS_ORDER
                         if name in sizes and sizes[name] > 0))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    @property
    def sizes(self) -> Dict[str, int]:
        """Axis name -> size (``jax.sharding.Mesh.shape``)."""
        return dict(self.axes)

    def size(self) -> int:
        return math.prod(self.shape) if self.axes else 1


def mesh_spec_from_rendezvous(rdv, model_parallel: int = 1,
                              sequence_parallel: int = 1,
                              expert_parallel: int = 1,
                              pipeline_parallel: int = 1,
                              fsdp: bool = True) -> MeshSpec:
    """The standard mesh of the worker's job, as the JAX
    ``mesh_from_rendezvous`` derives it, over ``rdv.num_processes`` cards:
    data = world / (tp sp ep pp), dp = ``num_slices``, fsdp = data / dp
    (or dp = data without fsdp); the same ``ValueError``s."""
    n = max(rdv.num_processes, 1)
    inner = (model_parallel * sequence_parallel * expert_parallel
             * pipeline_parallel)
    if n % inner != 0:
        raise ValueError(f"{n} devices not divisible by "
                         f"tp*sp*ep*pp={inner}")
    data = n // inner
    dp = max(rdv.num_slices, 1)
    if data % dp != 0:
        raise ValueError(
            f"data axis {data} not divisible by num_slices={dp}; choose "
            f"tp/sp/ep/pp so each slice holds an equal data shard")
    if fsdp:
        return MeshSpec.of(dp=dp, pp=pipeline_parallel, fsdp=data // dp,
                           tp=model_parallel, sp=sequence_parallel,
                           ep=expert_parallel)
    return MeshSpec.of(dp=data, pp=pipeline_parallel, tp=model_parallel,
                       sp=sequence_parallel, ep=expert_parallel)


def resized_mesh_spec(n_dev: int, num_slices: int = 1,
                      model_parallel: int = 1, sequence_parallel: int = 1,
                      pipeline_parallel: int = 1) -> MeshSpec:
    """The mesh of a resize to ``n_dev`` cards, as the JAX
    ``llama_elastic`` resize cycle derives it from a generation doc: data
    = n_dev / (tp sp pp), dp = ``num_slices`` where it divides the data
    axis (else 1), fsdp = data / dp.  ``ValueError`` where tp sp pp does
    not divide ``n_dev``."""
    inner = model_parallel * sequence_parallel * pipeline_parallel
    if n_dev <= 0 or n_dev % inner != 0:
        raise ValueError(f"{n_dev} devices not divisible by "
                         f"tp*sp*pp={inner}")
    data = n_dev // inner
    dp = max(num_slices, 1)
    if data % dp != 0:
        dp = 1
    return MeshSpec.of(dp=dp, pp=pipeline_parallel, fsdp=data // dp,
                       tp=model_parallel, sp=sequence_parallel)


class Mesh:
    """A ``DeviceMesh`` with the JAX mesh's names: ``axis_names``,
    ``sizes`` (name -> size), this rank's coordinate on each axis
    (``coord``) and the process group along one (``group``)."""

    def __init__(self, spec: MeshSpec, device_mesh, num_slices: int = 1):
        self.spec = spec
        self.device_mesh = device_mesh
        #: Slices the ranks span, slice-major (``axis_crosses_slices``).
        self.num_slices = max(int(num_slices), 1)
        self.axis_names = spec.names
        self.sizes = spec.sizes
        coords = device_mesh.get_coordinate()
        self._coords = dict(zip(spec.names, coords))
        self._groups = {name: device_mesh.get_group(name)
                        for name in spec.names}

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an absent axis)."""
        return self._coords.get(axis, 0)

    def size(self, axis: str) -> int:
        """The size of ``axis`` (1 for an absent axis)."""
        return self.sizes.get(axis, 1)

    def group(self, axis: str):
        return self._groups[axis]

    def data_size(self) -> int:
        """Ranks holding distinct batch rows: the product of the data
        axes."""
        return math.prod(self.size(a) for a in DATA_AXES)

    def data_index(self) -> int:
        """This rank's position among them (dp major, as the JAX batch
        spec ``P(("dp", "fsdp"))`` lays the rows out)."""
        return self.coord("dp") * self.size("fsdp") + self.coord("fsdp")

    def summed_axes(self) -> Tuple[str, ...]:
        """The axes the loss and a leaf's gradient are summed over where
        the leaf is not split on them: every data axis of the mesh (a sum
        over one rank is a copy), and sp and pp where above 1."""
        return tuple(a for a in DATA_AXES if a in self.sizes) + tuple(
            a for a in TOKEN_AXES if self.size(a) > 1)


def axis_crosses_slices(spec: MeshSpec, axis: str, num_slices: int) -> bool:
    """Whether moving along ``axis`` (the other coordinates held) ever
    changes slice, for ranks laid out row-major over ``spec`` and
    ``num_slices`` slices of consecutive ranks (the JAX package's
    ``axis_crosses_dcn`` over slice-major devices)."""
    if axis not in spec.names:
        raise ValueError(f"axis {axis!r} not in mesh {spec.names}")
    if num_slices <= 1:
        return False
    per = spec.size() // num_slices
    ranks = list(itertools.product(*(range(n) for n in spec.shape)))
    i = spec.names.index(axis)
    columns: Dict[Tuple[int, ...], set] = {}
    for rank, coords in enumerate(ranks):
        rest = coords[:i] + coords[i + 1:]
        columns.setdefault(rest, set()).add(rank // per)
    return any(len(ids) > 1 for ids in columns.values())


def make_mesh(spec: MeshSpec, device_type: str,
              num_slices: int = 1) -> Mesh:
    """The ``DeviceMesh`` of ``spec`` over the process group's ranks
    (``init_device_mesh``, axis names as in JAX); its size must equal the
    world size.  A ``Mesh`` holds the sub-groups of the process group it
    was made on: after the group is destroyed and formed again (an
    elastic resize), make a new one, and everything that closed over the
    old one (the step, its collectives) anew.  ``num_slices`` is the
    job's slice count (``MEGASCALE_NUM_SLICES``), which ring attention
    checks its axis against (``collectives.require_ici_axis``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if spec.size() != world:
        raise ValueError(f"mesh {dict(spec.axes)} needs {spec.size()} "
                         f"devices, have {world}")
    return Mesh(spec, init_device_mesh(device_type, spec.shape,
                                       mesh_dim_names=spec.names),
                num_slices)
