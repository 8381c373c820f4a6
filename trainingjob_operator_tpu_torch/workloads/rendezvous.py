"""The worker's identity and its job's rendezvous from the operator's env:
the fields of the JAX package's ``workloads/rendezvous.py`` ``Rendezvous``
/ ``from_env`` that training reads (the checkpoint path, the startup line,
the process group and the mesh), and ``initialize_distributed``, the
counterpart of ``initialize_jax_distributed``.

One process drives one card: ``num_processes`` is the world size of the
process group and ``process_id`` its rank.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from trainingjob_operator_tpu_torch import constants


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
        num_slices=int(e.get(constants.NUM_SLICES_ENV, "1") or 1))


def initialize_distributed(rdv: Rendezvous,
                           device: torch.device) -> torch.device:
    """Form the job's process group from the injected env and return the
    device this process drives.

    ``init_process_group`` at ``tcp://<coordinator>`` with rank
    ``process_id`` and world ``num_processes``: NCCL on a CUDA device
    (the card ``process_id`` modulo the host's cards, made current first),
    gloo on the CPU.  Unlike JAX, which skips initialization for one
    process, a coordinator address at one process forms a group of one, so
    that a single card runs the multi-process path and its collectives.  A
    multi-process job without a coordinator raises; a group that fails to
    form raises from ``init_process_group``.
    """
    import torch.distributed as dist

    if not rdv.coordinator_address:
        raise ValueError(
            f"{constants.COORDINATOR_ADDRESS_ENV} is not set; a job of "
            f"{rdv.num_processes} processes needs it")
    if not 0 <= rdv.process_id < rdv.num_processes:
        raise ValueError(f"process id {rdv.process_id} outside a world of "
                         f"{rdv.num_processes}")
    if device.type == "cuda":
        device = torch.device(
            "cuda", rdv.process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{rdv.coordinator_address}",
        rank=rdv.process_id, world_size=rdv.num_processes)
    return device
