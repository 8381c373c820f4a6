"""The worker's identity from the operator's env: the fields of the JAX
package's ``workloads/rendezvous.py`` ``Rendezvous`` / ``from_env`` that
single-card training reads (the checkpoint path and the startup line).

The peers, process ids and coordinator of a multi-process job come with
the multi-GPU slice (ROADMAP.md queue 1 item 3).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

from trainingjob_operator_tpu_torch import constants


@dataclass
class Rendezvous:
    """Where a worker stands in its job."""

    replica_name: str = ""
    replica_index: int = 0
    restart_count: int = 0
    checkpoint_dir: str = ""
    elastic_replicas: int = 1


def from_env(env: Optional[Dict[str, str]] = None) -> Rendezvous:
    e = os.environ if env is None else env
    return Rendezvous(
        replica_name=e.get(constants.REPLICA_NAME_ENV, ""),
        replica_index=int(e.get(constants.REPLICA_INDEX_ENV, "0") or 0),
        restart_count=int(
            e.get(constants.REPLICA_RESTART_COUNT_ENV, "0") or 0),
        checkpoint_dir=e.get(constants.CHECKPOINT_DIR_ENV, ""),
        elastic_replicas=int(e.get(constants.ELASTIC_REPLICAS_ENV, "1")
                             or 1))
