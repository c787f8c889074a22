"""Pod membership and data-parallel replicas: the port of
``birda_tpu/parallel/mesh.py``.

The reference's only on-device parallelism is the batch dimension of one
session (SURVEY §2.3). Here a "mesh" is an ordered list of replica
``torch.device``\\ s: each holds its own copy of the parameters, and replica
``i`` computes rows ``[i·B/N, (i+1)·B/N)`` of every batch
(:mod:`birda_tpu_torch.parallel.sharding`). Multi-host file-level work
sharing stays at the lock-file layer (:mod:`birda_tpu_torch.locking`), with
the pod rank of :func:`process_index` in every lock body.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

DATA_AXIS = "data"

#: Environment contract for multi-host pods (set by the launcher on every
#: host): coordinator address, world size, this host's rank.
ENV_COORDINATOR = "BIRDA_COORDINATOR"
ENV_NUM_PROCESSES = "BIRDA_NUM_PROCESSES"
ENV_PROCESS_ID = "BIRDA_PROCESS_ID"

_distributed_initialized = False


def initialize_multihost(env: Optional[dict] = None) -> bool:
    """Join a multi-host pod when the ``BIRDA_COORDINATOR`` contract is set.

    The torch counterpart of ``jax.distributed.initialize``: a blocking
    rendezvous of every host at ``tcp://<coordinator>`` through
    ``torch.distributed`` (gloo). No collective runs on the analyze path;
    each host shards only over its own devices, and the pod divides files
    through the lock files. A no-op (returns False) when the contract is
    absent. Idempotent.
    """
    global _distributed_initialized
    e = env if env is not None else os.environ
    coordinator = e.get(ENV_COORDINATOR)
    if not coordinator:
        return False
    if _distributed_initialized:
        return True
    try:
        num_processes = int(e[ENV_NUM_PROCESSES])
        process_id = int(e[ENV_PROCESS_ID])
    except (KeyError, ValueError) as err:
        from ..errors import ConfigValidation

        raise ConfigValidation(
            f"{ENV_COORDINATOR} is set, so {ENV_NUM_PROCESSES} and "
            f"{ENV_PROCESS_ID} must both be integers (got "
            f"{e.get(ENV_NUM_PROCESSES)!r} / {e.get(ENV_PROCESS_ID)!r})"
        ) from err
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
    )
    _distributed_initialized = True
    logger.info(
        "joined pod: process %s/%s via %s",
        e[ENV_PROCESS_ID], e[ENV_NUM_PROCESSES], coordinator,
    )
    return True


def process_index() -> int:
    """This host's rank in the pod (0 on single-host) — recorded in file
    locks as the cross-host tie-break/observability field. Reads the joined
    process group only; never touches CUDA."""
    if not _distributed_initialized:
        return 0
    import torch.distributed as dist

    return int(dist.get_rank())


def pad_to_multiple(batch_size: int, mesh) -> int:
    """Smallest batch size >= ``batch_size`` divisible by the replica
    count."""
    n = len(mesh)
    return ((batch_size + n - 1) // n) * n
