"""Sharded execution of the inference step over replicas: the port of
``birda_tpu/parallel/sharding.py``.

The JAX package jits the step with its batch axis sharded over a device
mesh. Here the mesh is an ordered list of replica devices, each holding its
own copy of the parameters: replica ``i`` computes rows ``[i·B/N,
(i+1)·B/N)``, every shard is enqueued on its device's stream before any is
waited on, and the outputs come back to the host in row order. Per-shard
top-k needs no communication between replicas at all.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch


class Gather:
    """The shards of one sharded call, in flight: :meth:`wait` copies them
    to the host and joins them in row order."""

    def __init__(self, shards: list[tuple], done: list):
        self._shards = shards
        self._done = done

    def wait(self) -> tuple[np.ndarray, ...]:
        for event in self._done:
            if event is not None:
                event.synchronize()
        return tuple(np.concatenate([s[k].numpy() for s in self._shards])
                     for k in range(len(self._shards[0])))


def _on(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def shard_data_parallel(
    fn: Callable[[torch.device, slice], tuple],
    mesh: Sequence[torch.device],
) -> Callable[[int], Gather]:
    """``fn`` with the leading (batch) axis sharded over the replicas of
    ``mesh``.

    ``fn(device, rows)`` enqueues the step for batch rows ``rows`` on
    ``device`` and returns its batch-major output tensors there. The
    returned ``run(batch)`` calls it once per replica, each shard's outputs
    copied to the host without blocking and followed by an event on its
    device, and returns a :class:`Gather`. A one-device mesh is the
    unsharded call.
    """
    n = len(mesh)

    def run(batch: int) -> Gather:
        if batch % n != 0:
            raise ValueError(
                f"batch {batch} not divisible by mesh size {n}; pad with "
                "silence first")
        per = batch // n
        shards, done = [], []
        for i, device in enumerate(mesh):
            with _on(device):
                out = fn(device, slice(i * per, (i + 1) * per))
                shards.append(tuple(o.to("cpu", non_blocking=True)
                                    for o in out))
                event: Optional[torch.cuda.Event] = None
                if device.type == "cuda":
                    event = torch.cuda.Event()
                    event.record()
                done.append(event)
        return Gather(shards, done)

    return run
