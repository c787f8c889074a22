"""Per-node score-parity bisection: the port of ``birda_tpu/onnx/parity.py``.

When whole-graph parity against a recording fails, the failure message
must name the first diverging *node*, not just the final max |Δ|. The
recorder (``scripts/record_parity_reference.py --record-nodes``) saves
every intermediate activation under ``node:<tensor>`` keys; this module
replays the port's evaluator capturing the same tensors and walks the
graph in execution order to the first mismatch.

The evaluator runs on the card unless the caller asks for the CPU
(``device="cpu"``), as every entry point of the port does, so a card run
can be bisected against a CPU recording, or against the JAX package's: the
tensor names are the graph's own in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch

from ..inference.backend import AUTO, select_backend
from .lowering import OnnxFunction

#: npz key prefix for recorded per-node activations.
NODE_KEY_PREFIX = "node:"


def _host(val) -> np.ndarray:
    """A value of the environment as host numpy (bf16 as float32: numpy has
    no bf16)."""
    if isinstance(val, torch.Tensor):
        val = val.detach()
        if val.dtype == torch.bfloat16:
            val = val.float()
        return val.cpu().numpy()
    if isinstance(val, (list, tuple)):
        return np.asarray([_host(v) for v in val])
    return np.asarray(val)


def capture_activations(fn: OnnxFunction, *args, params=None,
                        device: str = AUTO) -> dict[str, np.ndarray]:
    """Run the lowered graph eagerly and return EVERY tensor produced
    (graph inputs, all node outputs, final outputs) as host numpy arrays.

    ``device`` is resolved as the port's entry points resolve theirs
    (:func:`~birda_tpu_torch.inference.backend.select_backend`: ``auto``,
    the default, is the card and fails without one; ``cpu`` asks for the
    CPU). The inputs go there; the graph's own weights are copied there as
    the evaluator uses them, and ``params`` given as tensors must lie there
    already.
    """
    dev = select_backend(device)[0][0]
    params = dict(params if params is not None else fn.params)
    feeds = {name: torch.as_tensor(np.ascontiguousarray(a)
                                   if not isinstance(a, torch.Tensor) else a,
                                   device=dev)
             for name, a in zip(fn.input_names, args)}
    env: dict[str, Any] = params
    env.update(feeds)
    env = fn._eval.run(env)
    return {
        name: _host(val)
        for name, val in env.items()
        if name and val is not None and not callable(val)
    }


@dataclass
class Divergence:
    """First point in execution order where ours and the recording part."""

    tensor: str          #: tensor (node output) name
    op_type: str         #: producing node's op type ("<input>" for feeds)
    node_name: str       #: producing node's name
    max_abs_err: float
    ref_magnitude: float  #: max |reference| at that tensor, for scale

    def render(self) -> str:
        return (
            f"first divergence at tensor '{self.tensor}' "
            f"(op {self.op_type}, node '{self.node_name}'): "
            f"max |Δ| = {self.max_abs_err:.3e} "
            f"(reference magnitude {self.ref_magnitude:.3e})"
        )


def node_records(reference: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Extract ``node:<tensor>`` entries from a recorded reference mapping
    (an ``np.load`` result or plain dict)."""
    return {
        key[len(NODE_KEY_PREFIX):]: np.asarray(reference[key])
        for key in getattr(reference, "files", reference)
        if key.startswith(NODE_KEY_PREFIX)
    }


def find_first_divergence(
    fn: OnnxFunction,
    inputs: Mapping[str, np.ndarray] | np.ndarray,
    recorded: Mapping[str, np.ndarray],
    tol: float = 1e-3,
    params=None,
    device: str = AUTO,
) -> Divergence | None:
    """Walk the graph in execution order; return the first tensor whose
    activation differs from the recording by more than ``tol`` (None when
    everything recorded matches).

    ``recorded`` maps tensor names to reference activations (use
    :func:`node_records` to pull them out of a recorder npz). Tensors the
    recording lacks are skipped — a partial recording still localizes to
    the span between its covered tensors. The graph runs on ``device``, as
    in :func:`capture_activations`.
    """
    if not isinstance(inputs, Mapping):
        inputs = {fn.input_names[0]: inputs}
    ours = capture_activations(
        fn, *(inputs[n] for n in fn.input_names), params=params,
        device=device,
    )

    producer: dict[str, tuple[str, str]] = {}
    order: list[str] = []
    for name in fn.input_names:
        producer[name] = ("<input>", "")
        order.append(name)
    for node in fn.graph.nodes:
        for out in node.outputs:
            if out:
                producer[out] = (node.op_type, node.name)
                order.append(out)

    for tensor in order:
        ref = recorded.get(tensor)
        if ref is None or tensor not in ours:
            continue
        got = np.asarray(ours[tensor], np.float64)
        want = np.asarray(ref, np.float64)
        if got.shape != want.shape:
            op_type, node_name = producer[tensor]
            return Divergence(tensor, op_type, node_name, float("inf"),
                              float(np.max(np.abs(want))) if want.size else 0.0)
        err = float(np.max(np.abs(got - want))) if want.size else 0.0
        if err > tol:
            op_type, node_name = producer[tensor]
            return Divergence(
                tensor, op_type, node_name, err,
                float(np.max(np.abs(want))) if want.size else 0.0,
            )
    return None
