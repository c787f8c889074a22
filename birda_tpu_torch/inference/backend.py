"""Accelerator backend selection: the port of
``birda_tpu/inference/backend.py`` for CUDA and the CPU.

The port runs on the card: ``auto`` (the default) and ``cuda``/``gpu``
resolve to the CUDA devices (an unsharded run uses the first), and without
one they fail loudly with a typed error that names the CPU request. Only an explicit ``cpu`` runs on
the CPU. The status keeps the JAX package's ``BackendStatus`` shape
(``requested``/``actual``/``fallback_reason``), which the JSON protocol
reports.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..errors import RuntimeInitialization

__all__ = ["AUTO", "CPU", "CUDA", "BackendStatus", "available_backends",
           "select_backend"]

CUDA = "cuda"
CPU = "cpu"
AUTO = "auto"


@dataclass
class BackendStatus:
    """Requested vs actual backend, with fallback reason when they differ."""

    requested: str
    actual: str
    fallback_reason: Optional[str] = None

    def to_json_dict(self) -> dict:
        d = {"requested": self.requested, "actual": self.actual}
        if self.fallback_reason is not None:
            d["fallback_reason"] = self.fallback_reason
        return d


def available_backends() -> list[str]:
    """Backends this process can run on, in preference order."""
    return [CUDA, CPU] if torch.cuda.is_available() else [CPU]


def select_backend(requested: str = AUTO
                   ) -> tuple[list[torch.device], BackendStatus]:
    """Resolve the requested backend to ``(devices, status)``: every CUDA
    device of this process in index order, or the CPU; ``gpu`` is an
    explicit CUDA request."""
    requested = (requested or AUTO).lower()
    if requested == "gpu":
        requested = CUDA
    if requested not in (AUTO, CUDA, CPU):
        raise RuntimeInitialization(
            f"unknown device '{requested}' (this build runs on cuda or cpu)")
    if requested == CPU:
        return [torch.device(CPU)], BackendStatus(CPU, CPU)
    if not torch.cuda.is_available():
        what = ("CUDA was requested" if requested == CUDA
                else "the default device is the CUDA card")
        raise RuntimeInitialization(
            f"{what} but no CUDA device is available; pass device=\"cpu\" "
            "(--cpu) to run on the CPU")
    return ([torch.device(CUDA, i) for i in range(torch.cuda.device_count())],
            BackendStatus(requested, CUDA))
