"""Accelerator backend selection: the port of
``birda_tpu/inference/backend.py`` for CUDA and the CPU.

An explicit request fails loudly when it cannot be met; ``auto`` picks the
first CUDA device when there is one, else the CPU, with the reason
recorded. The status keeps the JAX package's ``BackendStatus`` shape
(``requested``/``actual``/``fallback_reason``), which the JSON protocol
reports.
"""

from __future__ import annotations

import torch

from birda_tpu.errors import RuntimeInitialization
from birda_tpu.inference.backend import BackendStatus

__all__ = ["AUTO", "CPU", "CUDA", "BackendStatus", "available_backends",
           "select_backend"]

CUDA = "cuda"
CPU = "cpu"
AUTO = "auto"
#: Device names a caller may request; ``gpu`` is an explicit CUDA request.
REQUESTS = (AUTO, CUDA, CPU, "gpu")


def available_backends() -> list[str]:
    """Backends this process can run on, in preference order."""
    return [CUDA, CPU] if torch.cuda.is_available() else [CPU]


def select_backend(requested: str = AUTO
                   ) -> tuple[list[torch.device], BackendStatus]:
    """Resolve the requested backend to ``([device], status)``."""
    requested = (requested or AUTO).lower()
    if requested == "gpu":
        requested = CUDA
    if requested not in (AUTO, CUDA, CPU):
        raise RuntimeInitialization(
            f"unknown device '{requested}' (this build runs on cuda or cpu)")
    if requested == CPU:
        return [torch.device(CPU)], BackendStatus(CPU, CPU)
    has_cuda = torch.cuda.is_available()
    if requested == AUTO:
        if has_cuda:
            return [torch.device(CUDA, 0)], BackendStatus(AUTO, CUDA)
        return [torch.device(CPU)], BackendStatus(
            AUTO, CPU, "no CUDA devices detected")
    if not has_cuda:
        raise RuntimeInitialization(
            "CUDA was requested but no CUDA device is available")
    return [torch.device(CUDA, 0)], BackendStatus(CUDA, CUDA)
