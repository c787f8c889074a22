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

import subprocess
from dataclasses import dataclass
from typing import Optional

import torch

from ..errors import RuntimeInitialization

__all__ = ["AUTO", "CPU", "CUDA", "BackendStatus", "available_backends",
           "card_line", "ensure_runtime_available", "provider_metadata",
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


def provider_metadata(platform: str) -> dict:
    """id/name/description of a backend of :func:`available_backends` for
    the ``providers`` command: the CPU as the JAX package describes it, the
    CUDA card by its name."""
    if platform == CPU:
        return {"id": CPU, "name": "CPU",
                "description": "CPU (always available)"}
    return {"id": CUDA, "name": "CUDA",
            "description": f"CUDA ({torch.cuda.get_device_name(0)})"}


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them: what a
    time measured on the card is reported beside."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def ensure_runtime_available(requested: str = AUTO) -> None:
    """Fail fast with :class:`RuntimeInitialization` when torch cannot
    initialize the runtime ``requested`` needs: for ``auto`` (the default,
    which means ``cuda:0``), ``cuda`` or ``gpu``, the CUDA runtime, a first
    card and one allocation on it; for ``cpu``, one allocation on the
    CPU."""
    device = select_backend(requested)[0][0]
    try:
        torch.zeros(1, device=device)
    except Exception as e:  # noqa: BLE001 — any runtime failure is fatal
        raise RuntimeInitialization(str(e)) from e


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
