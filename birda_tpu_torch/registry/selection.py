"""Hardware-aware variant selection: the host pieces of
``birda_tpu/registry/selection.py`` (reference
``src/registry/selection.rs``), with a probe that asks torch for a CUDA card
where the JAX module asks ``jax.default_backend()``.

Candidates narrow by region first (an explicit variant id is looked up
within the requested region's variants, or the global ones without
``--region``). Within the candidates the priority is: explicit variant id >
precision preferred by the backend > registry default; with none of those,
selection errors rather than guesses. The precision ladder is the JAX
package's: fp32 weights first, then fp16; int8-arm variants target ARM CPU
hosts and are never auto-selected.
"""

from __future__ import annotations

import platform
from dataclasses import dataclass
from typing import Optional

from ..errors import RegionNotFound, RegionsNotSupported, VariantNotFound
from .schema import RegistryModel, Variant


@dataclass
class SystemProbe:
    """What the selection can see of the machine."""

    backend: str = "cpu"      # "cuda" | "cpu"
    arch: str = ""

    @classmethod
    def detect(cls, backend: Optional[str] = None) -> "SystemProbe":
        if backend is None:
            try:
                import torch

                backend = "cuda" if torch.cuda.is_available() else "cpu"
            except Exception:  # noqa: BLE001
                backend = "cpu"
        return cls(backend=backend, arch=platform.machine())


def _precision_order(probe: SystemProbe) -> list[str]:
    # int8-arm assets (QLinear/QDQ graphs) lower and run (integer-exact
    # accumulation, onnx/lowering.py quantization section), but they are
    # ARM-CPU-targeted quantizations: on TPU the fp32 asset in bf16 is both
    # faster and more accurate, so int8 is never auto-selected — an
    # explicit --variant int8-arm installs and runs one.
    del probe
    return ["fp32", "fp16", "no-dft-fp32"]


def select_variant(
    model: RegistryModel,
    explicit_variant: Optional[str] = None,
    region: Optional[str] = None,
    probe: Optional[SystemProbe] = None,
) -> Variant:
    if not model.has_variants:
        raise VariantNotFound(f"{model.id} has no variants")
    probe = probe or SystemProbe.detect()

    candidates = model.variants
    if region is not None:
        candidates = [v for v in candidates if v.region == region]
        if not candidates:
            known = sorted({v.region for v in model.variants if v.region})
            if not known:
                raise RegionsNotSupported(model.id)
            raise RegionNotFound(f"{region} (known: {', '.join(known)})")
    else:
        candidates = [v for v in candidates if v.region is None]
        if not candidates:
            # No global variant at all is a broken registry, not a user typo
            # — installing whichever region sorts first would be a guess.
            # "No region 'global'" wording would send the user hunting for a
            # region name that was never the problem (reference
            # selection.rs:168-180).
            raise VariantNotFound(
                f"global for {model.id} (available: none, this model "
                f"publishes regional variants only — name one with --region)"
            )

    available = ", ".join(v.id for v in candidates)
    if explicit_variant is not None:
        for v in candidates:
            if v.id == explicit_variant:
                return v
        # Name the valid ids — the rejection is useless without them
        # (reference selection.rs:195-201).
        raise VariantNotFound(
            f"{explicit_variant} for {model.id}"
            + (f" region {region}" if region else "")
            + f" (available: {available})"
        )

    for precision in _precision_order(probe):
        for v in candidates:
            if v.id == precision:
                return v

    if model.default_variant:
        for v in candidates:
            if v.id == model.default_variant:
                return v
        # The family default is missing for this region: an error naming
        # it, not a silent substitute (reference selection.rs:249-256).
        raise VariantNotFound(
            f"{model.default_variant} for {model.id}"
            + (f" region {region}" if region else "")
            + f" (available: {available})"
        )

    # No default declared and nothing on the precision ladder matched:
    # guessing candidates[0] would install whatever sorts first in the
    # manifest — error rather than guess (reference selection.rs:241-248).
    raise VariantNotFound(
        f"default for {model.id} (no default_variant declared; "
        f"available: {available})"
    )
