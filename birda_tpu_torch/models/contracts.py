"""Model I/O contracts, under the port's module path.

``birda_tpu.models.contracts`` is host code (no jax); the port uses it as
it is.
"""

from birda_tpu.models.contracts import (  # noqa: F401 — re-exported
    ModelConfig,
    ModelFamily,
    contract_for,
)
