"""The full-scale ONNX fixtures, under the port's module path.

``birda_tpu.onnx.fullscale`` synthesizes the shipped families' graphs from a
seed on the host with numpy (no jax); the port uses it as it is.
"""

from birda_tpu.onnx.fullscale import (  # noqa: F401 — re-exported
    BIRDNET_V24_SPEC,
    BIRDNET_V30_SPEC,
    build,
    cached_build,
    tiny_spec,
)
