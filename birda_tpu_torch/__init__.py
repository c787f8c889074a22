"""birda_tpu_torch — the PyTorch/CUDA port of birda_tpu.

The same analyze pipeline as ``birda_tpu``, with the device path in
PyTorch and the TPU's Pallas kernels rewritten by hand in CUDA C++ for
Hopper (``csrc/``). It imports no jax and nothing of ``birda_tpu``: the
host layers (decode, config, locking, writers, the ONNX parser and fusion
pass, ...) are the port's own copies, under the same subpackage and module
names. It runs on the CUDA card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

#: Lazy re-exports of the library API (birda_tpu_torch.analyze and friends)
#: keep `import birda_tpu_torch` light: the CLI and tests import
#: subpackages directly, and the API pulls in torch only when first used.
_API_NAMES = ("analyze", "species", "clip", "AnalyzeResult",
              "FileResult", "Detection", "SpeciesEntry")


def __getattr__(name):
    if name in _API_NAMES:
        from . import api

        return getattr(api, name)
    raise AttributeError(
        f"module 'birda_tpu_torch' has no attribute '{name}'")


def __dir__():
    return sorted(list(globals()) + list(_API_NAMES))
