"""birda_tpu_torch — the PyTorch/CUDA port of birda_tpu.

The same analyze pipeline as ``birda_tpu`` (whose host layers it imports
as they are), with the device path in PyTorch and the TPU's Pallas kernels
rewritten by hand in CUDA C++ for Hopper (``csrc/``). It imports no jax.
"""

__version__ = "0.1.0"
