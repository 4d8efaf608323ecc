"""convsep_tpu_torch: the convsep separation system in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Module for module it mirrors ``convsep_tpu`` (the JAX reference, which
stays unchanged beside it) and keeps its layouts at public functions:
NHWC ``(B, T, F, C)`` model input, source-major ``(B, S, T, F)`` model
output, HWIO conv kernels. It never imports JAX.
"""

__version__ = "0.1.0"
