"""Hand-written CUDA kernels of the DSP path (wrappers + plain versions)."""
