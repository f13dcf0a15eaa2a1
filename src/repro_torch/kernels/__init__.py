"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc``),
their ctypes wrappers and plain-torch versions, and the ``ops`` dispatch
layer.  Nothing is built or loaded at import time."""
