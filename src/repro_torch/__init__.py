"""repro_torch — the PyTorch/CUDA port of the DPA-Store reproduction.

A second package beside the JAX package ``repro``, laid out like it
(``core/…``, ``kernels/…``).  Plain tensor code is PyTorch; the TPU kernels
of ``repro/kernels`` become hand-written CUDA kernels for Hopper
(``csrc/*.cu``), each with a plain-torch version beside it.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
