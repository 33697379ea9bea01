"""PyTorch/CUDA port of specpride-tpu: binned-mean consensus spectra on an
NVIDIA GPU, with hand-written CUDA kernels in ``ops/csrc``.

The JAX package ``specpride_tpu`` is the reference; this package imports
neither it nor JAX.
"""

__version__ = "0.1.0"
