"""das_tpu_torch — the DAS serving path in PyTorch and CUDA for Hopper.

The PyTorch port of ``das_tpu``: the same modules, names and layouts, with
the TPU's Pallas kernels replaced by kernels written by hand for sm_90a.
It imports nothing of JAX or of ``das_tpu``.
"""

__version__ = '0.1.0'
