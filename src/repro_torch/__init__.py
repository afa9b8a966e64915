"""PyTorch/CUDA port of the ParaGrapher WebGraph-loading system.

Beside the JAX package ``repro`` (the reference), sub-package by
sub-package under the same names.  Imports ``torch`` and ``numpy`` only.
Entry points that touch the device take ``device=None`` meaning the GPU
and raise when there is none; pass ``device="cpu"`` to run on the CPU.
"""
