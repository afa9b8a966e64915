"""Hand-written Hopper kernels, one sub-package each: the CUDA source
lives under ``repro_torch/csrc/``, ``ops.py`` holds the checked wrapper
(with its launch counter) and ``ref.py`` the plain PyTorch version the
CPU tests and the on-card comparison use."""
