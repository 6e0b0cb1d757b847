"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Sources live in ``csrc/`` and are built at first use
(``kernels/build.py``)."""
