"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version (``ref.py``) and ctypes wrapper; sources under ``csrc/``."""
