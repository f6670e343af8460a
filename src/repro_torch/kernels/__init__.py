"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each ``<name>/`` holds ``ref.py`` (plain versions: the CPU path and the
oracle), ``kernel.py`` (the ctypes binding of the CUDA kernel, with its
launch count) and ``ops.py`` (dispatch on the tensors' device).
"""
