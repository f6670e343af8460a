"""PyTorch port of the SSD write-amplification system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/<name>/``) and runs on an NVIDIA GPU, with the JAX
package's TPU kernels rewritten as hand-written CUDA kernels. Entry points
take ``device=`` (default ``"cuda"``); pass ``"cpu"`` to run the kernels'
plain PyTorch versions instead.
"""
