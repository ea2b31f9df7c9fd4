"""Hand-written CUDA kernels for the port, each beside its plain PyTorch twin.

  * ``qmatmul``         — fused practical RHT + dequant GEMM (Alg. 5 + 3).
  * ``paged_attention`` — flash-decode over the serving engine's block arena.

Every ``ops.py`` wrapper launches its kernel for CUDA tensors and runs the
plain version for CPU tensors; ``_build`` compiles the sources in
``csrc/`` with nvcc at first use.
"""
