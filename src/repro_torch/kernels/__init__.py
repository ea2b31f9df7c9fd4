"""Hand-written CUDA kernels for the port, each beside its plain PyTorch twin.

  * ``qmatmul``         — dequant GEMMs: fused practical RHT + GEMM (Alg. 5
    + 3) and the unfused GEMM on an already-rotated X.
  * ``hadamard``        — practical randomized Hadamard transform (Alg. 5).
  * ``rabitq_quant``    — RaBitQ code search + least-squares rescale.
  * ``paged_attention`` — flash-decode over the serving engine's block arena.

Every ``ops.py`` wrapper launches its kernel for CUDA tensors and runs the
plain version for CPU tensors; ``_build`` compiles the sources in
``csrc/`` with nvcc at first use.
"""
