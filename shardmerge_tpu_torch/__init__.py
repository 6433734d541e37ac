"""shardmerge_tpu_torch — the PyTorch / CUDA port of shardmerge_tpu.

Same module layout as the JAX package (``shardmerge_tpu/``), which stays the
numerical reference. This package imports torch and numpy only; its one
hand-written CUDA kernel (the int4 GEMV, ``csrc/int4_gemv.cu``) is built with
``nvcc`` for sm_90a at first use.

Covered so far: the fourier ``merge`` of base + 1 or 2 finetunes and int4
``generate`` for the Llama family (``python -m shardmerge_tpu_torch``).
"""

__version__ = "0.1.0"
