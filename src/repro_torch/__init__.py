"""PyTorch + CUDA port of the FlexNN reproduction (the JAX package
``repro`` is the reference it is held against).

Slice 1: sparse decode serving of a dense decoder LM — descriptor table
(``core``), weight-sparsity plan, the hand-written Hopper kernels behind
``kernels.ops``, the dense model family and the continuous-batching
``serve.engine.ServeEngine``.  Slice 2: int8 weight serving
(``quant``, ``quantize=True``) with the scaled block-sparse and int8 matmul
kernels.  Every entry point takes an explicit
``device`` that defaults to CUDA; the CPU runs only when asked for.
"""
