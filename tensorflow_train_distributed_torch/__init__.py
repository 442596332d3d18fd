"""PyTorch/CUDA port of ``tensorflow_train_distributed_tpu`` for an NVIDIA
H100 (Hopper, sm_90a).

Module names mirror the JAX package so each module's counterpart is easy
to find.  The port imports ``torch`` and never ``jax``, ``flax`` or the
JAX package.  Kernels the JAX package wrote in Pallas for the TPU are CUDA
C++ here (``csrc/``), built at first use; every kernel has a plain
PyTorch version beside it (``ops/kernels.py``).

Slice 1 ports the paged-KV serving path: ``serving.ServingEngine`` over
``models.llama.LlamaModel``, with the RMSNorm, paged-attention and
paged-KV-gather kernels.  This module imports nothing heavy.
"""
