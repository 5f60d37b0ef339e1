"""PyTorch/CUDA port of the Morpheus simulator (the JAX package ``repro``
stays the reference).

The layout mirrors ``repro``: ``repro_torch.core.engine`` is the
counterpart of ``repro.core.engine``, and so on.  Entry points run on the
CUDA card by default and raise ``core.engine.BackendError`` without one,
unless the caller passes ``device="cpu"``, which runs each kernel's plain
PyTorch version.  The package imports neither ``jax`` nor ``repro``.

Dtype convention (shared by every module and the CUDA kernels): tags,
LRU counters and Bloom-filter words are int32 tensors that hold the
uint32 bit pattern.  The kernels read them as ``uint32_t``; the plain
path does its unsigned arithmetic through ``repro_torch._u32``.
"""
