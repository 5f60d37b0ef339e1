"""PyTorch/CUDA port of the Morpheus simulator, its serving page pool,
its serving engine, its online runtime and its training stack (the JAX
package ``repro`` stays the reference).

The layout mirrors ``repro``: ``repro_torch.core.engine`` is the
counterpart of ``repro.core.engine``, and so on.  Ported so far: the
simulator's main path (``core``, ``workloads``), the serving page pool
and engine (``serving``), the LM over every architecture (``models``,
``configs``), the online runtime, fleet and admission (``runtime``)
with its observability layer (``obs``), the autotuner (``autotune``),
training (``data``, ``optim``, ``checkpoint``, ``distributed``,
``train``, over the reference-shaped trees of ``pytree``), the two
launchers (``launch``), and every Pallas kernel of the reference as a
hand-written CUDA kernel (``kernels``: the engine scans, the pool's four
mechanism kernels, flash attention and flash-decoding), plus the flash
kernel's backward, which the reference leaves to XLA's autodiff.  Entry
points run on the CUDA card by default and raise ``core.engine.BackendError`` without one, unless the
caller passes ``device="cpu"``, which runs each kernel's plain PyTorch
version.  The package imports neither ``jax`` nor ``repro``.

Dtype convention of the simulator and the pool (shared by their modules
and CUDA kernels): tags, LRU counters and Bloom-filter words are int32
tensors that hold the uint32 bit pattern.  The kernels read them as
``uint32_t``; the plain path does its unsigned arithmetic through
``repro_torch._u32``.  The models run in the config's ``param_dtype``
(float32 or bfloat16).
"""
