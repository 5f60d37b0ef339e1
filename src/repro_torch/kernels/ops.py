"""The serving pool's kernels under the names of the reference's
``repro.kernels.ops``: ``tag_lookup``, ``bloom_query``, ``bdi_compress``,
``bdi_decompress``, ``gather_blocks`` and the fused ``cached_block_read``
(all in ``kernels/pool.py``, with their launch counts).

Each takes its device from its tensors, as ``engine_scan`` does: CUDA
tensors launch the hand-written kernel of ``csrc/pool.cu`` or raise, CPU
tensors run the plain PyTorch version.  The reference's two attention
wrappers have no counterpart yet (they come with the model substrates).
"""
from .pool import (bdi_compress, bdi_decompress, bloom_query,  # noqa: F401
                   cached_block_read, gather_blocks, tag_lookup)
