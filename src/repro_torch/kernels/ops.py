"""The port's kernels under the names of the reference's
``repro.kernels.ops``: the serving pool's ``tag_lookup``,
``bloom_query``, ``bdi_compress``, ``bdi_decompress``, ``gather_blocks``
and the fused ``cached_block_read``, with the pool's batched
``lookup_fill`` and ``bloom_record``, its ``page_write`` and its two-tier
``read_rows`` (all in ``kernels/pool.py``), and the two attention
kernels ``decode_attention`` (with ``decode_attention_with_lse`` and
``combine_decode`` for a sequence-sharded cache) and ``flash_attention``
(``kernels/attention.py``), each with its launch counts in its module.

Each takes its device from its tensors, as ``engine_scan`` does: CUDA
tensors launch the hand-written kernel of ``csrc/pool.cu`` or
``csrc/attention.cu`` or raise, CPU tensors run the plain PyTorch
version.  The reference's ``interpret`` and ``t_block`` arguments select
a Pallas mode and tile and have no counterpart.
"""
from .attention import (combine_decode, decode_attention,  # noqa: F401
                        decode_attention_with_lse, flash_attention)
from .pool import (bdi_compress, bdi_decompress, bloom_query,  # noqa: F401
                   bloom_record, cached_block_read, gather_blocks,
                   lookup_fill, page_write, read_rows, tag_lookup)
