from .pipeline import PackedBatcher, SyntheticSource, make_pipeline, shard_batch

__all__ = ["PackedBatcher", "SyntheticSource", "make_pipeline", "shard_batch"]
