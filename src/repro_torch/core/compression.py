"""BDI compression levels the engine reads (``repro.core.compression``).

An extended-LLC block compresses to one of three levels (paper §4.3.1):
``HIGH`` (deltas fit int8, 32 B payload), ``LOW`` (int16, 64 B) or
``UNCOMP`` (128 B).
"""
HIGH, LOW, UNCOMP = 0, 1, 2
BLOCK_BYTES = 128
