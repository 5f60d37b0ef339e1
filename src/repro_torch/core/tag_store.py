"""Tag-store constants the engine reads (``repro.core.tag_store``).

LRU semantics follow paper Algorithm 1 lines 8-12: on an access the way's
counter is reset to ``LRU_MAX``, every other way's counter is decremented
(saturating at 0), and the replacement victim is the way with the least
counter, invalid ways first.  The transition itself lives in
``core.controller``.
"""
LRU_MAX = 0xFFF  # paper Algorithm 1 line 9
