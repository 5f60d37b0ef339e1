"""A batch's counted FLOPs (prefill and every decode step) over its wall
time (``Engine.run``, the pool's consultation included) at the f32 peak,
in %."""
from pbcore import readings as R


def read(rec):
    return R.round_mfu(rec)
