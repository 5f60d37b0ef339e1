"""The prefill's counted FLOPs (``work/flops.py``) over its synchronised
time at the f32 peak of 67 TFLOP/s, in %."""
from pbcore import readings as R


def read(rec):
    return R.prefill_mfu(rec)
