"""The window's steps' model FLOPs (3 x the forward's matmuls and
attention, recomputation not counted) over the window's time at the f32
peak of 67 TFLOP/s, in %."""
from pbcore import readings as R


def read(rec):
    return R.train_mfu(rec)
