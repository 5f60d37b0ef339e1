"""The flash backward's least time (``work/kernels.py``, one call a layer
and step) over its kernels' device time in the profiled steps, in %."""
from pbcore import readings as R


def read(rec):
    return R.train_flash_bwd_roofline(rec)
