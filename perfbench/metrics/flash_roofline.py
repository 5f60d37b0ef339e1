"""The flash forward's least time (``work/kernels.py``) over its kernels'
device time in the profiled batches or steps, in %: a serving batch one
call a layer for its prefill, a training step each launch one layer's
call (recomputation included)."""
from pbcore import readings as R


def read(rec):
    if rec["kind"] == "train":
        return R.train_flash_roofline(rec)
    return R.serve_flash_roofline(rec)
