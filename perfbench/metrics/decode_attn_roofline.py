"""The decode attention's least time (one call a layer and step, over the
valid keys) over its kernels' device time in the profiled batches, in %."""
from pbcore import readings as R


def read(rec):
    return R.serve_decode_roofline(rec)
