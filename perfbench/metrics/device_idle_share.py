"""Share of the profiled batches' or steps' window in which no kernel or
copy ran on the card, in %."""
from pbcore import readings as R


def read(rec):
    return R.idle_share(rec)
