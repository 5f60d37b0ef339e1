"""Median ms a request of the window waited between its arrival and the
start of its batch."""
from pbcore import readings as R


def read(rec):
    return R.queue_wait_ms(rec)
