"""Host ms of one ``LM.decode_step``, synchronised, over every step of the
window."""
from pbcore import readings as R


def read(rec):
    return R.span_ms_per_call(rec, 'decode_step')
