"""Host ms of ``LM.prefill`` a batch, synchronised."""
from pbcore import readings as R


def read(rec):
    return R.ms_per_round(rec, 'prefill')
