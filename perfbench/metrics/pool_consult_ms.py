"""Host ms a batch spends in the page pool's ``lookup_batch`` and
``write_page`` (one key a call), synchronised."""
from pbcore import readings as R


def read(rec):
    return R.ms_per_round(rec, 'pool.lookup', 'pool.write')
