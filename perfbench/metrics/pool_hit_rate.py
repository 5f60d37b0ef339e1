"""Pages of the window's prompts the page pool held, over all it was asked
for, in %."""
from pbcore import readings as R


def read(rec):
    return R.pool_hit_rate(rec)
