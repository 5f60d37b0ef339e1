"""Generated tokens of every batch started in the window over the time from
the window's opening to the end of the last of them."""


def read(rec):
    return rec["tokens"] / rec["elapsed_s"] if rec["tokens"] else None
