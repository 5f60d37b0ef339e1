"""Seconds from the process's start to the window's opening: imports, the
kernels' load (their build on a checkout's first run), the weights drawn
on the card, the warm-up (and a training cell's checked steps)."""


def read(rec):
    return rec["setup_s"]
