"""95th percentile over every request that arrived in the window of the
time from its arrival to its first token on the host, in ms (a request
still unserved when the server gives up counts the time it waited)."""
import numpy as np


def read(rec):
    if not rec["ttft_s"]:
        return None
    return 1e3 * float(np.percentile(rec["ttft_s"], 95))
