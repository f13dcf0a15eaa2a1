"""95th percentile of the requests' latency over the window, in ms, the
profiled slice's groups left out: each request from its group's first
submit to its wave's result."""

import numpy as np


def read(rec):
    n, s = rec["latency"]["n"], rec["latency"]["s"]
    if n.size == 0 or n.sum() == 0:
        return None
    order = np.argsort(s, kind="stable")
    cum = np.cumsum(n[order])
    return 1e3 * float(s[order][np.searchsorted(cum, 0.95 * cum[-1])])
