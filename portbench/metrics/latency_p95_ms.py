"""latency_p95_ms: the 95th percentile, over every batch of the window, of
the time from the search call to its answers on the host (host clock;
numpy's linear interpolation between order statistics)."""

import numpy as np


def read(run):
    if run["mix"]["kind"] != "search":
        return None
    return float(np.percentile(np.asarray(run["latencies_s"]) * 1e3, 95))
