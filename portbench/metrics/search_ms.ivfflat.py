"""search_ms.ivfflat: the device's busy time, in ms, of one `search` call of the
ivf_flat system's batches in the traced window: the union of the kernels,
copies and sets that the call launched, read from the profiler's trace;
the host's gaps inside the call are not in it."""

from portbench.harness.readers import range_busy_ms


def read(run):
    return range_busy_ms(run, "ivf_flat", "search")
