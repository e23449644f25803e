"""search_roofline_pct.ivfpq: the least time one IVF-PQ search batch with
its rerank needs (`roofline/ivf_pq_search.py`, from the cell's parameters
and shapes alone) as a share of the device's busy time a batch in the
traced window."""

from portbench.harness.readers import roofline_pct
from portbench.roofline import ivf_pq_search


def read(run):
    return roofline_pct(run, "ivf_pq", "search",
                        lambda cfg, mix: ivf_pq_search.work(cfg, mix["batch"])["seconds"])
