"""search_roofline_pct.ivfflat: the least time one IVF-Flat search batch
needs (`roofline/ivf_flat_search.py`, from the cell's parameters and
shapes alone) as a share of the device's busy time a batch in the traced
window."""

from portbench.harness.readers import roofline_pct
from portbench.roofline import ivf_flat_search


def read(run):
    return roofline_pct(run, "ivf_flat", "search",
                        lambda cfg, mix: ivf_flat_search.work(cfg, mix["batch"])["seconds"])
