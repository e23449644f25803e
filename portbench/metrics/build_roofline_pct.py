"""build_roofline_pct: the least time one IVF-PQ build needs
(`roofline/ivf_pq_build.py`, from the configuration's parameters and
shapes alone) as a share of the device's busy time a build in the traced
window."""

from portbench.harness.readers import roofline_pct
from portbench.roofline import ivf_pq_build


def read(run):
    return roofline_pct(run, "ivf_pq", "build",
                        lambda cfg, mix: ivf_pq_build.work(cfg)["seconds"])
