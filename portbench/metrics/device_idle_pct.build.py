"""device_idle_pct.build: the share, in %, of the traced window of a build
mix in which no kernel, copy or set ran on the device (torch.profiler's
trace)."""

from portbench.harness.readers import idle_pct


def read(run):
    return idle_pct(run, "build")
