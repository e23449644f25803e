"""qps: every query answered in the window, with its ids and distances on
the host, over the window's seconds (host clock)."""


def read(run):
    if run["mix"]["kind"] != "search":
        return None
    return run["queries"] / run["window_s"]
