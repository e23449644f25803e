"""build_rows_per_s: the rows of the builds completed in the window, over
the time from the window's start to the last completion (host clock)."""


def read(run):
    if run["mix"]["kind"] != "build":
        return None
    return run["builds"] * run["rows"] / run["window_s"]
