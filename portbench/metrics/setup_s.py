"""setup_s: from the process's start to the window's start (host clock):
imports, the kernels' build where none is built yet, the rows and queries
made from the seed, the index built, every shape of the window warmed."""


def read(run):
    return run["setup_s"]
