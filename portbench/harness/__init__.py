"""The general parts of the benchmark: the manifest, the data and traffic
generators, the measured window, the trace reduction, the correctness
check and the import guard. Nothing here names a configuration, a mix or
a per-layer metric."""
