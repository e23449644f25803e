"""The benchmark of `raft_tpu_torch`, the PyTorch and CUDA port, on NVIDIA cards.

One command runs one cell of `BENCHMARK.json` (at the checkout's root):

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the configuration's file under
`configs/`, the traffic mix under `traffic/`, the caller of the port's
entry points under `systems/` (named by the configuration's "system"),
each per-layer metric's reader under `metrics/`, the work counts of the
rooflines under `roofline/`, and the plain reference under `reference/`.
Nothing here imports `jax`, `jaxlib` or `raft_tpu`; `reference/` imports
nothing of `raft_tpu_torch` either.
"""
