"""Run one cell of the port's benchmark on the cards of this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON: correct, attempted, failed, metrics, device, [breakdown],
checks); the last lines of standard error are the numbers compared, each
beside its limit. Exits 2, printing no result, where the machine lacks
the cards the cell asks for or the checkout lacks the port, and 3 where a
forbidden module (JAX, the JAX package) was loaded by the end of the run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: every build and kernel cache of the program, at fixed paths in the checkout
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
             "CUDA_CACHE_PATH": "nv_compute_cache"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(ROOT / "raft_tpu_torch" / "_build" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness.cell import guard_failures, run_cell
    from portbench.harness.manifest import Manifest

    manifest = Manifest()
    cell = manifest.cell(args.workload)
    if importlib.util.find_spec("raft_tpu_torch") is None:
        print("the checkout holds no raft_tpu_torch: nothing to measure", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    found = guard_failures()
    if found:
        print("forbidden imports at the end of the run: " + "; ".join(found), file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
