"""The two readings of each number `correct` compares, on the card, at a
cell's own size and load. Not part of a benchmark run.

    python3 portbench/tools/calibrate.py --workload deep10m-ivfpq.batch10k \
        --program-seeds 11 12 ... --control-seeds 31 32 33 --seconds 3 \
        [--out readings.json]

For each program seed: a table and queries both drawn from the seed (so
the readings span tables as well as query sets), the index built, a window of `--seconds` of the cell's mix (every batch at least
once), and the numbers of `harness.check` over all its answers. For each
control seed: the same inputs answered by the control
(`reference.control`: the exact neighbours of the fp8-rounded vectors) in
the program's place, batch by batch as the mix sends them, judged alike.
Prints one line a seed and the summary: the largest program reading and
the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from portbench.harness import check, data, traffic
    from portbench.harness.cell import mark, search_window
    from portbench.harness.manifest import Manifest
    from portbench.reference.control import control_knn
    from portbench.reference.exact_knn import exact_knn

    cell = Manifest().cell(args.workload)
    cfg = cell.config
    mix = dict(cell.mix, kind="search", batch=cell.mix.get("batch", cell.mix.get("check_batch")))
    dev = torch.device("cuda")
    k, nq = int(cfg["dataset"]["k"]), int(cfg["dataset"]["queries"])
    readings = {"program": [], "control": []}

    def judged(side, seed, rows, queries, answers, t0):
        truth_d, truth_i = exact_knn(rows, queries, k)
        nums = check.judge_answers(rows, queries, answers, k, truth_d, truth_i)
        row = {"seed": seed, "answers": sum(int(a[0].shape[0]) for a in answers),
               "seconds": time.perf_counter() - t0, **nums}
        readings[side].append(row)
        print(json.dumps({"side": side, **row}), flush=True)

    for seed in args.program_seeds:
        t0 = time.perf_counter()
        system = cell.system.System(cfg, dev)
        system.prepare()
        rows, queries = data.make_inputs(cfg, seed, dev, rows_seed=seed, queries_seed=seed)
        system.build(rows, int(cfg["index"]["build_seed"]), mark)
        positions = traffic.query_batches(mix, nq)
        qs = [queries[q.to(dev)].contiguous() for q in positions]
        rec = search_window(system, qs, positions, args.seconds)
        while rec["batches"] < len(qs):   # every batch at least once
            rec = search_window(system, qs, positions, args.seconds)
        system.free()
        del system, qs
        torch.cuda.empty_cache()
        judged("program", seed, rows, queries, rec["answers"], t0)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        rows, queries = data.make_inputs(cfg, seed, dev, rows_seed=seed, queries_seed=seed)
        d, i = control_knn(rows, queries, k)
        positions = traffic.query_batches(mix, nq)
        answers = [(pos, d[pos.to(dev)].cpu(), i[pos.to(dev)].cpu()) for pos in positions]
        judged("control", seed, rows, queries, answers, t0)
    summary = {}
    for name, need in check.NEED.items():
        prog = [r[name] for r in readings["program"] if name in r]
        ctrl = [r[name] for r in readings["control"] if name in r]
        if prog or ctrl:
            worst = min if need == ">=" else max
            best = max if need == ">=" else min
            summary[name] = {"need": need, "program_worst": worst(prog) if prog else None,
                             "control_best": best(ctrl) if ctrl else None}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload,
                                              "card": torch.cuda.get_device_name(dev),
                                              "readings": readings, "summary": summary},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
