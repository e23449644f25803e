"""The n_probes sweep of a configuration, on the card: recall@k of the
port's search path against the exact neighbours at each n_probes, for
each stand-in data spread and seed given (the seed draws the table, its
queries and the build). Not part of a benchmark run.

    python3 portbench/tools/sweep.py --config deep10m-ivfpq --seeds 1 2 \
        --spreads 1.25 1.5 --probes 1 2 4 8 16 32 64 [--out sweep.json]

Each line it prints is one (spread, seed, n_probes) point: recall, the
widest distance gap (`harness.check`), and the ms a batch (host clock,
fenced, the mean of three passes over the query set); the build's
seconds once a (spread, seed).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--spreads", type=float, nargs="+", required=True)
    p.add_argument("--probes", type=int, nargs="+", required=True)
    p.add_argument("--batch", type=int, default=1000)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from portbench.harness import check, data, traffic
    from portbench.harness.cell import mark
    from portbench.harness.manifest import BENCH_DIR, load_module
    from portbench.reference.exact_knn import exact_knn

    base_cfg = json.loads((BENCH_DIR / "configs" / f"{args.config}.json").read_text())
    system_mod = load_module(BENCH_DIR / "systems" / f"{base_cfg['system']}.py", "sweep_system")
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    k, nq = int(base_cfg["dataset"]["k"]), int(base_cfg["dataset"]["queries"])
    mix = {"kind": "search", "loop": "closed", "clients": 1, "batch": args.batch}
    points = []
    for spread in args.spreads:
        for seed in args.seeds:
            cfg = copy.deepcopy(base_cfg)
            cfg["generator"]["center_half_width"] = spread
            system = system_mod.System(cfg, dev)
            system.prepare()
            rows, queries = data.make_inputs(cfg, seed, dev, rows_seed=seed, queries_seed=seed)
            sync()
            t0 = time.perf_counter()
            system.build(rows, seed, mark)
            sync()
            build_s = time.perf_counter() - t0
            positions = traffic.query_batches(mix, nq)
            qs = [queries[q.to(dev)].contiguous() for q in positions]
            answers_by_p = {}
            for probes in args.probes:
                system.search_params.n_probes = probes
                for q in qs[:2]:
                    system.search(q, mark)
                sync()
                t1 = time.perf_counter()
                for _ in range(3):
                    answers = [(pos, *[t.cpu() for t in system.search(q, mark)])
                               for pos, q in zip(positions, qs)]
                batch_ms = (time.perf_counter() - t1) * 1e3 / (3 * len(qs))
                answers_by_p[probes] = (answers, batch_ms)
            system.free()
            truth_d, truth_i = exact_knn(rows, queries, k)
            for probes, (answers, batch_ms) in answers_by_p.items():
                nums = check.judge_answers(rows, queries, answers, k, truth_d, truth_i)
                pt = {"spread": spread, "seed": seed, "n_probes": probes, "build_s": build_s,
                      "batch_ms": batch_ms, **nums}
                points.append(pt)
                print(json.dumps(pt), flush=True)
            del rows, queries, truth_d, truth_i, answers_by_p
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"config": args.config, "batch": args.batch,
                                              "card": torch.cuda.get_device_name(dev),
                                              "points": points}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
