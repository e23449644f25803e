"""Child worker for the port's kill-and-resume drills
(tests/test_torch_jobs.py). It imports torch and the port only.

    python tests/_torch_job_crash_worker.py stream  --workdir D --data X.npy
                                            --kind K --index SEED.ckpt [--kill N]
    python tests/_torch_job_crash_worker.py datagen --workdir D --rows R --dim C
                                            --chunk H --seed S [--kill N]
    python tests/_torch_job_crash_worker.py scrub   --workdir D --kind K
                                            --index BUILT.ckpt [--kill N]

Runs one resumable operation on the CPU: a streaming index build
(`jobs.resumable_extend_from_file`, from a trained empty index the parent
saved), chunked dataset synthesis (`jobs.resumable_write_npy`), or a
cursor-checkpointed integrity walk (`jobs.resumable_scrub`, over a built
index the parent saved, with its last list rotted) — optionally under a
seeded FaultPlan whose kill_rank fault at ``job.stage.crash`` (or
``integrity.scrub.crash``) SIGKILLs THIS process on the count-th
checkpoint commit. The parent resumes the same operation on the same
scratch directory and holds the result to an uninterrupted run. A
separate process is the point: SIGKILL leaves no chance for in-process
cleanup to cheat.

Not a test module (underscore prefix keeps pytest away).
"""

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

#: the payload field the scrub drill rots, by kind
ROT_FIELD = {"ivf_flat": "list_data", "ivf_pq": "codes", "ivf_rabitq": "codes"}


def index_module(kind: str):
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, ivf_rabitq

    return {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq, "ivf_rabitq": ivf_rabitq}[kind]


def make_chunk(seed: int, dim: int):
    """The per-chunk generator both packages' drills share: deterministic
    in (lo, hi), so a resumed file is byte-identical."""
    def chunk(lo: int, hi: int) -> np.ndarray:
        rng = np.random.default_rng((seed, lo))
        return rng.random((hi - lo, dim), dtype=np.float32)

    return chunk


def rotted(kind: str, index, seed: int):
    """Rot half of the last list's payload (the list every resumed walk
    still has ahead); returns (field, list id)."""
    from raft_tpu_torch.integrity import scrub

    lid = int(index.n_lists) - 1
    scrub.rot_list(index, lid, ROT_FIELD[kind], frac=0.5, seed=seed)
    return ROT_FIELD[kind], lid


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("stream", "datagen", "scrub"))
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--data")
    ap.add_argument("--index")
    ap.add_argument("--kind", default="ivf_flat")
    ap.add_argument("--kill", type=int, default=0,
                    help="SIGKILL on the kill-th checkpoint commit")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rows", type=int, default=50)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--budget", type=int, default=4)
    ap.add_argument("--laps", type=int, default=2)
    args = ap.parse_args()

    from raft_tpu_torch import jobs
    from raft_tpu_torch.core import faults

    scratch = os.path.join(args.workdir, "scratch")
    os.makedirs(scratch, exist_ok=True)
    site = "integrity.scrub.crash" if args.mode == "scrub" else "job.stage.crash"
    cm = contextlib.nullcontext()
    if args.kill > 0:
        cm = faults.FaultPlan([faults.Fault(kind="kill_rank", site=site, count=args.kill)],
                              seed=args.seed).install()

    if args.mode == "stream":
        mod = index_module(args.kind)
        index = mod.load(args.index, device="cpu")
        with cm:
            index, stats = jobs.resumable_extend_from_file(
                args.kind, index, args.data, args.batch, scratch=scratch, checkpoint_every=1)
        mod.save(os.path.join(args.workdir, "out.ckpt"), index)
        print(json.dumps({"stats": stats}), flush=True)
        return
    if args.mode == "scrub":
        index = index_module(args.kind).load(args.index, device="cpu")
        rot = rotted(args.kind, index, args.seed)
        with cm:
            bad, stats = jobs.resumable_scrub(args.kind, index, scratch=scratch,
                                              budget_lists=args.budget, laps=args.laps)
        print(json.dumps({"rot": list(rot), "bad": [[f, int(lid)] for f, lid in bad],
                          **{k: int(v) for k, v in stats.items()}}), flush=True)
        return
    with cm:
        stats = jobs.resumable_write_npy(
            os.path.join(args.workdir, "data.npy"), args.rows, args.dim, args.chunk,
            make_chunk(args.seed, args.dim), scratch=scratch)
    print(json.dumps({"stats": stats}), flush=True)


if __name__ == "__main__":
    main()
