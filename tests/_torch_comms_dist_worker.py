"""One rank of a 2-process gloo world for tests/test_torch_comms_dist.py.

    python tests/_torch_comms_dist_worker.py RANK WORLD PORT OUT_DIR

Bootstraps the port's process world (`bootstrap_multihost` over
torch.distributed, gloo on the CPU), runs the collectives, `knn_local`,
`kmeans_fit_local`, `kmeans_predict_local`, a health barrier and the
distributed IVF-PQ lifecycle (`ivf_pq_build_local` -> `ivf_pq_save_local`
-> `ivf_pq_extend_local` -> `ivf_pq_save_local` -> `ivf_pq_load`, a
search after each step; the checkpoints under OUT_DIR) on this process's
partition of seeded data, and writes its results to OUT_DIR/rank<RANK>.pt.
Every collective wait is bounded by the process group's timeout.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raft_tpu_torch.comms import Comms, bootstrap_multihost, mnmg, op_t, resilience  # noqa: E402
from raft_tpu_torch.comms.comms import P  # noqa: E402

N, D, NQ, K = 1003, 16, 37, 10
#: the IVF-PQ lifecycle: lists, PQ width, probes, and the new rows of the
#: extend (an even count: each process appends half)
PQ_LISTS, PQ_DIM, PQ_PROBES, N_NEW = 8, 8, 4, 200


def new_rows():
    """The seeded rows the extend appends."""
    return np.random.default_rng(12).standard_normal((N_NEW, D)).astype(np.float32)


def pq_params():
    from raft_tpu_torch.neighbors import ivf_pq

    return ivf_pq.IndexParams(n_lists=PQ_LISTS, pq_dim=PQ_DIM, kmeans_n_iters=5)


def pq_search(index, q):
    return mnmg.ivf_pq_search(index, q, K, n_probes=PQ_PROBES, engine="lut")


def dataset():
    """The seeded rows, queries and collective payloads both worlds use."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    xf = rng.integers(-5, 6, (2, 8)).astype(np.float32)
    xi = rng.integers(1, 6, (2, 8)).astype(np.int32)
    return x, q, xf, xi


def partition(x, world, rank):
    """Rank `rank`'s contiguous rows: the split the in-process world's
    `_shard_rows` makes (ceil(n / world) a rank)."""
    per = -(-x.shape[0] // world)
    return x[rank * per:(rank + 1) * per]


def collectives(ac, xf, xi):
    """The collectives both worlds run; every output leads with a rank axis."""
    f, i = xf[0], xi[0]
    sub = ac.comm_split([0, 1])
    pair = ac.comm_split([0, 0])
    outs = (
        ac.allreduce(f, op_t.SUM), ac.allreduce(f, op_t.MIN), ac.allreduce(f, op_t.MAX),
        ac.allreduce(i, op_t.PROD), ac.bcast(f, root=1), ac.reduce(f, root=1),
        ac.allgather(f).reshape(-1), ac.allgatherv(f.reshape(4, 2), [3, 4]).reshape(-1),
        ac.reducescatter(f, op_t.SUM), ac.reducescatter(f, op_t.MIN),
        ac.shift(f, 1), ac.device_sendrecv(f, [(0, 1), (1, 0)]),
        ac.device_sendrecv(f, [(1, 1)]),
        sub.allreduce(f), pair.allreduce(f), pair.allreduce(f, op_t.MAX),
        pair.allgather(f).reshape(-1), ac.barrier(),
        ac.allreduce(f, quantization="int8"),
    )
    return tuple(o[None] for o in outs)


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                  sys.argv[4])
    assert bootstrap_multihost(f"localhost:{port}", num_processes=world, process_id=rank,
                               device="cpu", timeout_s=60.0)
    assert bootstrap_multihost() is False  # idempotent
    comms = Comms()
    assert comms.process_world and comms.spans_processes() and comms.get_size() == world
    x, q, xf, xi = dataset()
    coll = comms.run(collectives, comms.shard_from_local(xf[rank:rank + 1]),
                     comms.shard_from_local(xi[rank:rank + 1]),
                     in_specs=(P("data"), P("data")), out_specs=(P("data"),) * 19)
    local = partition(x, world, rank)
    res = {"collectives": [c.clone() for c in coll]}
    res["knn"] = mnmg.knn_local(comms, local, q, K)
    res["knn_sharded"] = mnmg.knn_local(comms, local, q, K, query_mode="sharded")
    keep = np.random.default_rng(3).random(N) < 0.5
    res["knn_prefilter"] = mnmg.knn_local(comms, local, q, K, prefilter=keep)
    centers, inertia, n_iter = mnmg.kmeans_fit_local(comms, local, 6, max_iter=10, seed=0)
    res["kmeans"] = (centers, inertia, n_iter)
    res["labels"] = torch.from_numpy(mnmg.kmeans_predict_local(comms, local, centers))
    res["barrier_s"] = resilience.health_barrier(comms, timeout_s=30)
    idx = mnmg.ivf_pq_build_local(comms, pq_params(), local, seed=0)
    res["pq_built"] = pq_search(idx, q)
    mnmg.ivf_pq_save_local(os.path.join(out_dir, "pq_built.ckpt"), idx)
    idx = mnmg.ivf_pq_extend_local(idx, partition(new_rows(), world, rank))
    res["pq_extended"] = pq_search(idx, q)
    res["pq_n"] = idx.n
    mnmg.ivf_pq_save_local(os.path.join(out_dir, "pq_extended.ckpt"), idx)
    res["out_dir"] = out_dir
    res["pq_loaded"] = pq_search(mnmg.ivf_pq_load(comms, os.path.join(out_dir,
                                                                     "pq_extended.ckpt")), q)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
