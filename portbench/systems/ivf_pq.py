"""The port's IVF-PQ entry points as a cell drives them.

Build: `ivf_pq.build(IndexParams, rows, seed=)`. Search: `ivf_pq.search`
at the default `SearchParams` but for `n_probes`, for a shortlist of
`shortlist` candidates, re-ranked by `refine.refine` at the
configuration's `refine_strategy` ("auto": refine's own dispatch) to the
k best. Each call runs inside the harness's `mark` of its name ("build",
"search", "refine").
"""

from __future__ import annotations

import torch

from portbench.harness.manifest import read_keys

INDEX_KEYS = ("n_lists", "pq_dim", "pq_bits", "kmeans_n_iters", "kmeans_trainset_fraction",
              "codebook_kind", "build_seed")
SEARCH_KEYS = ("n_probes", "shortlist", "refine_strategy")


class System:
    def __init__(self, config: dict, device):
        from raft_tpu_torch.neighbors import ivf_pq

        self.device = torch.device(device)
        ix = read_keys(config, "index", INDEX_KEYS)
        se = read_keys(config, "search", SEARCH_KEYS)
        self.params = ivf_pq.IndexParams(
            n_lists=int(ix["n_lists"]), pq_dim=int(ix["pq_dim"]), pq_bits=int(ix["pq_bits"]),
            kmeans_n_iters=int(ix["kmeans_n_iters"]),
            kmeans_trainset_fraction=float(ix["kmeans_trainset_fraction"]),
            codebook_kind=ix["codebook_kind"], metric=config["dataset"]["metric"])
        self.search_params = ivf_pq.SearchParams(n_probes=int(se["n_probes"]))
        self.shortlist = int(se["shortlist"])
        self.refine_strategy = se["refine_strategy"]
        self.k = int(config["dataset"]["k"])
        self.index = None
        self.rows = None

    def prepare(self) -> None:
        """Build every kernel library of the port (once a checkout)."""
        if self.device.type == "cuda":
            from raft_tpu_torch.ops import _build

            _build.build_all()

    def build(self, rows, seed: int, mark) -> None:
        from raft_tpu_torch.neighbors import ivf_pq

        self.index = None
        with mark("build"):
            self.index = ivf_pq.build(self.params, rows, seed=int(seed) % (1 << 63),
                                      device=self.device)
        self.rows = rows

    def search(self, queries, mark):
        from raft_tpu_torch.neighbors import ivf_pq
        from raft_tpu_torch.neighbors.refine import refine

        with mark("search"):
            _, cand = ivf_pq.search(self.search_params, self.index, queries, self.shortlist)
        with mark("refine"):
            return refine(self.rows, queries, cand, self.k, strategy=self.refine_strategy,
                          device=self.device)

    def index_ids(self) -> torch.Tensor:
        """The id of every filled slot of the index's lists."""
        rows = self.index.slot_rows
        return self.index.source_ids[rows[rows >= 0].long()]

    def list_digests(self) -> list:
        """[(field, its table on the host, the integrity sidecar's digest of
        each list row)] for the list fields of the index; None where the
        index carries no digest of the field."""
        held = self.index.list_digests or {}
        return [(f, getattr(self.index, f).cpu().numpy(), held.get(f))
                for f in ("codes", "slot_rows")]

    def counters(self) -> dict:
        from raft_tpu_torch.ops.fused_scan import launch_counts

        return launch_counts()

    def free(self) -> None:
        self.index = None
