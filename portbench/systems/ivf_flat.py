"""The port's IVF-Flat entry points as a cell drives them.

Build: `ivf_flat.build(IndexParams, rows, seed=)`. Search:
`ivf_flat.search` with `engine` as the configuration gives it ("auto":
the port's dispatch under its committed table) at `n_probes`, straight
to the k best. Each call runs inside the harness's `mark` of its name.
"""

from __future__ import annotations

import torch

from portbench.harness.manifest import read_keys

INDEX_KEYS = ("n_lists", "kmeans_n_iters", "kmeans_trainset_fraction", "build_seed")
SEARCH_KEYS = ("n_probes", "engine")


class System:
    def __init__(self, config: dict, device):
        from raft_tpu_torch.neighbors import ivf_flat

        self.device = torch.device(device)
        ix = read_keys(config, "index", INDEX_KEYS)
        se = read_keys(config, "search", SEARCH_KEYS)
        self.params = ivf_flat.IndexParams(
            n_lists=int(ix["n_lists"]), kmeans_n_iters=int(ix["kmeans_n_iters"]),
            kmeans_trainset_fraction=float(ix["kmeans_trainset_fraction"]),
            metric=config["dataset"]["metric"])
        self.search_params = ivf_flat.SearchParams(n_probes=int(se["n_probes"]),
                                                   engine=se["engine"])
        self.k = int(config["dataset"]["k"])
        self.index = None

    def prepare(self) -> None:
        """Build every kernel library of the port (once a checkout)."""
        if self.device.type == "cuda":
            from raft_tpu_torch.ops import _build

            _build.build_all()

    def build(self, rows, seed: int, mark) -> None:
        from raft_tpu_torch.neighbors import ivf_flat

        self.index = None
        with mark("build"):
            self.index = ivf_flat.build(self.params, rows, seed=int(seed) % (1 << 63),
                                        device=self.device)

    def search(self, queries, mark):
        from raft_tpu_torch.neighbors import ivf_flat

        with mark("search"):
            return ivf_flat.search(self.search_params, self.index, queries, self.k)

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
                for f in ("list_data", "slot_rows")]

    def counters(self) -> dict:
        from raft_tpu_torch.ops.fused_scan import launch_counts

        return launch_counts()

    def free(self) -> None:
        self.index = None
