"""IVF-Flat: inverted-file index over raw vectors (counterpart of
raft_tpu/neighbors/ivf_flat.py), and the list-packing helpers that the
IVF-PQ and IVF-RaBitQ indexes share.

An IVF index keeps each list in a padded slot table: (n_lists, max_list,
...) payload plus (n_lists, max_list) source-row positions, -1 on empty
slots. IVF-Flat's payload is the vectors themselves (`list_data`).

Build: balanced k-means on a trainset drawn without replacement (the
hierarchical trainer past 1024 lists), then
`extend`, which labels only the new rows and scatters them into grown
tables (`adaptive_centers` moves the centers to the running mean).

Search, engines:

  "query"   query-major: per block of queries, gather the probed lists,
            score with one batched f32 product, select exactly. The JAX
            package maps blocks of 8 queries; the port blocks the queries
            by memory (`QUERY_BLOCK_ELEMS` gathered values a block), and
            the exact select makes the answer independent of the block;
  "list"    list-major: the probe pairs invert to per-list chunks
            (probe_invert), each list's vectors score against its chunk's
            queries, an exact per-row trim and merge (`score_and_select`);
  "fused"   (alias "pallas") list-major with the `fused_list_topk` kernel
            over a bf16 residual store (v - center, zero at pad slots,
            beside its f32 norms), exact in-kernel top-k a row; k <= 256.
            The first such search pads the store to the kernels' lane
            multiple in place, for good; the fit is checked first, so a
            rejected request leaves the index as it was;
  "auto"    `resolve_auto_engine`: the tuned `flat_auto_engine` (CUDA
            only, core/tuned.py; "fused" where the kernel fits the index
            and k), else "list" when nq * n_probes / n_lists >= 4, else
            "query", as the JAX package decides without a tuned value.

Adaptive probing (`adaptive`, `recall_target`, `budget_tau`;
neighbors/probe_budget) plans one (nq, n_probes) keep mask a batch; the
"query" engine masks the dropped probes' slots, the list-major engines
drop their pairs before the inversion. `list_radii` (each list's largest
member distance to its centroid) bound the scan for L2 metrics: zero at
build, raised by every `extend`, computed from the store for an index
carried across (`index_from_arrays`), and None once `adaptive_centers`
moves the centers (budgets only).

A `prefilter` (a `core.bitset.Bitset` or boolean mask over the index's
ids) is one view of the slot table, which every engine masks to the
worst value before any selection. So are the `tombstones` of live
mutation (neighbors/mutation), applied before the prefilter.

`save` / `load` write and read the JAX package's container (kind
"ivf_flat", writer version 4; core/serialize), so a file written by
either package loads in the other. The integrity sidecar
(`list_digests`, `table_digests`; raft_tpu_torch/integrity) is attached
at build, refreshed by `extend` and every mutation, saved and loaded with
the index; the lane pad of the fused engine extends the stored digests
over the pad bytes (`_pad_store_to_lanes`). With obs enabled, build,
extend and search each land a span, the search charging its analytic
cost (`obs.perf.ivf_flat_scan`; the fused engine at the bf16 rate) and
an adaptive batch its scanned lists (`probe_budget.account`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core import tuned
from raft_tpu_torch.core.config import auto_convert_output, resolve_device, strict_f32_matmul
from raft_tpu_torch.core.resources import accepts_resources
from raft_tpu_torch.core.validation import check_matrix
from raft_tpu_torch.distance.distance_types import DistanceType, resolve_metric
from raft_tpu_torch.matrix.select_k import _select_k_impl
from raft_tpu_torch.neighbors import probe_budget
from raft_tpu_torch.random.rng import make_generator, sample_without_replacement

#: gathered list values a block of the "query" engine holds
QUERY_BLOCK_ELEMS = 1 << 27
#: list-major engines' queries a call (the JAX package's macro batch)
MACRO_BATCH = 4096


@dataclasses.dataclass
class IndexParams:
    """Mirrors ivf_flat::index_params (ivf_flat_types.hpp:44-70)."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    metric_arg: float = 2.0
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    adaptive_centers: bool = False
    add_data_on_build: bool = True

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)


@dataclasses.dataclass
class SearchParams:
    """Mirrors ivf_flat::search_params (ivf_flat_types.hpp:125). `engine`:
    "query", "list", "fused"/"pallas" or "auto" (module docstring).
    `adaptive`, `recall_target` and `budget_tau` ask for adaptive probing
    (`recall_target` >= 1.0 is the fixed search bit for bit);
    `min_probes` floors each query's budget and `early_term` allows the
    radius bounds."""

    n_probes: int = 20
    engine: str = "query"
    adaptive: bool = False
    recall_target: Optional[float] = None
    budget_tau: Optional[float] = None
    min_probes: int = 1
    early_term: bool = True


class Index:
    """IVF-Flat index (tensors on one device).

    centers    (n_lists, dim) f32 coarse centroids
    list_data  (n_lists, max_list, dim) f32 vectors in list-major slots
    slot_rows  (n_lists, max_list) int32 slot -> source_ids position, -1 pad
    list_sizes (n_lists,) int32; source_ids (n_rows,) int32 caller ids
    list_radii (n_lists,) f32 largest member distance to its centroid, or
               None (adaptive probing then keeps budgets only)
    tombstones (n_lists, max_list) bool dead-slot mask of live mutation,
               or None (all live); mut_cursor, the applied mutation-log
               entries at the last checkpoint commit; append_slack, the
               per-list tail slots the mutator reserves
    list_digests, table_digests  the integrity sidecar (integrity/digest):
               {list field: (n_lists,) uint32}, {table field: int}, or
               None (no sidecar)

    The fused engine's store is derived at its first search
    (`_pad_store_to_lanes`): resid_bf16 (n_lists, L, dim) bf16 residuals,
    resid_norm (n_lists, L) f32 their squared norms, L the lane-padded
    max_list, and fused_kb, the candidate-buffer width, grown
    monotonically."""

    def __init__(self, params: IndexParams, centers, list_data, slot_rows, list_sizes,
                 source_ids):
        self.params = params
        self.centers = centers
        self.list_data = list_data
        self.slot_rows = slot_rows
        self.list_sizes = list_sizes
        self.source_ids = source_ids
        self.resid_bf16 = None
        self.resid_norm = None
        self.fused_kb = None
        self.list_radii = None
        self.tombstones = None
        self.mut_cursor = 0
        self.append_slack = 0
        self.list_digests = None
        self.table_digests = None
        self._id_bound = None

    @property
    def n_tombstones(self) -> int:
        """Dead slots (0 when all live)."""
        if self.tombstones is None:
            return 0
        return int(torch.as_tensor(self.tombstones).bool().sum())

    @property
    def id_bound(self) -> int:
        """One past the largest source id: the id space a `prefilter`
        covers (past `size` when extend was given custom ids). Read from
        the device once an index (extend returns a new one), so searches
        after the first wait on no device value."""
        if self._id_bound is None:
            self._id_bound = int(self.source_ids.max()) + 1 if self.size else 0
        return self._id_bound

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def metric(self) -> DistanceType:
        return self.params.metric

    @property
    def n_lists(self) -> int:
        return int(self.centers.shape[0])

    @property
    def dim(self) -> int:
        return int(self.centers.shape[1])

    @property
    def size(self) -> int:
        return int(self.source_ids.shape[0])

    @property
    def adaptive_centers(self) -> bool:
        return self.params.adaptive_centers

    @property
    def dataset(self) -> torch.Tensor:
        """The stored vectors as a flat (n, dim) table in insertion order."""
        return _unpack_flat(self.list_data, self.slot_rows, self.size)

    def __repr__(self):
        return (f"ivf_flat.Index(n_lists={self.n_lists}, dim={self.dim}, size={self.size}, "
                f"metric={self.metric.name}, device={self.device})")


#: the JAX Index fields `index_from_arrays` takes
INDEX_FIELDS = ("centers", "list_data", "slot_rows", "list_sizes", "source_ids")


def index_from_arrays(arrays: Dict[str, np.ndarray], params: IndexParams,
                      device=None) -> Index:
    """The port's Index from the JAX Index fields as numpy arrays
    (`INDEX_FIELDS`), so both packages can search one identical index.
    Its `list_radii` are the given ones, else computed from the store."""
    dev = resolve_device(device)
    missing = [f for f in INDEX_FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"index_from_arrays: missing fields {missing}")
    dtypes = {"slot_rows": torch.int32, "list_sizes": torch.int32, "source_ids": torch.int32}
    t = {f: torch.as_tensor(np.array(arrays[f]))
         .to(device=dev, dtype=dtypes.get(f, torch.float32)) for f in INDEX_FIELDS}
    index = Index(params, t["centers"], t["list_data"], t["slot_rows"], t["list_sizes"],
                  t["source_ids"])
    if arrays.get("list_radii") is not None:
        index.list_radii = torch.as_tensor(np.array(arrays["list_radii"]),
                                           dtype=torch.float32, device=dev)
    else:
        index.list_radii = probe_budget.list_radii_from_store(index.list_data, index.slot_rows,
                                                              index.centers)
    return index


_SERIAL_VERSION = 4  # v2: list-major; v3: mutation; v4: digest sidecar


def save(filename: str, index: Index) -> None:
    """Write the index as the JAX package's v4 container, with its digest
    sidecar where it has one (`list_digests` packed as one uint32 array,
    `table_digests` in the meta). Derived stores are not saved."""
    from raft_tpu_torch.core.serialize import serialize_arrays
    from raft_tpu_torch.integrity.digest import pack_lists

    arrays = {
        "centers": index.centers,
        "list_data": index.list_data,
        "slot_rows": index.slot_rows,
        "list_sizes": index.list_sizes,
        "source_ids": index.source_ids,
    }
    if index.list_radii is not None:
        arrays["list_radii"] = index.list_radii
    if index.tombstones is not None:
        arrays["tombstones"] = torch.as_tensor(index.tombstones).to(torch.uint8)
    meta = {
        "kind": "ivf_flat",
        "version": _SERIAL_VERSION,
        "metric": int(index.metric),
        "metric_arg": index.params.metric_arg,
        "n_lists": index.n_lists,
        "adaptive_centers": index.params.adaptive_centers,
        "mut_cursor": int(index.mut_cursor),
        "append_slack": int(index.append_slack),
    }
    packed = pack_lists(index, "ivf_flat")
    if packed is not None:
        arrays["list_digests"] = packed
        meta["table_digests"] = {k: int(v) for k, v in (index.table_digests or {}).items()}
    serialize_arrays(filename, arrays, meta)


def load(filename: str, device=None) -> Index:
    """Read an "ivf_flat" container (either package's) onto
    `resolve_device(device)`. Fields a file lacks load as the schema
    declares: no `list_radii` -> None (budgets only; never derived here),
    no `tombstones` -> all live, cursor and slack 0, no sidecar (or a
    corrupt one) -> `list_digests` None."""
    from raft_tpu_torch.core.serialize import as_device_tensor, read_ckpt
    from raft_tpu_torch.integrity.digest import unpack_lists

    dev = resolve_device(device)
    arrays, meta = read_ckpt(filename, "ivf_flat", to_device=False)
    if meta.get("version", 1) < 2:
        raise ValueError("ivf_flat index file version too old (pre-list-major)")
    params = IndexParams(n_lists=meta["n_lists"], metric=DistanceType(meta["metric"]),
                         metric_arg=meta.get("metric_arg", 2.0),
                         adaptive_centers=meta.get("adaptive_centers", False))
    f32, i32 = torch.float32, torch.int32
    index = Index(params, as_device_tensor(arrays["centers"], dev, f32),
                  as_device_tensor(arrays["list_data"], dev, f32),
                  as_device_tensor(arrays["slot_rows"], dev, i32),
                  as_device_tensor(arrays["list_sizes"], dev, i32),
                  as_device_tensor(arrays["source_ids"], dev, i32))
    if arrays.get("list_radii") is not None:
        index.list_radii = as_device_tensor(arrays["list_radii"], dev, f32)
    if arrays.get("tombstones") is not None:
        index.tombstones = as_device_tensor(arrays["tombstones"], dev, torch.bool)
    index.mut_cursor = int(meta.get("mut_cursor", 0))
    index.append_slack = int(meta.get("append_slack", 0))
    unpack_lists(index, "ivf_flat", arrays.get("list_digests"), meta.get("table_digests"))
    return index


# ---------------------------------------------------------------------------
# list packing (shared with IVF-PQ and IVF-RaBitQ)
# ---------------------------------------------------------------------------


def _pack_lists(labels: torch.Tensor, n_lists: int, group: int = 32):
    """The padded slot table of a labelling (the JAX `ivf_flat._pack_lists`):
    (row_ids (n_lists, max_size) int32, -1 past each list's rows, which
    keep their order; sizes (n_lists,) int32), max_size rounded up to a
    multiple of `group`. Built on the labels' device."""
    labels = labels.long()
    sizes = torch.bincount(labels, minlength=n_lists)
    max_sz = max(int(sizes.max()) if labels.numel() else 0, 1)
    max_sz = -(-max_sz // group) * group
    order = torch.argsort(labels, stable=True)
    starts = torch.cumsum(sizes, 0) - sizes
    sorted_labels = labels[order]
    rank = torch.arange(labels.numel(), device=labels.device) - starts[sorted_labels]
    row_ids = torch.full((n_lists, max_sz), -1, dtype=torch.int32, device=labels.device)
    row_ids[sorted_labels, rank] = order.to(torch.int32)
    return row_ids, sizes.to(torch.int32)


def _append_slots(labels_new: np.ndarray, old_sizes: np.ndarray, n_lists: int,
                  group: int = 32):
    """Per-new-row slots appended after the existing list contents, and
    the grown table geometry: (slot_abs (n_new,), new_sizes (n_lists,),
    new_max_list). O(n_new) host work."""
    labels_new = np.asarray(labels_new, np.int64)
    counts_new = np.bincount(labels_new, minlength=n_lists)
    new_sizes = old_sizes + counts_new
    new_max = max(int(new_sizes.max()) if n_lists else 1, 1)
    new_max = -(-new_max // group) * group
    order = np.argsort(labels_new, kind="stable")
    rank = np.empty_like(order)
    starts = np.zeros(n_lists, np.int64)
    starts[1:] = np.cumsum(counts_new)[:-1]
    rank[order] = np.arange(len(labels_new)) - starts[labels_new[order]]
    slot_abs = old_sizes[labels_new] + rank
    return slot_abs.astype(np.int32), new_sizes.astype(np.int32), new_max


def _grow_and_scatter_multi(tables, slot_rows: torch.Tensor, payloads, labels: torch.Tensor,
                            slots: torch.Tensor, positions: torch.Tensor, new_max: int):
    """Grow several (n_lists, max, ...) payload tables and their slot rows
    to `new_max` slots and write the new batch into its (label, slot)
    cells: one placement, one indexed write per table. The cells are
    distinct, so an indexed write places every row exactly (the JAX
    package replaces the scatter with a sort, which the TPU serializes; a
    GPU scatters natively). Returns (grown tables, grown slot rows)."""
    n_lists, old_max = slot_rows.shape
    li, si = labels.long(), slots.long()
    out = []
    for table, new in zip(tables, payloads):
        if new_max > old_max:
            grown = torch.zeros((n_lists, new_max, *table.shape[2:]), dtype=table.dtype,
                                device=table.device)
            grown[:, :old_max] = table
        else:
            grown = table.clone()
        grown[li, si] = new.to(grown.dtype)
        out.append(grown)
    rows = torch.full((n_lists, max(new_max, old_max)), -1, dtype=slot_rows.dtype,
                      device=slot_rows.device)
    rows[:, :old_max] = slot_rows
    rows[li, si] = positions.to(rows.dtype)
    return tuple(out), rows


def _grow_and_scatter(list_data: torch.Tensor, slot_rows: torch.Tensor,
                      nv: torch.Tensor, labels: torch.Tensor, slots: torch.Tensor,
                      positions: torch.Tensor, new_max: int):
    """`_grow_and_scatter_multi` for one (n_lists, max, d) table."""
    (table,), rows = _grow_and_scatter_multi((list_data,), slot_rows, (nv,), labels, slots,
                                             positions, new_max)
    return table, rows


def _unpack_flat(list_data: torch.Tensor, slot_rows: torch.Tensor, n: int) -> torch.Tensor:
    """The flat (n, d) row table from the list-major slots."""
    flat = torch.zeros((n, list_data.shape[-1]), dtype=list_data.dtype,
                       device=list_data.device)
    valid = slot_rows >= 0
    flat[slot_rows[valid].long()] = list_data[valid]
    return flat


# ---------------------------------------------------------------------------
# build / extend
# ---------------------------------------------------------------------------


def _metric_name(metric: DistanceType) -> str:
    return "inner_product" if metric == DistanceType.InnerProduct else "sqeuclidean"


@obs.spanned("neighbors.ivf_flat.build")
@accepts_resources
def build(params: IndexParams, dataset, resources=None, seed: int = 0, device=None) -> Index:
    """Train coarse centers (balanced k-means on a trainset fraction drawn
    without replacement from a generator seeded by `seed`) and populate
    the lists (detail/ivf_flat_build.cuh `build`)."""
    x = check_matrix(dataset, device=device, name="dataset").float()
    dev = x.device
    n = x.shape[0]
    if params.n_lists > n:
        raise ValueError(f"n_lists={params.n_lists} > dataset rows {n}")
    frac = min(max(params.kmeans_trainset_fraction, 0.0), 1.0)
    n_train = min(n, max(params.n_lists, int(n * frac)) if frac < 1.0 else n)
    x_train = x
    if n_train < n:
        x_train = x[sample_without_replacement(make_generator(seed, dev), n, n_train)]
    fit = kmeans_balanced.fit_hierarchical if params.n_lists > 1024 else kmeans_balanced.fit
    centers = fit(x_train, params.n_lists, n_iters=params.kmeans_n_iters,
                  metric=_metric_name(params.metric), seed=seed, device=dev)
    index = Index(
        params, centers,
        torch.zeros((params.n_lists, 1, x.shape[1]), dtype=torch.float32, device=dev),
        torch.full((params.n_lists, 1), -1, dtype=torch.int32, device=dev),
        torch.zeros((params.n_lists,), dtype=torch.int32, device=dev),
        torch.zeros((0,), dtype=torch.int32, device=dev),
    )
    # zero radii on the empty index: every extend raises them
    index.list_radii = torch.zeros((params.n_lists,), dtype=torch.float32, device=dev)
    if params.add_data_on_build:
        index = extend(index, x, torch.arange(n, dtype=torch.int32, device=dev))
    # the integrity sidecar: one full digest pass here, then every
    # mutation keeps it fresh
    from raft_tpu_torch.integrity.digest import attach

    attach(index, "ivf_flat")
    return index


@obs.spanned("neighbors.ivf_flat.extend")
def extend(index: Index, new_vectors, new_indices=None) -> Index:
    """Append vectors (ivf_flat build.cuh `extend`): label only the new
    rows, grow the list tables, place the batch in its slots. A store
    padded for the fused engine never shrinks. With `adaptive_centers`
    each center moves to the running mean of its old and new members, and
    the list radii, taken against the old centers, become None. The
    digest sidecar hashes again only the lists the batch touched."""
    from raft_tpu_torch.core.bitset import carry_tombstones
    from raft_tpu_torch.integrity.digest import refresh

    dev = index.device
    nv = check_matrix(new_vectors, device=dev, name="new_vectors").float()
    old_n = index.size
    if new_indices is None:
        new_indices = torch.arange(old_n, old_n + nv.shape[0], dtype=torch.int32, device=dev)
    else:
        new_indices = torch.as_tensor(new_indices, device=dev).to(torch.int32)
    labels = kmeans_balanced._predict_long(nv, index.centers, metric=_metric_name(index.metric),
                                     device=dev)
    old_sizes = index.list_sizes.cpu().numpy().astype(np.int64)
    slot_abs, new_sizes, new_max = _append_slots(labels.cpu().numpy(), old_sizes, index.n_lists)
    new_max = max(new_max, int(index.list_data.shape[1]))
    positions = torch.arange(old_n, old_n + nv.shape[0], dtype=torch.int32, device=dev)
    list_data, slot_rows = _grow_and_scatter(index.list_data, index.slot_rows, nv, labels,
                                             torch.as_tensor(slot_abs, device=dev), positions,
                                             new_max)
    all_ids = torch.cat([index.source_ids, new_indices]) if old_n else new_indices
    centers = index.centers
    if index.adaptive_centers:
        # the running mean from the new batch only (ivf_flat_types.hpp:63)
        from raft_tpu_torch.cluster.kmeans_common import assign_and_reduce

        _, sums, counts, _ = assign_and_reduce(nv, centers)
        old_w = torch.as_tensor(old_sizes, dtype=torch.float32, device=dev)[:, None]
        total = old_w + counts[:, None]
        upd = (centers * old_w + sums) / torch.clamp(total, min=1.0)
        centers = torch.where(counts[:, None] > 0, upd, centers)
    out = Index(index.params, centers, list_data, slot_rows,
                torch.as_tensor(new_sizes, device=dev), all_ids)
    if not index.adaptive_centers:
        from raft_tpu_torch.neighbors.quantizer import ordered_row_sum, sqrt_f32

        res = nv - index.centers[labels]
        dists = sqrt_f32(torch.clamp(ordered_row_sum(res, res), min=0.0))
        out.list_radii = probe_budget.updated_radii(index.list_radii, labels, dists,
                                                    index.n_lists)
    out.tombstones = carry_tombstones(index.tombstones, new_max)
    out.mut_cursor = index.mut_cursor
    out.append_slack = index.append_slack
    refresh(out, index, "ivf_flat")
    return out


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def _probes(queries, centers, n_probes: int, metric: DistanceType):
    """The n_probes best coarse centers of each query (adaptive probing's
    `probe_budget.coarse_select`, the one coarse select of every engine)."""
    return probe_budget.coarse_select(queries, centers, metric, n_probes)[1]


def _planned_probes(queries, centers, n_probes: int, metric: DistanceType, plan):
    """(probes, keep mask or None): an adaptive `plan`'s ((keep mask,
    probes), `probe_budget.search_plan`, which made the coarse select
    already), else the fixed search's probes."""
    if plan is not None:
        return plan[1], plan[0]
    return _probes(queries, centers, n_probes, metric), None


def resolve_auto_engine(nq: int, n_probes: int, n_lists: int, pallas_ok=None,
                        device=None) -> str:
    """The "auto" engine policy: the tuned `flat_auto_engine` where the
    table governs `device` (CUDA), "fused" spelled "pallas" as in the JAX
    package; a tuned fused engine needs `pallas_ok()` to hold (None: the
    caller has no fused engine, and the winner maps to "list"; False: the
    winner is passed over). Else "list" when the batch re-reads each list
    at least 4 times (nq * n_probes / n_lists >= 4), else "query"."""
    t = tuned.get("flat_auto_engine") if tuned.applies(device) else None
    if t == "fused":
        t = "pallas"  # one fused engine, two spellings
    if t == "pallas":
        if pallas_ok is None:
            t = "list"
        elif not pallas_ok():
            t = None
    if t in ("query", "list", "pallas"):
        return t
    dup = nq * n_probes / max(1, n_lists)
    return "list" if dup >= 4.0 else "query"


def _query_block(n_probes: int, max_list: int, dim: int) -> int:
    return max(1, QUERY_BLOCK_ELEMS // max(1, n_probes * max_list * (dim + 3)))


def _search_impl(queries, centers, list_data, slot_rows, k: int, n_probes: int,
                 metric: DistanceType, query_block: Optional[int] = None, plan=None):
    """The "query" engine: per block of queries, gather each query's
    probed lists, score them with one batched f32 product, mask the empty
    slots (and those of the probes an adaptive `plan` masked) to the
    worst value and select exactly. Returns (distances, slot-table
    values) (nq, k)."""
    strict_f32_matmul()
    nq, dim = queries.shape
    max_list = list_data.shape[1]
    ip = metric == DistanceType.InnerProduct
    worst = float("-inf") if ip else float("inf")
    probes, pvalid = _planned_probes(queries, centers, n_probes, metric, plan)
    qb = query_block or _query_block(n_probes, max_list, dim)
    vals, rows = [], []
    for s in range(0, nq, qb):
        qs, pr = queries[s:s + qb].float(), probes[s:s + qb].long()
        b = qs.shape[0]
        cand = slot_rows[pr]
        if pvalid is not None:
            cand = torch.where(pvalid[s:s + qb][:, :, None], cand, -1)
        cand = cand.reshape(b, -1)                            # (b, C), -1 pad
        cdata = list_data[pr].reshape(b, cand.shape[1], dim)  # (b, C, dim)
        dots = torch.bmm(cdata, qs[:, :, None])[..., 0]
        if ip:
            score = dots
        else:
            qn = torch.sum(qs * qs, dim=1)[:, None]
            cn = torch.sum(cdata * cdata, dim=2)
            score = torch.clamp(qn + cn - 2.0 * dots, min=0.0)
        score = torch.where(cand >= 0, score, worst)
        v, pos = _select_k_impl(score, k, not ip)
        vals.append(v)
        rows.append(torch.gather(cand, 1, pos))
    v, r = torch.cat(vals), torch.cat(rows)
    if metric == DistanceType.L2SqrtExpanded:
        v = torch.sqrt(v)
    return v, r


def _search_impl_listmajor(queries, centers, list_data, slot_rows, k: int, n_probes: int,
                           metric: DistanceType, chunk: int = 128, plan=None,
                           setup_impls=("sort", "gather")):
    """The "list" engine: probe pairs (those an adaptive `plan`'s mask
    keeps) invert to per-list chunks, each chunk's queries score against
    its list's vectors (one batched f32 product a superblock), then the
    exact trim and merge of `probe_invert.score_and_select`.
    `setup_impls`: the (invert_impl, qs_impl) pair."""
    from raft_tpu_torch.neighbors.probe_invert import (
        gather_query_rows,
        invert_probes_with,
        score_and_select,
    )

    strict_f32_matmul()
    nq, dim = queries.shape
    n_lists, max_list, _ = list_data.shape
    ip = metric == DistanceType.InnerProduct
    worst = float("-inf") if ip else float("inf")
    probes, pvalid = _planned_probes(queries, centers, n_probes, metric, plan)
    invert_impl, qs_impl = setup_impls
    tables = invert_probes_with(invert_impl, probes, n_lists, chunk, pvalid)
    qf = queries.float()
    q_pad = torch.cat([qf, qf.new_zeros((1, dim))])

    def block(lofb, qids):
        lb = lofb.long()
        v = list_data[lb]  # (b, max_list, dim): this batch's only read of these vectors
        qs = gather_query_rows(q_pad, qids, qs_impl)  # (b, chunk, dim)
        dots = torch.bmm(qs, v.transpose(1, 2))
        if ip:
            score = dots
        else:
            qn = torch.sum(qs * qs, dim=2)[:, :, None]
            vn = torch.sum(v * v, dim=2)[:, None, :]
            score = torch.clamp(qn + vn - 2.0 * dots, min=0.0)
        return torch.where(slot_rows[lb][:, None, :] >= 0, score, worst)

    v, rows = score_and_select(tables, block, slot_rows, _select_k_impl, nq, n_probes, int(k),
                               not ip, chunk, max_list)
    if metric == DistanceType.L2SqrtExpanded:
        v = torch.sqrt(v)
    return v, rows


def _pad_store_to_lanes(index: Index, k: int) -> None:
    """Pad the list store in place to the list kernels' slot width
    (`ops.pq_list_scan.lane_padded`), for good: pad slots hold zero
    vectors and slot value -1, which every engine masks. Derive the fused
    engine's store when it is missing or the store's shape changed: bf16
    residuals v - center (exact zeros at pad slots; small magnitudes keep
    the bf16 product precise and halve the scanned bytes) and their f32
    squared norms. Grow the recorded candidate-buffer width `fused_kb` to
    hold k (monotone). A dead-slot mask widens with the table (the pad
    slots are not dead), so a later mutation sees one geometry.

    The digest sidecar follows the widening without reading the store:
    each widened list field's row digests are extended by the CRC of the
    pad bytes (zeros for `list_data`, 0xFF bytes, int32 -1, for
    `slot_rows`, u8 zeros for `tombstones`). A hash of the widened table
    would bless rot from before the pad; the extension keeps it
    detectable (the JAX reference leaves its sidecar at the old width, so
    every list mismatches after its first fused search)."""
    from raft_tpu_torch.core.bitset import carry_tombstones
    from raft_tpu_torch.integrity.digest import extend_rows
    from raft_tpu_torch.ops.fused_scan import fused_kbuf
    from raft_tpu_torch.ops.pq_list_scan import lane_padded

    max_list = int(index.list_data.shape[1])
    extra = lane_padded(max_list) - max_list
    if extra:
        pad = torch.nn.functional.pad
        index.list_data = pad(index.list_data, (0, 0, 0, extra))
        index.slot_rows = pad(index.slot_rows, (0, extra), value=-1)
        t_width = None if index.tombstones is None else int(index.tombstones.shape[1])
        index.tombstones = carry_tombstones(index.tombstones, max_list + extra)
        extend_rows(index, "list_data",
                    bytes(extra * index.dim * index.list_data.element_size()))
        extend_rows(index, "slot_rows", b"\xff" * (extra * index.slot_rows.element_size()))
        if t_width is not None:
            extend_rows(index, "tombstones", bytes(int(index.tombstones.shape[1]) - t_width))
    if index.resid_bf16 is None or index.resid_bf16.shape != index.list_data.shape:
        resid = index.list_data - index.centers[:, None, :]
        resid = torch.where((index.slot_rows >= 0)[:, :, None], resid, 0.0)
        index.resid_bf16 = resid.to(torch.bfloat16)
        index.resid_norm = torch.sum(resid * resid, dim=2)
    kb = fused_kbuf(int(k))
    if index.fused_kb is None or kb > index.fused_kb:
        index.fused_kb = kb


def _search_impl_listmajor_pallas(queries, centers, resid_bf16, resid_norm, slot_rows, k: int,
                                  n_probes: int, metric: DistanceType, chunk: int = 128,
                                  kb: Optional[int] = None, plan=None,
                                  setup_impls=("sort", "gather")):
    """The "fused" engine: list-major, scored by `fused_list_topk` over
    the bf16 residual store. |q - v|^2 = |q - c|^2 - 2 (q - c).(v - c) +
    |v - c|^2, so the kernel scores residual rows against base |v - c|^2
    (0 for inner product) and returns each row's exact top-k; +inf base
    wherever the slot table reads -1 (pad, or filtered). The query
    constant (|q - c|^2, or q.c for inner product) is added back before
    the exact merge. Pairs outside an adaptive `plan`'s mask are dropped
    before the inversion; `setup_impls` is the (invert_impl, qs_impl)
    pair."""
    from raft_tpu_torch.matrix.select_k import list_scan_select_k
    from raft_tpu_torch.neighbors.probe_invert import (
        chunk_live_rows,
        gather_query_rows,
        invert_probes_with,
        regroup_merge,
    )

    strict_f32_matmul()
    nq, dim = queries.shape
    n_lists = resid_bf16.shape[0]
    ip = metric == DistanceType.InnerProduct
    probes, pvalid = _planned_probes(queries, centers, n_probes, metric, plan)
    invert_impl, qs_impl = setup_impls
    tables = invert_probes_with(invert_impl, probes, n_lists, chunk, pvalid)
    lof = tables.lof
    live = chunk_live_rows(tables.qid_tbl, nq)  # pad rows and empty chunks skip in-kernel
    qf = queries.float()
    qs = gather_query_rows(torch.cat([qf, qf.new_zeros((1, dim))]), tables.qid_tbl, qs_impl)
    cent = centers[lof.long()]  # (ncb, dim)
    qres = (qs if ip else qs - cent[:, None, :]).contiguous()
    valid = slot_rows >= 0
    base = torch.where(valid, 0.0 if ip else resid_norm, float("inf"))[:, None, :].contiguous()
    vals, slot_idx = list_scan_select_k(lof, qres, resid_bf16, base, k, strategy="fused",
                                        kbuf=kb, inner_product=ip, chunk_rows=live)
    # the buffer is sorted: its first k slots are each row's top-k
    vals, slot_idx = vals[:, :, :k], slot_idx[:, :, :k]
    invalid = ~torch.isfinite(vals)
    slot_idx = torch.where(invalid, 0, slot_idx).long()  # sentinel -> safe gather
    rows = torch.gather(slot_rows[lof.long()][:, None, :].expand(-1, slot_idx.shape[1], -1), 2,
                        slot_idx)
    rows = torch.where(invalid, -1, rows)
    if ip:  # the kernel returned -(q . res); add q . c back
        qdotc = torch.einsum("cqd,cd->cq", qs, cent)
        vals = torch.where(invalid, float("-inf"), -vals + qdotc[:, :, None])
    else:
        vals = torch.clamp(vals + torch.sum(qres * qres, dim=2)[:, :, None], min=0.0)
    v, rows_out = regroup_merge(tables, vals, rows, _select_k_impl, nq, n_probes, int(k), not ip)
    if metric == DistanceType.L2SqrtExpanded:
        v = torch.sqrt(torch.clamp(v, min=0.0))
    return v.float(), rows_out


def _pallas_fits(index: Index, k: int) -> bool:
    """The fused engine's envelope (k cap, shared memory) at the buffer
    width the kernel will run with: the recorded `fused_kb` where it is
    already wider than this k needs."""
    from raft_tpu_torch.ops.fused_scan import FUSED_MAX_K, fits_fused_list, fused_kbuf
    from raft_tpu_torch.ops.pq_list_scan import lane_padded

    if not 0 < k <= FUSED_MAX_K:
        return False
    kb = max(fused_kbuf(int(k)), index.fused_kb or 0)
    return fits_fused_list(lane_padded(int(index.list_data.shape[1])), index.dim, int(k),
                           kbuf=kb)


@obs.spanned("neighbors.ivf_flat.search")
@auto_convert_output
@accepts_resources
def search(params: SearchParams, index: Index, queries, k: int, resources=None, prefilter=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN search; returns (distances (nq, k) f32, neighbor source ids
    (nq, k) int32), best-first, on the index's device.

    `prefilter`: a `core.bitset.Bitset` or 1-d boolean mask over the
    index's id space (`index.id_bound` ids); samples whose bit is clear
    are excluded before any selection, on every engine. Where fewer than
    k samples pass (or the probed lists hold fewer), the tail holds the
    worst distance with id -1. Adaptive probing plans one keep mask for
    the batch over the probes the engine then scans
    (`probe_budget.search_plan`), with radius bounds for L2 metrics when
    the index has radii, no tombstones and no prefilter is given."""
    from raft_tpu_torch.core.bitset import make_slot_filter
    from raft_tpu_torch.neighbors.probe_invert import macro_batched, resolve_setup_impls

    q = check_matrix(queries, device=index.device, name="queries").float()
    if q.shape[1] != index.dim:
        raise ValueError(f"query dim {q.shape[1]} != index dim {index.dim}")
    if index.size == 0:
        raise ValueError("index is empty")
    k = int(k)
    if k <= 0:
        raise ValueError("k must be positive")
    n_probes = int(min(max(1, params.n_probes), index.n_lists))
    maybe_filter = make_slot_filter(prefilter, index.id_bound, index.source_ids,
                                    tombstones=index.tombstones)
    engine = params.engine
    if engine == "pallas":
        engine = "fused"  # one fused engine, two spellings
    if engine == "auto":
        engine = resolve_auto_engine(q.shape[0], n_probes, index.n_lists,
                                     pallas_ok=lambda: _pallas_fits(index, k),
                                     device=index.device)
        if engine == "pallas":
            engine = "fused"
    if engine not in ("fused", "list", "query"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine != "fused" and k > n_probes * int(index.list_data.shape[1]):
        raise ValueError(f"k={k} exceeds the {n_probes} probed lists' "
                         f"{n_probes * int(index.list_data.shape[1])} slots")
    # bounds off under a prefilter or tombstones: the sizes count the
    # members a filter drops, so a k-covering prefix could be all filtered
    # and a list with eligible neighbours skipped
    ap = probe_budget.resolve_params(params, n_probes, index.device)
    plan = probe_budget.search_plan(
        ap, q, index.centers,
        n_probes=n_probes, k=k, metric=index.metric,
        radii=index.list_radii if prefilter is None and index.tombstones is None else None,
        sizes=index.list_sizes)
    if obs.enabled():
        scanned_mean = (probe_budget.account_plan("ivf_flat", plan, q.shape[0], n_probes)
                        if ap is not None else None)
        # the JAX charge ("list" as a scan of every padded list, the other
        # engines the probed lists; tombstoned slots bill nothing), but the
        # fused engine at the bf16 rate it runs at: the JAX package charges
        # it as f32, which on a TPU is the bf16 peak, and on the card would
        # be the CUDA cores' f32 peak
        obs.span_cost(**obs.perf.cost_for(
            "neighbors.ivf_flat.search", nq=int(q.shape[0]), n_probes=n_probes,
            n_lists=int(index.n_lists),
            n_rows=int(index.list_data.shape[0] * index.list_data.shape[1])
            - index.n_tombstones,
            dim=int(index.dim), k=k, dtype="bf16" if engine == "fused" else "f32",
            scanned_lists=(int(index.n_lists) if engine == "list"
                           else (scanned_mean if scanned_mean is not None else n_probes)),
            fused=engine == "fused"))
    # the list-major engines' (invert_impl, qs_impl), resolved once a search
    setup = resolve_setup_impls(index.n_lists, "flat", index.device)
    if engine == "fused":
        from raft_tpu_torch.matrix.select_k import check_fused_list_request
        from raft_tpu_torch.ops.pq_list_scan import lane_padded

        # checked before the store is padded: a rejected request leaves
        # the index as it was
        kb = check_fused_list_request("engine='fused'",
                                      lane_padded(int(index.list_data.shape[1])), index.dim,
                                      k, index.fused_kb, "engine='list'")
        _pad_store_to_lanes(index, k)
        srows = maybe_filter(index.slot_rows)
        vals, rows = macro_batched(
            lambda sl, pl=None: _search_impl_listmajor_pallas(
                sl, index.centers, index.resid_bf16, index.resid_norm, srows, k, n_probes,
                index.metric, kb=kb, plan=pl, setup_impls=setup),
            q, k, MACRO_BATCH, extra=plan)
    elif engine == "list":
        srows = maybe_filter(index.slot_rows)
        vals, rows = macro_batched(
            lambda sl, pl=None: _search_impl_listmajor(
                sl, index.centers, index.list_data, srows, k, n_probes, index.metric, plan=pl,
                setup_impls=setup),
            q, k, MACRO_BATCH, extra=plan)
    else:
        vals, rows = _search_impl(q, index.centers, index.list_data,
                                  maybe_filter(index.slot_rows), k, n_probes, index.metric,
                                  plan=plan)
    ids = torch.where(rows >= 0, index.source_ids[torch.clamp(rows, min=0).long()], -1)
    return vals, ids.to(torch.int32)
