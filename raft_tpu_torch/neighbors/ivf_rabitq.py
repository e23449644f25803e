"""IVF-RaBitQ: inverted-file ANN index over 1-bit RaBitQ codes
(counterpart of raft_tpu/neighbors/ivf_rabitq.py).

Build: rotation (always random: sign binarization needs an isotropic
basis) -> balanced k-means coarse centers (the IVF-PQ coarse fit) -> one
sign-encode pass over the per-list residuals. There is no codebook stage.

Layout (per IVF list, the IVF-PQ slot-table scheme):

    rotation  (rot_dim, dim) f32   rot_dim = dim rounded up to 32
    centers   (n_lists, rot_dim)   coarse centroids in rotated space
    codes     (n_lists, max_list, W) int32 packed sign bits (uint32 words)
    aux       (n_lists, max_list, 2) f32 [|r|, <o, x_bar>]
    slot_rows / list_sizes / source_ids   as in IVF-PQ
    dataset   (n, dim) f32 raw rows in insertion order (store_dataset)

Search: coarse top-n_probes, then the probed lists' codes are scored by
AND+popcount against each query's quantized bit planes and the unbiased
estimator; the best rerank_mult * k candidates (capped at 256) re-rank
exactly through neighbors/refine when raw rows are available. Two scan
engines:

  scan_engine="xla"    the materializing scan (`_search_impl_rabitq`), in
                       plain torch: per query block, gather the probed
                       codes, AND+popcount, estimator, select;
  scan_engine="fused"  the list-major engine: the probe pairs invert to
                       per-list chunks (probe_invert) and one launch of the
                       `fused_bitplane_topk` kernel scores every chunk and
                       keeps each row's exact top-k; the regrouped
                       candidates merge exactly;
  scan_engine="auto"   "fused" where a tuned `select_k_strategy_bitplane`
                       (CUDA only, core/tuned.py) names it and the kernel
                       fits, else "xla" (matrix/select_k
                       `resolve_bitplane_strategy`).

`query_bits` and `rerank_mult` of 0 resolve through the tuned
`rabitq_query_bits` and `rabitq_rerank_mult` on CUDA, else 8 and 4.
Adaptive probing (`adaptive`, `recall_target`, `budget_tau`;
neighbors/probe_budget) plans one keep mask a batch at the rerank depth;
the radii are the per-list max of `aux`'s |r| column (`list_radii`,
derived at first use).

Both engines score through `ops.fused_scan.bitplane_scores`, so their
estimator values agree; the CUDA kernel runs on the card, its plain
version on the CPU.

A `prefilter` (a `core.bitset.Bitset` or boolean mask over the index's
ids) is one view of each engine's slot table, filtered per call: the
"xla" engine masks where `slot_rows` reads -1, the fused one takes +inf
base where `slot_rows_pad` does (the derived bit-plane store stays as it
was cached), and the rerank never sees a filtered row. The `tombstones`
of live mutation (neighbors/mutation) are applied the same way, before
the prefilter, and turn adaptive probing's radius bounds off.

`save` / `load` write and read the JAX package's container (kind
"ivf_rabitq", writer version 3, with the quantizer's state hooks). The
raw-row store is not saved, as in the JAX package: a loaded index
re-ranks through `refine_dataset`. The integrity sidecar (`list_digests`,
`table_digests`; raft_tpu_torch/integrity) is attached at build,
refreshed by `extend` and every mutation, and saved and loaded with the
index, over the bytes `save` writes (codes as uint32 words). The encode
stage of `extend` (and so of build) is the `ivf_rabitq.build.encode`
fault site (core/faults). With obs enabled, build, extend and search
each land a span, the search charging its analytic cost
(`obs.perf.rabitq_scan`) and an adaptive batch its scanned lists. The
distributed (MNMG) index is not ported (ROADMAP Queue A item 12).
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
from raft_tpu_torch.neighbors.ivf_pq import _coarse_fit, _coarse_select, _make_rotation, _metric_name
from raft_tpu_torch.neighbors.quantizer import (
    DEFAULT_QUERY_BITS,
    RabitqQuantizer,
    binary_dot,
    ordered_row_sum,
    packed_words,
    quantize_queries,
    sqrt_f32,
)
from raft_tpu_torch.ops.fused_scan import bitplane_scores, popcount32
from raft_tpu_torch.random.rng import make_generator

#: exact-rerank gather cap (the JAX package's, shared with its MNMG refine)
_MAX_RERANK = 256
#: default rerank depth multiplier (the JAX fallback when no tuned value exists)
DEFAULT_RERANK_MULT = 4


@dataclasses.dataclass
class IndexParams:
    """Build parameters (the coarse stage mirrors ivf_pq.IndexParams;
    RaBitQ has no codebook knob)."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    metric_arg: float = 2.0
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    add_data_on_build: bool = True
    # keep the raw rows for the exact rerank (dataset-sized memory);
    # False = quantized-only: pass refine_dataset to search, or take the
    # estimator ranking
    store_dataset: bool = True

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)


@dataclasses.dataclass
class SearchParams:
    """Search parameters.

    query_bits   query plane bits (1..8); 0 = 8.
    rerank_mult  exact-rerank depth multiplier: the scan keeps
                 max(k, min(rerank_mult * k, 256)) candidates when raw
                 rows are available; 0 = 4.
    scan_engine  "xla", "fused" or "auto" (module docstring); an explicit
                 "fused" past the kernel's caps raises.
    adaptive, recall_target, budget_tau, min_probes, early_term
                 adaptive probing (neighbors/probe_budget), planned at the
                 rerank depth; recall_target >= 1.0 is the fixed search
                 bit for bit."""

    n_probes: int = 20
    query_bits: int = 0
    rerank_mult: int = 0
    scan_engine: str = "auto"
    adaptive: bool = False
    recall_target: Optional[float] = None
    budget_tau: Optional[float] = None
    min_probes: int = 1
    early_term: bool = True


def resolve_query_bits(query_bits: int, device=None) -> int:
    """An explicit depth in [1, 8]; 0 is the tuned `rabitq_query_bits`
    where the table governs `device` (CUDA) and holds a depth in [1, 8],
    else DEFAULT_QUERY_BITS (8)."""
    if query_bits:
        if not (1 <= int(query_bits) <= 8):
            raise ValueError(f"query_bits must be in [1, 8], got {query_bits}")
        return int(query_bits)
    t = tuned.get("rabitq_query_bits") if tuned.applies(device) else None
    return int(t) if t in (1, 2, 3, 4, 5, 6, 7, 8) else DEFAULT_QUERY_BITS


def resolve_rerank_mult(rerank_mult: int, device=None) -> int:
    """An explicit multiplier >= 1; 0 is the tuned `rabitq_rerank_mult`
    where the table governs `device` (CUDA) and holds an int in [1, 64],
    else DEFAULT_RERANK_MULT (4)."""
    if rerank_mult:
        if rerank_mult < 1:
            raise ValueError(f"rerank_mult must be >= 1, got {rerank_mult}")
        return int(rerank_mult)
    t = tuned.get("rabitq_rerank_mult") if tuned.applies(device) else None
    return int(t) if isinstance(t, int) and 1 <= t <= 64 else DEFAULT_RERANK_MULT


class Index:
    """IVF-RaBitQ index (tensors on one device; see the module docstring).

    The fused scan's store is derived at the first fused search
    (`build_bitplane_store`): codes_t (n_lists, W, L) word-transposed
    int32 codes, bp_meta (n_lists, 3, L) f32 [popcount, |r|, <o, x_bar>],
    slot_rows_pad (n_lists, L) int32 (-1 on pad slots), L a multiple of
    128, and fused_kb, the candidate-buffer width, grown monotonically.
    Live mutation: tombstones (n_lists, max_list) bool dead-slot mask or
    None (all live), mut_cursor and append_slack as in ivf_flat.Index;
    list_digests and table_digests, the integrity sidecar."""

    def __init__(self, params: IndexParams, rotation, centers, codes, aux, slot_rows,
                 list_sizes, source_ids, dataset=None):
        self.params = params
        self.rotation = rotation
        self.centers = centers
        self.codes = codes
        self.aux = aux
        self.slot_rows = slot_rows
        self.list_sizes = list_sizes
        self.source_ids = source_ids
        self.dataset = dataset
        self.codes_t = None
        self.bp_meta = None
        self.slot_rows_pad = None
        self.fused_kb = None
        self._list_radii = None
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
    def list_radii(self):
        """(n_lists,) f32 largest member residual norm of each list (the
        bounds of adaptive probing): a per-list max over `aux`'s |r|
        column, derived at first use (extend returns a new Index)."""
        if self._list_radii is None and self.size:
            self._list_radii = probe_budget.list_radii_from_aux(self.aux, self.slot_rows)
        return self._list_radii

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
        return int(self.rotation.shape[1])

    @property
    def rot_dim(self) -> int:
        return int(self.rotation.shape[0])

    @property
    def words(self) -> int:
        return int(self.codes.shape[2])

    @property
    def size(self) -> int:
        return int(self.source_ids.shape[0])

    @property
    def id_bound(self) -> int:
        """One past the largest source id: the id space a `prefilter`
        covers (past `size` when extend was given custom ids). Read from
        the device once an index (extend returns a new one), so searches
        after the first wait on no device value."""
        if self._id_bound is None:
            self._id_bound = int(self.source_ids.max()) + 1 if self.size else 0
        return self._id_bound

    def __repr__(self):
        return (f"ivf_rabitq.Index(n_lists={self.n_lists}, dim={self.dim}, "
                f"rot_dim={self.rot_dim}, size={self.size}, metric={self.metric.name}, "
                f"device={self.device})")


#: the JAX Index fields `index_from_arrays` takes (`dataset` is optional)
INDEX_FIELDS = ("rotation", "centers", "codes", "aux", "slot_rows", "list_sizes", "source_ids")


def index_from_arrays(arrays: Dict[str, np.ndarray], params: IndexParams,
                      device=None) -> Index:
    """The port's Index from the JAX Index fields as numpy arrays
    (`INDEX_FIELDS`, plus `dataset` when given), so both packages can
    search one identical index. uint32 codes keep their bits as int32."""
    dev = resolve_device(device)
    missing = [f for f in INDEX_FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"index_from_arrays: missing fields {missing}")
    dtypes = {"codes": torch.int32, "slot_rows": torch.int32, "list_sizes": torch.int32,
              "source_ids": torch.int32}
    t = {}
    for f in INDEX_FIELDS + (("dataset",) if arrays.get("dataset") is not None else ()):
        a = np.array(arrays[f])
        if f == "codes" and a.dtype == np.uint32:
            a = a.view(np.int32)
        t[f] = torch.as_tensor(a).to(device=dev, dtype=dtypes.get(f, torch.float32))
    return Index(params, t["rotation"], t["centers"], t["codes"], t["aux"], t["slot_rows"],
                 t["list_sizes"], t["source_ids"], dataset=t.get("dataset"))


_SERIAL_VERSION = 3  # v2: mutation fields; v3: digest sidecar


def save(filename: str, index: Index) -> None:
    """Write the quantized index as the JAX package's v3 container (codes
    as uint32 words), with its digest sidecar where it has one. The
    raw-row store is not saved: a loaded index re-ranks through
    `refine_dataset`, or serves the estimator ranking."""
    from raft_tpu_torch.core.serialize import serialize_arrays
    from raft_tpu_torch.integrity.digest import pack_lists

    quant = RabitqQuantizer(index.rot_dim)
    arrays = {
        "rotation": index.rotation,
        "centers": index.centers,
        "codes": index.codes.cpu().numpy().view(np.uint32),
        "aux": index.aux,
        "slot_rows": index.slot_rows,
        "list_sizes": index.list_sizes,
        "source_ids": index.source_ids,
        **quant.state_arrays(),
    }
    if index.tombstones is not None:
        arrays["tombstones"] = torch.as_tensor(index.tombstones).to(torch.uint8)
    meta = {
        "kind": "ivf_rabitq",
        "version": _SERIAL_VERSION,
        "metric": int(index.metric),
        "n_lists": index.n_lists,
        "mut_cursor": int(index.mut_cursor),
        "append_slack": int(index.append_slack),
        **quant.state_meta(),
    }
    packed = pack_lists(index, "ivf_rabitq")
    if packed is not None:
        arrays["list_digests"] = packed
        meta["table_digests"] = {k: int(v) for k, v in (index.table_digests or {}).items()}
    serialize_arrays(filename, arrays, meta)


def load(filename: str, device=None) -> Index:
    """Read an "ivf_rabitq" container (either package's) onto
    `resolve_device(device)`, quantized only (`store_dataset=False`).
    Absent fields load as the schema declares (all live, cursor and slack
    0, no sidecar -> `list_digests` None)."""
    from raft_tpu_torch.core.serialize import as_device_tensor, read_ckpt
    from raft_tpu_torch.integrity.digest import unpack_lists

    dev = resolve_device(device)
    arrays, meta = read_ckpt(filename, "ivf_rabitq", to_device=False)
    params = IndexParams(n_lists=meta["n_lists"], metric=DistanceType(meta["metric"]),
                         store_dataset=False)
    f32, i32 = torch.float32, torch.int32
    index = Index(params, as_device_tensor(arrays["rotation"], dev, f32),
                  as_device_tensor(arrays["centers"], dev, f32),
                  as_device_tensor(arrays["codes"], dev, i32),
                  as_device_tensor(arrays["aux"], dev, f32),
                  as_device_tensor(arrays["slot_rows"], dev, i32),
                  as_device_tensor(arrays["list_sizes"], dev, i32),
                  as_device_tensor(arrays["source_ids"], dev, i32))
    if arrays.get("tombstones") is not None:
        index.tombstones = as_device_tensor(arrays["tombstones"], dev, torch.bool)
    index.mut_cursor = int(meta.get("mut_cursor", 0))
    index.append_slack = int(meta.get("append_slack", 0))
    unpack_lists(index, "ivf_rabitq", arrays.get("list_digests"), meta.get("table_digests"))
    return index


# ---------------------------------------------------------------------------
# build / extend
# ---------------------------------------------------------------------------


#: fault site (core/faults): the encode stage of build and extend
ENCODE_SITE = "ivf_rabitq.build.encode"


def rabitq_rot_dim(dim: int) -> int:
    """Packing geometry: dim rounded up to whole 32-bit words."""
    return -(-dim // 32) * 32


def _encode_rotated(v_rot: torch.Tensor, labels: torch.Tensor, centers: torch.Tensor):
    """Rotated rows -> (codes (n, W) int32, aux (n, 2) f32): the
    quantizer's encode of the per-list residuals."""
    payload = RabitqQuantizer(int(v_rot.shape[-1])).encode(v_rot - centers[labels])
    return payload["codes"], payload["aux"]


def label_and_encode(vectors: torch.Tensor, rotation: torch.Tensor, centers: torch.Tensor,
                     metric: DistanceType):
    """Rotate, assign to coarse lists, and RaBitQ-encode the residuals.
    Returns (labels (n,) int64, codes (n, W) int32, aux (n, 2) f32)."""
    strict_f32_matmul()
    v_rot = vectors.float() @ rotation.T
    labels = kmeans_balanced._predict_long(v_rot, centers, metric=_metric_name(metric),
                                     device=v_rot.device)
    codes, aux = _encode_rotated(v_rot, labels, centers)
    return labels, codes, aux


@obs.spanned("neighbors.ivf_rabitq.build")
@accepts_resources
def build(params: IndexParams, dataset, resources=None, seed: int = 0, device=None) -> Index:
    """Train the rotation and coarse centers, then encode and pack the
    lists. No codebook stage: the build is the coarse k-means and one
    encode pass."""
    x = check_matrix(dataset, device=device, name="dataset").float()
    dev = x.device
    n, dim = x.shape
    if params.n_lists > n:
        raise ValueError(f"n_lists={params.n_lists} > dataset rows {n}")
    rot_dim = rabitq_rot_dim(dim)
    gen = make_generator(seed, dev)
    rotation = _make_rotation(gen, rot_dim, dim, True)
    centers, _ = _coarse_fit(params, x, rotation, gen, seed)
    W = packed_words(rot_dim)
    index = Index(
        params, rotation, centers,
        torch.zeros((params.n_lists, 1, W), dtype=torch.int32, device=dev),
        torch.zeros((params.n_lists, 1, 2), dtype=torch.float32, device=dev),
        torch.full((params.n_lists, 1), -1, dtype=torch.int32, device=dev),
        torch.zeros((params.n_lists,), dtype=torch.int32, device=dev),
        torch.zeros((0,), dtype=torch.int32, device=dev),
    )
    if params.add_data_on_build:
        index = extend(index, x, torch.arange(n, dtype=torch.int32, device=dev))
    from raft_tpu_torch.integrity.digest import attach

    attach(index, "ivf_rabitq")  # the integrity sidecar, kept fresh from here on
    return index


@obs.spanned("neighbors.ivf_rabitq.extend")
def extend(index: Index, new_vectors, new_indices=None) -> Index:
    """Label, encode and append new vectors: one placement grows both
    payload tables (ivf_flat._grow_and_scatter_multi). Returns a new
    Index; its fused store is derived again at its first fused search.
    The mutation state carries over (new tail slots are live); the digest
    sidecar hashes again only the lists the batch touched."""
    from raft_tpu_torch.core import faults
    from raft_tpu_torch.core.bitset import carry_tombstones
    from raft_tpu_torch.integrity.digest import refresh
    from raft_tpu_torch.neighbors.ivf_flat import _append_slots, _grow_and_scatter_multi

    dev = index.device
    nv = check_matrix(new_vectors, device=dev, name="new_vectors").float()
    old_n = index.size
    if new_indices is None:
        new_indices = torch.arange(old_n, old_n + nv.shape[0], dtype=torch.int32, device=dev)
    else:
        new_indices = torch.as_tensor(new_indices, device=dev).to(torch.int32)
    # fault site (host-side, every call): slow_rank a slow encode pass,
    # flaky_bootstrap a transient failure before anything changes
    faults.fault_point(ENCODE_SITE)
    labels, new_codes, new_aux = label_and_encode(nv, index.rotation, index.centers,
                                                  index.metric)
    old_sizes = index.list_sizes.cpu().numpy().astype(np.int64)
    slot_abs, new_sizes, new_max = _append_slots(labels.cpu().numpy(), old_sizes, index.n_lists)
    new_max = max(new_max, int(index.slot_rows.shape[1]))  # a padded store never shrinks
    positions = torch.arange(old_n, old_n + nv.shape[0], dtype=torch.int32, device=dev)
    (codes_tbl, aux_tbl), slot_rows = _grow_and_scatter_multi(
        (index.codes, index.aux), index.slot_rows, (new_codes, new_aux), labels,
        torch.as_tensor(slot_abs, device=dev), positions, new_max)
    all_ids = torch.cat([index.source_ids, new_indices]) if old_n else new_indices
    ds = None
    if index.params.store_dataset:
        ds = nv if index.dataset is None else torch.cat([index.dataset, nv])
    out = Index(index.params, index.rotation, index.centers, codes_tbl, aux_tbl, slot_rows,
                torch.as_tensor(new_sizes, device=dev), all_ids, dataset=ds)
    out.tombstones = carry_tombstones(index.tombstones, int(slot_rows.shape[1]))
    out.mut_cursor = index.mut_cursor
    out.append_slack = index.append_slack
    refresh(out, index, "ivf_rabitq")
    return out


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def _rabitq_query_block(n_probes: int, max_list: int, query_bits: int, words: int) -> int:
    # keep the (qb, np, max_list, bits, W) popcount intersection at about
    # 2^22 elements, the scan's dominant intermediate
    qb = max(1, (1 << 22) // max(1, n_probes * max_list * query_bits * words))
    return int(min(qb, 16))


def _query_consts(qs: torch.Tensor, cent: torch.Tensor, qres: torch.Tensor, ip: bool):
    """Per (query, list) constants of the estimator: (sum of the residual,
    qconst = q . center for inner product, |q - center|^2 for L2). Both
    engines compute them here, so their scores agree. On the CPU they are
    summed in the JAX reference's order (`quantizer.ordered_row_sum`), so
    that the parity tests hold bit for bit; on the card, where there is no
    reference order to replay, each is one float64 sum rounded once to f32
    (the ordered sums are some 75 small launches a batch)."""
    if qres.device.type == "cpu":
        qconst = ordered_row_sum(qs, cent) if ip else ordered_row_sum(qres, qres)
        return ordered_row_sum(qres), qconst
    q64 = qres.double()
    qconst = (qs.double() * cent.double()).sum(-1) if ip else (q64 * q64).sum(-1)
    return q64.sum(-1).float(), qconst.float()


def _search_impl_rabitq(queries, rotation, centers, codes, aux, slot_rows, k: int,
                        n_probes: int, metric: DistanceType,
                        query_bits: int = DEFAULT_QUERY_BITS, plan=None):
    """The materializing scan: per query block, the probed lists' codes
    are gathered and scored by AND+popcount against each (query, probe)
    pair's quantized bit planes (quantizer.binary_dot), then the
    estimator; the slots of probes an adaptive `plan` (keep mask, probes)
    masked read -1. Returns (estimated distances (nq, k), slot-row positions (nq, k)
    int32); past the probed width the tail holds (worst, -1)."""
    nq = queries.shape[0]
    n_lists, max_list, W = codes.shape
    rot_dim = rotation.shape[0]
    ip = metric == DistanceType.InnerProduct
    select_min = not ip
    worst = float("inf") if select_min else float("-inf")
    q_rot, probes, pvalid = _coarse_select(queries, rotation, centers, n_probes, metric, plan)
    rnorm, o_dot = aux[..., 0], aux[..., 1]
    k_sel = int(min(k, n_probes * max_list))
    qb = _rabitq_query_block(n_probes, max_list, query_bits, W)
    vals, rows = [], []
    for s in range(0, nq, qb):
        qs, pr = q_rot[s:s + qb], probes[s:s + qb].long()
        pc = centers[pr]  # (b, np, rot)
        qres = qs[:, None, :].expand_as(pc) if ip else qs[:, None, :] - pc
        planes, lo, delta = quantize_queries(qres, query_bits)  # (b, np, bits, W)
        qsum, qconst = _query_consts(qs[:, None, :], pc, qres, ip)
        cand = codes[pr]  # (b, np, max_list, W)
        pop = torch.sum(popcount32(cand), dim=-1).float()
        s_u = binary_dot(cand, planes[:, :, None])  # (b, np, max_list)
        scores = bitplane_scores(s_u, pop, rnorm[pr], o_dot[pr], lo, delta, qsum[..., None],
                                 qconst[..., None], rot_dim, ip)
        if ip:
            scores = -scores  # the estimated similarity, maximized
        r = slot_rows[pr]
        if pvalid is not None:
            r = torch.where(pvalid[s:s + qb][:, :, None], r, -1)
        r = r.reshape(pr.shape[0], -1)
        scores = torch.where(r >= 0, scores.reshape(r.shape), worst)
        v, pos = _select_k_impl(scores, k_sel, select_min)
        r = torch.gather(r, 1, pos)
        if k_sel < k:  # the output width holds for any k
            v = torch.nn.functional.pad(v, (0, k - k_sel), value=worst)
            r = torch.nn.functional.pad(r, (0, k - k_sel), value=-1)
        vals.append(v)
        rows.append(r)
    v, r = torch.cat(vals), torch.cat(rows)
    if metric == DistanceType.L2SqrtExpanded:
        v = sqrt_f32(torch.clamp(v, min=0.0))
    return v, r.to(torch.int32)


def rerank_depth(k: int, rerank_mult: int) -> int:
    """Candidates the scan keeps for the exact rerank: never below k,
    capped at the 256-row gather bound."""
    return max(int(k), min(int(rerank_mult) * int(k), _MAX_RERANK))


def derive_bitplane_tables(codes: torch.Tensor, aux: torch.Tensor, slot_table: torch.Tensor,
                           lpad: int):
    """The fused store from the slot tables, over any leading axes: pad the
    slot axis to `lpad`, transpose the packed codes to (..., W, L) (slot
    on the fast axis: a thread a slot, neighbouring threads on neighbouring
    words), and stack the per-slot estimator rows [popcount(code), |r|,
    <o, x_bar>]. Pad slots carry zero codes and meta and slot value -1.

    codes (..., S, W) int32, aux (..., S, 2) f32, slot_table (..., S) ->
    (codes_t (..., W, L), meta (..., 3, L), slots_pad (..., L))."""
    extra = lpad - int(codes.shape[-2])
    pad = torch.nn.functional.pad
    codes_p = pad(codes, (0, 0, 0, extra))
    aux_p = pad(aux, (0, 0, 0, extra))
    codes_t = codes_p.transpose(-1, -2).contiguous()
    # per-slot set bits: query-independent, so hoisted to build time
    pop = torch.sum(popcount32(codes_p), dim=-1).float()
    meta = torch.stack([pop, aux_p[..., 0], aux_p[..., 1]], dim=-2).contiguous()
    slots_pad = pad(slot_table, (0, extra), value=-1)
    return codes_t, meta, slots_pad


def build_bitplane_store(index: Index, k: int) -> None:
    """Derive the fused scan's store once (`derive_bitplane_tables`, the
    slot axis lane-padded), and grow the recorded candidate-buffer width
    `fused_kb` to hold k (monotone: a narrower buffer would truncate a
    later larger-k search)."""
    from raft_tpu_torch.ops.fused_scan import fused_kbuf
    from raft_tpu_torch.ops.pq_list_scan import lane_padded

    lpad = lane_padded(int(index.codes.shape[1]))
    if index.codes_t is None or int(index.codes_t.shape[2]) != lpad:
        index.codes_t, index.bp_meta, index.slot_rows_pad = derive_bitplane_tables(
            index.codes, index.aux, index.slot_rows, lpad)
    kb = fused_kbuf(int(k))
    if index.fused_kb is None or kb > index.fused_kb:
        index.fused_kb = kb


def _search_impl_rabitq_fused(queries, rotation, centers, codes_t, bp_meta, slot_rows_pad,
                              k: int, n_probes: int, metric: DistanceType,
                              query_bits: int = DEFAULT_QUERY_BITS, chunk: int = 128,
                              kb: Optional[int] = None, plan=None,
                              setup_impls=("sort", "gather")):
    """List-major bit-plane search: the probe pairs invert to per-list
    chunks, each chunk's residual rows quantize to bit planes through the
    same `quantize_queries` the "xla" engine uses, and one kernel launch
    scores every chunk and keeps each row's exact top-k (the estimator
    in-kernel, ties to the smaller slot); the candidates regroup to query
    order and merge exactly; pairs outside an adaptive `plan`'s mask are
    dropped before the inversion; `setup_impls` is the (invert_impl,
    qs_impl) pair. Returns the `_search_impl_rabitq` contract."""
    from raft_tpu_torch.neighbors.probe_invert import (
        chunk_live_rows,
        gather_query_rows,
        invert_probes_with,
        regroup_merge,
    )
    from raft_tpu_torch.ops.fused_scan import fused_bitplane_topk

    nq = queries.shape[0]
    n_lists, W, L = codes_t.shape
    rot_dim = rotation.shape[0]
    ip = metric == DistanceType.InnerProduct
    q_rot, probes, pvalid = _coarse_select(queries, rotation, centers, n_probes, metric, plan)
    invert_impl, qs_impl = setup_impls
    tables = invert_probes_with(invert_impl, probes, n_lists, chunk, pvalid)
    live = chunk_live_rows(tables.qid_tbl, nq)  # pad rows and empty chunks skip in-kernel
    q_pad = torch.cat([q_rot, q_rot.new_zeros((1, rot_dim))])
    qs = gather_query_rows(q_pad, tables.qid_tbl, qs_impl)  # (ncb, chunk, rot)
    lof = tables.lof
    cent = centers[lof.long()][:, None, :]
    qres = qs if ip else qs - cent
    planes, lo, delta = quantize_queries(qres, query_bits)
    planes = planes.reshape(planes.shape[0], planes.shape[1], -1).contiguous()
    qsum, qconst = _query_consts(qs, cent, qres, ip)
    qmeta = torch.stack([lo[..., 0], delta[..., 0], qsum, qconst], dim=1).contiguous()
    base = torch.where(slot_rows_pad >= 0, 0.0, float("inf"))[:, None, :].contiguous()
    vals, slot_idx = fused_bitplane_topk(lof, planes, codes_t, bp_meta, base, qmeta, k,
                                         rot_dim=rot_dim, bits=query_bits, kbuf=kb,
                                         inner_product=ip, chunk_rows=live)
    vals, slot_idx = vals[:, :, :k], slot_idx[:, :, :k]
    invalid = ~torch.isfinite(vals)
    slot_idx = torch.where(invalid, 0, slot_idx).long()  # sentinel -> safe gather
    rows = torch.gather(slot_rows_pad[lof.long()][:, None, :].expand(-1, chunk, -1), 2, slot_idx)
    rows = torch.where(invalid, -1, rows)
    if ip:  # the kernel returned the negated estimated similarity
        vals = torch.where(invalid, float("-inf"), -vals)
    v, rows_out = regroup_merge(tables, vals, rows, _select_k_impl, nq, n_probes, int(k),
                                not ip)
    if metric == DistanceType.L2SqrtExpanded:
        v = sqrt_f32(torch.clamp(v, min=0.0))
    return v, rows_out.to(torch.int32)


@obs.spanned("neighbors.ivf_rabitq.search")
@auto_convert_output
@accepts_resources
def search(params: SearchParams, index: Index, queries, k: int, resources=None, prefilter=None,
           refine_dataset=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN search; returns (distances (nq, k) f32, neighbor source ids
    (nq, k) int32, -1 where fewer than k candidates exist), on the index's
    device.

    The scan ranks candidates by the RaBitQ estimator. With raw rows (the
    index stored them, or `refine_dataset`, rows in insertion order) the
    best rerank_depth(k, rerank_mult) candidates re-rank exactly through
    neighbors/refine and the distances are exact; without, the estimator
    ranking and its estimates are returned. An explicit
    scan_engine="fused" is checked against the kernel's caps (k <= 256)
    before the fused store is derived. `prefilter`: a `core.bitset.Bitset`
    or 1-d boolean mask over the index's id space (`index.id_bound` ids);
    samples whose bit is clear are excluded before the scan's selection."""
    from raft_tpu_torch.core.bitset import make_slot_filter
    from raft_tpu_torch.matrix.select_k import check_bitplane_request, resolve_bitplane_strategy
    from raft_tpu_torch.neighbors.probe_invert import macro_batched, resolve_setup_impls
    from raft_tpu_torch.ops.fused_scan import FUSED_MAX_K, fused_kbuf
    from raft_tpu_torch.ops.pq_list_scan import lane_padded

    if params.scan_engine not in ("auto", "xla", "fused"):
        raise ValueError(f"unknown scan_engine {params.scan_engine!r}")
    q = check_matrix(queries, device=index.device, name="queries").float()
    if q.shape[1] != index.dim:
        raise ValueError(f"query dim {q.shape[1]} != index dim {index.dim}")
    if index.size == 0:
        raise ValueError("index is empty")
    k = int(k)
    if k <= 0:
        raise ValueError("k must be positive")
    dev = index.device
    n_probes = int(min(max(1, params.n_probes), index.n_lists))
    query_bits = resolve_query_bits(params.query_bits, dev)
    rerank_mult = resolve_rerank_mult(params.rerank_mult, dev)
    ds = index.dataset
    if refine_dataset is not None:
        ds = check_matrix(refine_dataset, device=index.device, name="refine_dataset")
    kk = rerank_depth(k, rerank_mult) if ds is not None else k
    maybe_filter = make_slot_filter(prefilter, index.id_bound, index.source_ids,
                                    tombstones=index.tombstones)

    lpad = lane_padded(int(index.codes.shape[1]))
    if params.scan_engine == "fused":
        check_bitplane_request("scan_engine='fused'", lpad, index.words, query_bits, kk,
                               index.fused_kb, "scan_engine='xla'")
        strat = "fused_bitplane"
    elif params.scan_engine == "auto" and 0 < kk <= FUSED_MAX_K:
        strat = resolve_bitplane_strategy(lpad, index.words, query_bits, kk,
                                          kbuf=max(fused_kbuf(kk), index.fused_kb or 0),
                                          device=dev)
    else:
        strat = "xla"

    # the plan's depth is kk: the rerank shortlist must survive the bounds;
    # bounds off under a prefilter or tombstones (the sizes count the
    # members they drop)
    ap = probe_budget.resolve_params(params, n_probes, dev)
    plan = probe_budget.search_plan(
        ap, q, index.centers, n_probes=n_probes,
        k=kk, metric=index.metric, rotation=index.rotation,
        radii=index.list_radii if prefilter is None and index.tombstones is None else None,
        sizes=index.list_sizes)
    if obs.enabled():
        scanned_mean = (probe_budget.account_plan("ivf_rabitq", plan, q.shape[0], n_probes)
                        if ap is not None else None)
        # padded slots of each probed list are scanned too; the fused
        # engine charges popcounts at the integer rate and no score bytes
        obs.span_cost(**obs.perf.cost_for(
            "neighbors.ivf_rabitq.search", nq=int(q.shape[0]),
            n_probes=scanned_mean if scanned_mean is not None else n_probes,
            n_lists=int(index.n_lists),
            n_rows=int(index.codes.shape[0] * index.codes.shape[1]) - index.n_tombstones,
            dim=int(index.dim), k=k, query_bits=int(query_bits),
            rerank_mult=int(rerank_mult) if ds is not None else 0,
            fused=strat == "fused_bitplane"))
    if strat == "fused_bitplane":
        build_bitplane_store(index, kk)
        kb = index.fused_kb
        srows_pad = maybe_filter(index.slot_rows_pad)
        # the flat engines' query-row gate: the planes quantize exact rows
        setup = resolve_setup_impls(index.n_lists, "flat", dev)
        vals, rows = macro_batched(
            lambda sl, pl=None: _search_impl_rabitq_fused(
                sl, index.rotation, index.centers, index.codes_t, index.bp_meta,
                srows_pad, kk, n_probes, index.metric, query_bits=query_bits, kb=kb,
                plan=pl, setup_impls=setup),
            q, kk, extra=plan)
    else:
        vals, rows = _search_impl_rabitq(q, index.rotation, index.centers, index.codes,
                                         index.aux, maybe_filter(index.slot_rows), kk,
                                         n_probes, index.metric, query_bits=query_bits,
                                         plan=plan)
    if ds is not None:
        # candidates are dataset positions (insertion order; -1 skipped)
        quant = RabitqQuantizer(index.rot_dim, query_bits)
        vals, rows = quant.rerank_candidates(ds, q, rows, k, metric=index.metric)
    ids = torch.where(rows >= 0, index.source_ids[torch.clamp(rows, min=0).long()], -1)
    return vals, ids.to(torch.int32)
