"""IVF-PQ: product-quantized inverted-file ANN index (counterpart of
raft_tpu/neighbors/ivf_pq.py).

Build: trainset subsample -> rotation -> balanced k-means coarse centers
-> per-subspace PQ codebooks on the trainset residuals -> encode and pack
every row into the padded (n_lists, max_list, pq_dim) code table.

Search: score_mode="recon8_list", the list-major engine. The codes are
decoded once into a per-dimension int8 reconstruction store, lane-padded
to a multiple of 128 slots; the probe pairs of a query batch are
inverted into per-list chunks (probe_invert), each chunk's list is
scored and trimmed by one kernel launch, and the per-(query, probe)
candidates regroup to query-major order and merge exactly. Two trims:

  trim_engine="fused"   an exact top-k per chunk row, ties to the smaller
                        slot: `fused_list_topk` (bf16 rows) or, with
                        score_dtype="int8", `fused_list_topk_int8`
                        (ops/fused_scan.py);
  trim_engine="pallas"  the bin fold, best and second best in each of 256
                        bins per row (`ops/pq_list_scan.py`), then an exact
                        top-min(k, 256) of the 512 candidates; k <= 256.

score_dtype="int8" quantizes each scale-folded residual row to symmetric
int8 (`_quantize_query_rows`) and scores int8 x int8 -> int32 with the
per-row scale; both trims score the same f32 values. CUDA kernels on the
card, their plain versions on the CPU.

A `prefilter` (a `core.bitset.Bitset` or boolean mask over the index's
ids) is one view of the padded slot table: filtered slots read -1, so
both trims see +inf base there and the refine never sees a filtered row.

Not ported yet (each raises NotImplementedError naming ROADMAP Queue A):
the lut and recon8 score modes, score_mode="auto", the approx, exact and
auto trims, adaptive probing, tombstones, per-cluster codebooks, more
than 1024 lists (the hierarchical trainer). Integrity digests, list
radii, observability spans, fault hooks and save/load are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core.config import resolve_device, strict_f32_matmul
from raft_tpu_torch.core.validation import check_matrix
from raft_tpu_torch.distance.distance_types import DistanceType, resolve_metric
from raft_tpu_torch.matrix.select_k import _select_k_impl
from raft_tpu_torch.neighbors.quantizer import PER_CLUSTER, PER_SUBSPACE, PqQuantizer
from raft_tpu_torch.random.rng import make_generator, sample_without_replacement


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue A: the port runs "
        "score_mode='recon8_list' with trim_engine 'fused' or 'pallas')"
    )


@dataclasses.dataclass
class IndexParams:
    """Mirrors ivf_pq::index_params (ivf_pq_types.hpp:43-110)."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    metric_arg: float = 2.0
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    pq_bits: int = 8
    pq_dim: int = 0  # 0 = auto (dim/4 rounded to a multiple of 8)
    codebook_kind: str = PER_SUBSPACE
    force_random_rotation: bool = False
    add_data_on_build: bool = True

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)
        if not (4 <= self.pq_bits <= 8):
            raise ValueError("pq_bits must be in [4, 8]")
        if self.pq_dim < 0:
            raise ValueError(f"pq_dim must be >= 0 (0 = auto), got {self.pq_dim}")
        if self.codebook_kind not in (PER_SUBSPACE, PER_CLUSTER):
            raise ValueError(f"bad codebook_kind {self.codebook_kind}")


@dataclasses.dataclass
class SearchParams:
    """Mirrors ivf_pq::search_params (ivf_pq_types.hpp:112-150). The
    defaults name the fused exact trim on bf16 rows; trim_engine="pallas"
    and score_dtype="int8" are the other engines the port runs."""

    n_probes: int = 20
    score_mode: str = "recon8_list"
    trim_engine: str = "fused"
    score_dtype: str = "bf16"
    adaptive: bool = False


class Index:
    """IVF-PQ index (tensors on one device).

    rotation   (rot_dim, dim) f32 orthogonal input transform
    centers    (n_lists, rot_dim) f32 coarse centroids (rotated space)
    pq_centers (pq_dim, 2^bits, pq_len) f32 per-subspace codebooks
    codes      (n_lists, max_list, pq_dim) uint8 slot table
    slot_rows  (n_lists, max_list) int32 -> row position, -1 empty
    list_sizes (n_lists,) int32; source_ids (n_rows,) int32

    The reconstruction store is built at the first search:
    recon8 (n_lists, lpad, rot_dim) int8, recon_scale (rot_dim,) f32,
    recon_norm (n_lists, lpad) f32 (+inf on pad slots), slot_rows_pad
    (n_lists, lpad) int32 (-1 on pad slots), lpad a multiple of 128.
    """

    def __init__(self, params, rotation, centers, pq_centers, codes, slot_rows,
                 list_sizes, source_ids):
        self.params = params
        self.rotation = rotation
        self.centers = centers
        self.pq_centers = pq_centers
        self.codes = codes
        self.slot_rows = slot_rows
        self.list_sizes = list_sizes
        self.source_ids = source_ids
        self.recon8 = None
        self.recon_scale = None
        self.recon_norm = None
        self.slot_rows_pad = None
        # fused-trim candidate-buffer width, grown monotonically when a
        # later search's k outruns it
        self.fused_kb = None
        self._id_bound = None

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def metric(self):
        return self.params.metric

    @property
    def n_lists(self):
        return int(self.centers.shape[0])

    @property
    def dim(self):
        return int(self.rotation.shape[1])

    @property
    def rot_dim(self):
        return int(self.rotation.shape[0])

    @property
    def pq_dim(self):
        return int(self.codes.shape[2])

    @property
    def pq_len(self):
        return self.rot_dim // self.pq_dim

    @property
    def pq_bits(self):
        return int(self.params.pq_bits)

    @property
    def size(self):
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
        return (
            f"ivf_pq.Index(n_lists={self.n_lists}, dim={self.dim}, pq_dim={self.pq_dim}, "
            f"pq_bits={self.pq_bits}, size={self.size}, metric={self.metric.name}, "
            f"device={self.device})"
        )


#: the JAX Index fields `index_from_arrays` takes
INDEX_FIELDS = ("rotation", "centers", "pq_centers", "codes", "slot_rows",
                "list_sizes", "source_ids")


def index_from_arrays(arrays: Dict[str, np.ndarray], params: IndexParams,
                      device=None) -> Index:
    """The port's Index from the JAX Index fields as numpy arrays
    (`INDEX_FIELDS`, raft_tpu/neighbors/ivf_pq.py:185-207), so both
    packages can search one identical index."""
    dev = resolve_device(device)
    missing = [f for f in INDEX_FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"index_from_arrays: missing fields {missing}")
    if params.codebook_kind != PER_SUBSPACE:
        raise _not_ported("codebook_kind='per_cluster'")
    dtypes = {"codes": torch.uint8, "slot_rows": torch.int32,
              "list_sizes": torch.int32, "source_ids": torch.int32}
    t = {f: torch.as_tensor(np.array(arrays[f]))
         .to(device=dev, dtype=dtypes.get(f, torch.float32)) for f in INDEX_FIELDS}
    return Index(params, t["rotation"], t["centers"], t["pq_centers"], t["codes"],
                 t["slot_rows"], t["list_sizes"], t["source_ids"])


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _auto_pq_dim(dim: int) -> int:
    # ivf_pq_types.hpp pq_dim==0 heuristic: dim/4 rounded down to mult of 8
    d = max(1, dim // 4)
    if d > 8:
        d = d // 8 * 8
    return d


def _make_rotation(gen: torch.Generator, rot_dim: int, dim: int,
                   force_random: bool) -> torch.Tensor:
    """Random orthogonal rotation via QR of a gaussian
    (ivf_pq_build.cuh:177 make_rotation_matrix); identity when no
    rotation is needed."""
    dev = gen.device
    if not force_random and rot_dim == dim:
        return torch.eye(dim, dtype=torch.float32, device=dev)
    m = max(rot_dim, dim)
    g = torch.randn((m, m), generator=gen, device=dev)
    q, r = torch.linalg.qr(g)
    q = q * torch.sign(torch.diagonal(r))[None, :]  # sign fix: Haar rotation
    return q[:rot_dim, :dim].contiguous()


def _metric_name(metric: DistanceType) -> str:
    return "inner_product" if metric == DistanceType.InnerProduct else "sqeuclidean"


def _coarse_fit(params: IndexParams, x: torch.Tensor, rotation: torch.Tensor,
                gen: torch.Generator, seed: int):
    """Trainset-fraction subsample, rotate, balanced k-means. Returns
    (centers, rotated trainset)."""
    n = x.shape[0]
    frac = min(max(params.kmeans_trainset_fraction, 0.0), 1.0)
    n_train = min(n, max(params.n_lists * 4, int(n * frac)))
    strict_f32_matmul()
    if n_train < n:
        x_train_rot = x[sample_without_replacement(gen, n, n_train)] @ rotation.T
    else:
        x_train_rot = x @ rotation.T
    if params.n_lists > 1024:
        raise _not_ported("n_lists > 1024 (kmeans_balanced.fit_hierarchical)")
    centers = kmeans_balanced.fit(x_train_rot, params.n_lists, n_iters=params.kmeans_n_iters,
                                  metric=_metric_name(params.metric), seed=seed,
                                  device=x.device)
    return centers, x_train_rot


def build(params: IndexParams, dataset, seed: int = 0, device=None) -> Index:
    """Train rotation, coarse centers and codebooks; encode and pack the
    dataset (detail/ivf_pq_build.cuh:1074)."""
    if params.codebook_kind != PER_SUBSPACE:
        raise _not_ported("codebook_kind='per_cluster'")
    x = check_matrix(dataset, device, name="dataset").float()
    dev = x.device
    n, dim = x.shape
    if params.n_lists > n:
        raise ValueError(f"n_lists={params.n_lists} > dataset rows {n}")
    pq_dim = params.pq_dim or _auto_pq_dim(dim)
    pq_len = -(-dim // pq_dim)
    rot_dim = pq_dim * pq_len
    gen = make_generator(seed, dev)
    rotation = _make_rotation(gen, rot_dim, dim,
                              params.force_random_rotation or rot_dim != dim)
    centers, x_train_rot = _coarse_fit(params, x, rotation, gen, seed)

    # codebooks from (a capped sample of) the trainset residuals
    nb = 1 << params.pq_bits
    max_cb_rows = max(65536, 64 * nb)
    n_train = x_train_rot.shape[0]
    if n_train > max_cb_rows:
        x_cb = x_train_rot[sample_without_replacement(gen, n_train, max_cb_rows)]
    else:
        x_cb = x_train_rot
    train_labels = kmeans_balanced.predict(x_cb, centers, metric=_metric_name(params.metric),
                                           device=dev)
    residuals = x_cb - centers[train_labels]
    quant = PqQuantizer(pq_bits=params.pq_bits, pq_dim=pq_dim, pq_len=pq_len,
                        n_lists=params.n_lists)
    pq_centers = quant.train(gen, residuals).pq_centers

    index = Index(
        params, rotation, centers, pq_centers,
        torch.zeros((params.n_lists, 1, pq_dim), dtype=torch.uint8, device=dev),
        torch.full((params.n_lists, 1), -1, dtype=torch.int32, device=dev),
        torch.zeros((params.n_lists,), dtype=torch.int32, device=dev),
        torch.zeros((0,), dtype=torch.int32, device=dev),
    )
    if params.add_data_on_build:
        index = extend(index, x, torch.arange(n, dtype=torch.int32, device=dev))
    return index


def label_and_encode(vectors: torch.Tensor, rotation: torch.Tensor, centers: torch.Tensor,
                     pq_centers: torch.Tensor, metric: DistanceType,
                     per_cluster: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate, assign to coarse lists, and PQ-encode the residuals.
    Returns (labels (n,) int64, codes (n, pq_dim) uint8)."""
    strict_f32_matmul()
    v_rot = vectors.float() @ rotation.T
    labels = kmeans_balanced.predict(v_rot, centers, metric=_metric_name(metric),
                                     device=v_rot.device)
    residuals = v_rot - centers[labels]
    codes = PqQuantizer.from_centers(pq_centers, per_cluster).encode(residuals)["codes"]
    return labels, codes


def extend(index: Index, new_vectors, new_indices=None) -> Index:
    """Label, encode and append new vectors (ivf_pq_build.cuh:1061):
    only the new batch is encoded and placed into grown code tables."""
    from raft_tpu_torch.neighbors.ivf_flat import _append_slots, _grow_and_scatter

    dev = index.device
    nv = check_matrix(new_vectors, dev, name="new_vectors").float()
    old_n = index.size
    if new_indices is None:
        new_indices = torch.arange(old_n, old_n + nv.shape[0], dtype=torch.int32, device=dev)
    else:
        new_indices = torch.as_tensor(new_indices, device=dev).to(torch.int32)
    labels, new_codes = label_and_encode(nv, index.rotation, index.centers,
                                         index.pq_centers, index.metric)
    labels_np = labels.cpu().numpy()
    old_sizes = index.list_sizes.cpu().numpy().astype(np.int64)
    slot_abs, new_sizes, new_max = _append_slots(labels_np, old_sizes, index.n_lists)
    new_max = max(new_max, int(index.codes.shape[1]))  # a padded store never shrinks
    positions = torch.arange(old_n, old_n + nv.shape[0], dtype=torch.int32, device=dev)
    codes_tbl, slot_rows = _grow_and_scatter(
        index.codes, index.slot_rows, new_codes, labels,
        torch.as_tensor(slot_abs, device=dev), positions, new_max)
    all_ids = torch.cat([index.source_ids, new_indices]) if old_n else new_indices
    return Index(index.params, index.rotation, index.centers, index.pq_centers,
                 codes_tbl, slot_rows, torch.as_tensor(new_sizes, device=dev), all_ids)


# ---------------------------------------------------------------------------
# int8 reconstruction store
# ---------------------------------------------------------------------------


def _decode_quantize(codes: torch.Tensor, pq_centers: torch.Tensor,
                     per_cluster: bool = False, list_block: int = 64):
    """Decode PQ codes to per-dimension symmetric int8 and the decoded
    norms: (recon8 (L, S, rot) int8, scale (rot,) f32, rnorm (L, S) f32).
    The scale is a per-dimension max-abs over the codebooks, so it bounds
    every reconstruction without a pass over the decoded data."""
    if per_cluster:
        raise _not_ported("codebook_kind='per_cluster'")
    n_lists, max_list, pq_dim = codes.shape
    pq_len = pq_centers.shape[-1]
    rot_dim = pq_dim * pq_len
    amax = torch.amax(torch.abs(pq_centers), dim=1)  # (pq_dim, pq_len)
    # times the reciprocal, not a division: the JAX reference compiles
    # its division by the constant 127 to this multiply, and the scale
    # must agree with it bit for bit
    scale = torch.clamp(amax.reshape(rot_dim) * (1.0 / 127.0), min=1e-12)
    inv = (1.0 / scale).reshape(pq_dim, pq_len)
    scale_pl = scale.reshape(pq_dim, pq_len)
    dev = codes.device
    recon8 = torch.empty((n_lists, max_list, rot_dim), dtype=torch.int8, device=dev)
    rnorm = torch.empty((n_lists, max_list), dtype=torch.float32, device=dev)
    sub = torch.arange(pq_dim, device=dev)[None, None, :]
    for s in range(0, n_lists, list_block):
        idx = codes[s:s + list_block].long()
        rec = pq_centers[sub, idx]  # (lb, S, P, pl)
        q = torch.clamp(torch.round(rec * inv), -127, 127)
        deq = q * scale_pl
        rnorm[s:s + list_block] = torch.sum((deq * deq).reshape(*q.shape[:2], -1), dim=-1)
        recon8[s:s + list_block] = q.to(torch.int8).reshape(*q.shape[:2], rot_dim)
    return recon8, scale, rnorm


def build_reconstruction(index: Index) -> Index:
    """Populate the int8 reconstruction store, once (the JAX package's
    `build_reconstruction(pad_to_lanes=True)`, the form both trims run).
    The slot axis is padded to `lane_padded(max_list)`, the list kernels'
    shape contract: pad slots get slot_rows_pad = -1 and recon_norm =
    +inf, so they are masked like in-list padding."""
    if index.recon8 is None:
        from raft_tpu_torch.ops.pq_list_scan import lane_padded

        r8, scale, rnorm = _decode_quantize(index.codes, index.pq_centers)
        extra = lane_padded(r8.shape[1]) - r8.shape[1]
        pad = torch.nn.functional.pad
        index.recon8 = pad(r8, (0, 0, 0, extra))
        index.recon_scale = scale
        index.recon_norm = pad(rnorm, (0, extra), value=float("inf"))
        index.slot_rows_pad = pad(index.slot_rows, (0, extra), value=-1)
    return index


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def _quantize_query_rows(u: torch.Tensor):
    """Symmetric per-row int8 quantization (u ~= q8 * row_scale), shared
    by both trims' int8 rows, so their scores agree bit for bit. The
    scale is times the f32 reciprocal of 127, not a division: the JAX
    reference compiles its division by the constant to this multiply, and
    every int8 score is `f32(idot) * row_scale`."""
    ua = torch.amax(torch.abs(u), dim=-1, keepdim=True) + 1e-12
    q8 = torch.clamp(torch.round(u / ua * 127.0), -127, 127).to(torch.int8)
    return q8, ua * (1.0 / 127.0)


def _coarse_select(queries: torch.Tensor, rotation: torch.Tensor, centers: torch.Tensor,
                   n_probes: int, metric: DistanceType):
    """Rotate queries and pick the n_probes closest coarse centers
    (select_clusters, ivf_pq_search.cuh:133). Returns (q_rot, probes)."""
    from raft_tpu_torch.distance.pairwise import _dot

    strict_f32_matmul()
    q_rot = queries.float() @ rotation.T
    cd = _dot(q_rot, centers)
    if metric == DistanceType.InnerProduct:
        coarse = cd
    else:
        # the query norm is constant per row; the ranking is unaffected
        coarse = torch.sum(centers * centers, dim=1)[None, :] - 2.0 * cd
    _, probes = _select_k_impl(coarse, n_probes, metric != DistanceType.InnerProduct)
    return q_rot, probes


class _ListMajorBatch(NamedTuple):
    """One query batch's list-major operands, shared by both trims."""

    tables: object       # probe_invert.ChunkTables
    live: torch.Tensor   # (ncb,) int32 live leading rows of each chunk
    qs: torch.Tensor     # (ncb, chunk, rot) rotated query rows
    cent: torch.Tensor   # (ncb, rot) each chunk's list center
    qres: torch.Tensor   # (ncb, chunk, rot) residuals (IP: the rows)
    qres_s: torch.Tensor  # residuals with the store's scale folded in
    base: torch.Tensor   # (n_lists, 1, L) per-slot base, +inf invalid


def _listmajor_batch(queries, rotation, centers, recon_scale, recon_norm, slot_rows_pad,
                     n_probes: int, metric: DistanceType, chunk: int) -> _ListMajorBatch:
    """Coarse select, probe inversion, query-row gather, residuals and
    the additive per-slot base (L2: recon norm; IP: 0; +inf invalid)."""
    from raft_tpu_torch.neighbors.probe_invert import (
        chunk_live_rows,
        gather_query_rows,
        invert_probes_sort,
    )

    nq = queries.shape[0]
    n_lists, rot_dim = centers.shape
    ip = metric == DistanceType.InnerProduct
    q_rot, probes = _coarse_select(queries, rotation, centers, n_probes, metric)
    tables = invert_probes_sort(probes, n_lists, chunk)
    live = chunk_live_rows(tables.qid_tbl, nq)  # pad rows and empty chunks skip in-kernel
    q_pad = torch.cat([q_rot, q_rot.new_zeros((1, rot_dim))])
    qs = gather_query_rows(q_pad, tables.qid_tbl)  # (ncb, chunk, rot)
    cent = centers[tables.lof.long()]
    qres = qs if ip else qs - cent[:, None, :]
    qres_s = (qres * recon_scale[None, None, :]).contiguous()
    valid = slot_rows_pad >= 0
    fill = torch.where(valid, 0.0, float("inf")) if ip else torch.where(valid, recon_norm,
                                                                        float("inf"))
    return _ListMajorBatch(tables, live, qs, cent, qres, qres_s, fill[:, None, :].contiguous())


def _candidates(b: _ListMajorBatch, vals, slot_idx, slot_rows_pad, ip: bool):
    """A trim's minimizing (ncb, chunk, w) candidates -> (values with the
    per-query constants added back, slot-row positions), -1 and the worst
    value where a candidate is not finite."""
    invalid = ~torch.isfinite(vals)
    slot_idx = torch.where(invalid, 0, slot_idx).long()  # sentinel -> safe gather
    lof = b.tables.lof.long()
    rows = torch.gather(slot_rows_pad[lof][:, None, :].expand(-1, slot_idx.shape[1], -1),
                        2, slot_idx)
    rows = torch.where(invalid, -1, rows)
    if ip:
        qdotc = torch.einsum("cqd,cd->cq", b.qs, b.cent)
        return torch.where(invalid, float("-inf"), -vals + qdotc[:, :, None]), rows
    return vals + torch.sum(b.qres * b.qres, dim=2)[:, :, None], rows


def _merge(b: _ListMajorBatch, vals, rows, nq: int, n_probes: int, k: int,
           metric: DistanceType):
    from raft_tpu_torch.neighbors.probe_invert import regroup_merge

    v, rows_out = regroup_merge(b.tables, vals, rows, _select_k_impl, nq, n_probes, int(k),
                                metric != DistanceType.InnerProduct)
    if metric == DistanceType.L2SqrtExpanded:
        v = torch.sqrt(torch.clamp(v, min=0.0))
    return v.float(), rows_out


def _search_impl_recon8_listmajor_fused(queries, rotation, centers, recon8, recon_scale,
                                        recon_norm, slot_rows_pad, k: int, n_probes: int,
                                        metric: DistanceType, chunk: int = 128,
                                        kb: Optional[int] = None, int8_queries: bool = False):
    """List-major search with the fused distance + exact select-k trim:
    one kernel launch scores every chunk's list straight out of the int8
    store and keeps each row's exact top-k (ties to the smaller slot);
    the (chunk, L) scores never reach device memory. With `int8_queries`
    the rows quantize through `_quantize_query_rows`, as the pallas
    trim's do, and score int8 x int8 -> int32 ("fused_int8"). Returns
    (values, slot-row positions) (nq, k)."""
    from raft_tpu_torch.matrix.select_k import list_scan_select_k

    ip = metric == DistanceType.InnerProduct
    b = _listmajor_batch(queries, rotation, centers, recon_scale, recon_norm, slot_rows_pad,
                         n_probes, metric, chunk)
    lof = b.tables.lof
    if int8_queries:
        q8, row_scale = _quantize_query_rows(b.qres_s)
        vals, slot_idx = list_scan_select_k(lof, q8, recon8, b.base, k, strategy="fused_int8",
                                            q_scale=row_scale, kbuf=kb, inner_product=ip,
                                            chunk_rows=b.live)
    else:
        vals, slot_idx = list_scan_select_k(lof, b.qres_s, recon8, b.base, k, strategy="fused",
                                            kbuf=kb, inner_product=ip, chunk_rows=b.live)
    vals, rows = _candidates(b, vals[:, :, :k], slot_idx[:, :, :k], slot_rows_pad, ip)
    return _merge(b, vals, rows, queries.shape[0], n_probes, k, metric)


def _search_impl_recon8_listmajor_pallas(queries, rotation, centers, recon8, recon_scale,
                                         recon_norm, slot_rows_pad, k: int, n_probes: int,
                                         metric: DistanceType, chunk: int = 128,
                                         int8_queries: bool = False, fold: str = "exact"):
    """List-major search with the bin-fold trim (ops/pq_list_scan.py):
    per chunk, one kernel launch scores the list and folds each row's
    scores into 256 bins, best and second best each, so only (chunk, 512)
    candidates reach device memory; an exact top-min(k, 256) of them per
    row and the shared exact merge finish. With `int8_queries` the rows
    quantize through `_quantize_query_rows` and score int8 x int8 ->
    int32, the same f32 values as the fused int8 trim's. Returns (values,
    slot-row positions) (nq, k)."""
    from raft_tpu_torch.ops.pq_list_scan import _BINS, pq_list_scan

    ip = metric == DistanceType.InnerProduct
    b = _listmajor_batch(queries, rotation, centers, recon_scale, recon_norm, slot_rows_pad,
                         n_probes, metric, chunk)
    lof = b.tables.lof
    if int8_queries:
        q8, row_scale = _quantize_query_rows(b.qres_s)
        vals, slot_idx = pq_list_scan(lof, q8, recon8, b.base, inner_product=ip,
                                      q_scale=row_scale, fold=fold, chunk_rows=b.live)
    else:
        vals, slot_idx = pq_list_scan(lof, b.qres_s, recon8, b.base, inner_product=ip,
                                      fold=fold, chunk_rows=b.live)  # (ncb, chunk, 512)
    vals, rows = _candidates(b, vals, slot_idx, slot_rows_pad, ip)
    # trim the bin candidates to the merge width kk (a small exact top-k)
    ncb, rows_per, cands = vals.shape
    kk = min(int(k), _BINS)
    tv, tpos = _select_k_impl(vals.reshape(ncb * rows_per, cands), kk, not ip)
    tr = torch.gather(rows.reshape(ncb * rows_per, cands), 1, tpos)
    return _merge(b, tv.reshape(ncb, rows_per, kk), tr.reshape(ncb, rows_per, kk),
                  queries.shape[0], n_probes, k, metric)


def search(params: SearchParams, index: Index, queries, k: int, prefilter=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN search; returns (distances (nq, k) f32, neighbor source ids
    (nq, k) int32, -1 where fewer than k candidates exist), on the
    index's device. Caps and shared-memory budgets are checked before
    the first search builds the index's reconstruction store, so a
    rejected request leaves the index as it was. `prefilter`: a
    `core.bitset.Bitset` or 1-d boolean mask over the index's id space
    (`index.id_bound` ids); samples whose bit is clear are excluded
    before either trim."""
    from raft_tpu_torch.core.bitset import make_slot_filter
    from raft_tpu_torch.matrix.select_k import check_fused_list_request
    from raft_tpu_torch.neighbors.probe_invert import macro_batched
    from raft_tpu_torch.ops.pq_list_scan import _BINS, fits_pq_list_scan, fold_variant, lane_padded

    if params.score_dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown score_dtype {params.score_dtype!r}")
    int8 = params.score_dtype == "int8"
    mode = params.score_mode
    if mode == "auto":
        raise _not_ported("score_mode='auto'")
    if int8 and mode != "recon8_list":
        raise ValueError(
            f"score_dtype='int8' requires score_mode 'recon8_list' or 'auto', got {mode!r}")
    if mode != "recon8_list":
        raise _not_ported(f"score_mode={mode!r}")
    trim = params.trim_engine
    if trim not in ("auto", "approx", "exact", "pallas", "fused"):
        raise ValueError(f"unknown trim_engine {trim!r}")
    if trim not in ("fused", "pallas"):
        raise _not_ported(f"trim_engine={trim!r}")
    if params.adaptive:
        raise _not_ported("adaptive probing")
    q = check_matrix(queries, index.device, name="queries").float()
    if q.shape[1] != index.dim:
        raise ValueError(f"query dim {q.shape[1]} != index dim {index.dim}")
    if index.size == 0:
        raise ValueError("index is empty")
    n_probes = int(min(max(1, params.n_probes), index.n_lists))
    lpad = lane_padded(int(index.codes.shape[1]))
    # a filtered view of the padded slot table is the whole prefilter:
    # both trims put +inf base where it reads -1
    maybe_filter = make_slot_filter(prefilter, index.id_bound, index.source_ids)
    if trim == "fused":
        # at the buffer width the kernel will run with
        kb = check_fused_list_request("trim_engine='fused'", lpad, index.rot_dim, int(k),
                                      index.fused_kb, "trim_engine='pallas'", q_int8=int8)
        build_reconstruction(index)
        index.fused_kb = kb
        srows_pad = maybe_filter(index.slot_rows_pad)

        def run(sl):
            return _search_impl_recon8_listmajor_fused(
                sl, index.rotation, index.centers, index.recon8, index.recon_scale,
                index.recon_norm, srows_pad, int(k), n_probes, index.metric, kb=kb,
                int8_queries=int8)
    else:
        if int(k) > _BINS:
            raise ValueError(f"trim_engine='pallas' caps per-list candidates at {_BINS}; k={k}")
        if not fits_pq_list_scan(lpad, index.rot_dim, int8):
            raise ValueError(
                f"trim_engine='pallas': list length {lpad} or rot_dim {index.rot_dim} exceed "
                "the kernel's shared-memory budget; use trim_engine='fused'")
        build_reconstruction(index)
        fold = fold_variant()
        srows_pad = maybe_filter(index.slot_rows_pad)

        def run(sl):
            return _search_impl_recon8_listmajor_pallas(
                sl, index.rotation, index.centers, index.recon8, index.recon_scale,
                index.recon_norm, srows_pad, int(k), n_probes, index.metric,
                int8_queries=int8, fold=fold)

    vals, rows = macro_batched(run, q, int(k))
    ids = torch.where(rows >= 0, index.source_ids[torch.clamp(rows, min=0).long()], -1)
    return vals, ids.to(torch.int32)
