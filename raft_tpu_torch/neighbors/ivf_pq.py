"""IVF-PQ: product-quantized inverted-file ANN index (counterpart of
raft_tpu/neighbors/ivf_pq.py).

Build: trainset subsample -> rotation -> balanced k-means coarse centers
(`kmeans_balanced.fit_hierarchical` past 1024 lists) -> PQ codebooks on
the trainset residuals, per subspace or per cluster (`codebook_kind`)
-> encode and pack every row into the padded (n_lists, max_list, pq_dim)
code table.

Search, `score_mode`:

  "lut"          query-major: per (query, probe) a (pq_dim, 2^pq_bits)
                 table of sub-distances (`lut_dtype` f32 or bf16), the
                 codes' entries gathered and summed; queries in blocks of
                 at most `LUT_BLOCK_ELEMS` gathered entries;
  "recon8"       query-major over the int8 reconstruction store: each
                 query's probed lists dequantized to bf16 and scored, in
                 blocks of at most `RECON8_BLOCK_ELEMS` store values;
  "recon8_list"  list-major over the same store: the probe pairs of a
                 query batch invert into per-list chunks (probe_invert),
                 each chunk's list is scored once for all its queries and
                 trimmed, and the per-(query, probe) candidates regroup
                 to query-major order and merge exactly;
  "auto"         `_resolve_score_mode`: "recon8_list" when an int8 or a
                 pallas, exact or fused trim is asked for; else the tuned
                 `pq_auto_engine` (CUDA only, core/tuned.py); else
                 "recon8_list" when the batch re-reads each list at least
                 4 times (nq * n_probes / n_lists >= 4), and "lut" below
                 that, the JAX package's choice off a TPU.

The trims of "recon8_list", `trim_engine`:

  "approx", "exact"  the scores of a superblock of chunks materialized (f32,
                 or bf16 with `internal_distance_dtype` "bfloat16" or
                 "float16"), each chunk row trimmed to its best k with an
                 exact select, ties to the smaller slot
                 (`probe_invert.score_and_select`). The JAX package's
                 "approx" is `lax.approx_min_k`, exact on its CPU backend;
                 the port runs the exact select for both;
  "fused"        an exact top-k per chunk row inside one kernel launch,
                 the scores never in device memory: `fused_list_topk`
                 (bf16 rows) or, with score_dtype="int8",
                 `fused_list_topk_int8` (ops/fused_scan.py);
  "pallas"       the bin fold, best and second best in each of 256 bins
                 per row (`ops/pq_list_scan.py`), then an exact
                 top-min(k, 256) of the 512 candidates; k <= 256;
  "auto"         "approx", unless a tuned `select_k_strategy_int8`
                 (CUDA only) promotes the fused int8 trim for int8 rows
                 whose geometry fits the kernel. A bf16 trim's "auto"
                 stays "approx", as in the JAX package; on the card its
                 per-row selects may go to the counting kernel
                 (matrix/select_k `_counting_promoted`).

`internal_distance_dtype="auto"` is the tuned hint
`hints()["internal_distance_dtype"]` on CUDA, else "float32"; the
"approx" and "exact" trims take their chunk width from the tuned
`listmajor_chunk` (32, 64 or 128) where a batch re-reads each list at
most 48 times (`resolve_listmajor_chunk`), else 128.

score_dtype="int8" quantizes each scale-folded residual row to symmetric
int8 (`_quantize_query_rows`) and scores int8 x int8 -> int32 with the
per-row scale; every list-major trim scores the same f32 values from
them. CUDA kernels on the card, their plain versions on the CPU; the lut,
recon8, approx and exact engines are tensor code on either.

A `prefilter` (a `core.bitset.Bitset` or boolean mask over the index's
ids) is one view of the slot table: filtered slots read -1, which every
engine scores as the worst value, so no filtered row is ever a candidate.
The `tombstones` of live mutation (neighbors/mutation) are applied the
same way, before the prefilter.

Adaptive probing (`adaptive`, `recall_target`, `budget_tau`;
neighbors/probe_budget): one (nq, n_probes) keep mask from the rotated
coarse geometry, with radius bounds for L2 metrics without a prefilter or tombstones.
`list_radii` are zero at build and raised by every `extend` to the
largest rotated-space residual norm of each list's members.

`save` / `load` write and read the JAX package's container (kind
"ivf_pq", writer version 3; core/serialize). The integrity sidecar
(`list_digests`, `table_digests`; raft_tpu_torch/integrity) is attached
at build, refreshed by `extend` and every mutation, and saved and loaded
with the index. With obs enabled, build, extend and search each land a
span, the search charging its analytic cost (`obs.perf.ivf_pq_scan`)
and an adaptive batch its scanned lists (`probe_budget.account`). Not
ported: the JAX package's fence against the lut engine on a TPU
(`_check_lut_allowed`, a guard for a TPU device fault).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

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
from raft_tpu_torch.neighbors.quantizer import (
    PER_CLUSTER,
    PER_SUBSPACE,
    PqQuantizer,
    ordered_row_sum,
    sqrt_f32,
)
from raft_tpu_torch.random.rng import make_generator, sample_without_replacement

#: gathered LUT entries a block of the "lut" engine holds
LUT_BLOCK_ELEMS = 1 << 25
#: reconstruction-store values a block of the "recon8" engine holds
RECON8_BLOCK_ELEMS = 1 << 25
#: duplication (nq * n_probes / n_lists) up to which the tuned
#: `listmajor_chunk` applies (the JAX package's bound)
_LOW_DUP_CHUNK_BOUND = 48
#: the chunk widths `listmajor_chunk` may name (the JAX package's set)
_LISTMAJOR_CHUNKS = (32, 64, 128)


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
    """Mirrors ivf_pq::search_params (ivf_pq_types.hpp:112-150), with the
    JAX package's fields and defaults.

    `score_mode` "lut" | "recon8" | "recon8_list" | "auto" and
    `trim_engine` "auto" | "approx" | "exact" | "pallas" | "fused" (module
    docstring); `score_dtype` "bf16" | "int8" (the list-major rows);
    `lut_dtype` "float32" | "bfloat16" (the lut engine's table);
    `internal_distance_dtype` "float32" | "float16" | "bfloat16" | "auto"
    (= "float32"): the dtype of the approx and exact trims' scores (the
    two half types both mean bf16 scores, as in the JAX package).
    `adaptive`, `recall_target` and `budget_tau` ask for adaptive probing
    (neighbors/probe_budget; `recall_target` >= 1.0 is the fixed search
    bit for bit); `min_probes` floors each query's budget and
    `early_term` allows the radius bounds."""

    n_probes: int = 20
    lut_dtype: str = "float32"
    internal_distance_dtype: str = "auto"
    score_mode: str = "auto"
    score_dtype: str = "bf16"
    trim_engine: str = "auto"
    adaptive: bool = False
    recall_target: Optional[float] = None
    budget_tau: Optional[float] = None
    min_probes: int = 1
    early_term: bool = True


class Index:
    """IVF-PQ index (tensors on one device).

    rotation   (rot_dim, dim) f32 orthogonal input transform
    centers    (n_lists, rot_dim) f32 coarse centroids (rotated space)
    pq_centers (pq_dim, 2^bits, pq_len) f32 per-subspace codebooks, or
               (n_lists, 2^bits, pq_len) per-cluster ones
    codes      (n_lists, max_list, pq_dim) uint8 slot table
    slot_rows  (n_lists, max_list) int32 -> row position, -1 empty
    list_sizes (n_lists,) int32; source_ids (n_rows,) int32
    list_radii (n_lists,) f32 largest rotated-space residual norm of each
               list's members (adaptive probing's bounds), or None
    tombstones (n_lists, max_list) bool dead-slot mask, or None (all
               live); mut_cursor and append_slack as in ivf_flat.Index
    list_digests, table_digests  the integrity sidecar, as in
               ivf_flat.Index

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
    (`INDEX_FIELDS`, raft_tpu/neighbors/ivf_pq.py:185-207, and its
    `list_radii` where given), so both packages can search one identical
    index."""
    dev = resolve_device(device)
    missing = [f for f in INDEX_FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"index_from_arrays: missing fields {missing}")
    dtypes = {"codes": torch.uint8, "slot_rows": torch.int32,
              "list_sizes": torch.int32, "source_ids": torch.int32}
    t = {f: torch.as_tensor(np.array(arrays[f]))
         .to(device=dev, dtype=dtypes.get(f, torch.float32)) for f in INDEX_FIELDS}
    index = Index(params, t["rotation"], t["centers"], t["pq_centers"], t["codes"],
                  t["slot_rows"], t["list_sizes"], t["source_ids"])
    if arrays.get("list_radii") is not None:
        index.list_radii = torch.as_tensor(np.array(arrays["list_radii"]),
                                           dtype=torch.float32, device=dev)
    return index


_SERIAL_VERSION = 3  # v2: mutation fields; v3: digest sidecar


def save(filename: str, index: Index) -> None:
    """Write the index as the JAX package's v3 container, with its digest
    sidecar where it has one. The reconstruction store is not saved: a
    loaded index derives it at its first search."""
    from raft_tpu_torch.core.serialize import serialize_arrays
    from raft_tpu_torch.integrity.digest import pack_lists

    arrays = {
        "rotation": index.rotation,
        "centers": index.centers,
        "pq_centers": index.pq_centers,
        "codes": index.codes,
        "slot_rows": index.slot_rows,
        "list_sizes": index.list_sizes,
        "source_ids": index.source_ids,
    }
    if index.list_radii is not None:
        arrays["list_radii"] = index.list_radii
    if index.tombstones is not None:
        arrays["tombstones"] = torch.as_tensor(index.tombstones).to(torch.uint8)
    meta = {
        "kind": "ivf_pq",
        "version": _SERIAL_VERSION,
        "metric": int(index.metric),
        "n_lists": index.n_lists,
        "pq_bits": index.pq_bits,
        "codebook_kind": index.params.codebook_kind,
        "mut_cursor": int(index.mut_cursor),
        "append_slack": int(index.append_slack),
    }
    packed = pack_lists(index, "ivf_pq")
    if packed is not None:
        arrays["list_digests"] = packed
        meta["table_digests"] = {k: int(v) for k, v in (index.table_digests or {}).items()}
    serialize_arrays(filename, arrays, meta)


def load(filename: str, device=None) -> Index:
    """Read an "ivf_pq" container (either package's) onto
    `resolve_device(device)`; absent fields load as the schema declares
    (no radii -> None, no tombstones -> all live, cursor and slack 0, no
    sidecar -> `list_digests` None)."""
    from raft_tpu_torch.core.serialize import as_device_tensor, read_ckpt
    from raft_tpu_torch.integrity.digest import unpack_lists

    dev = resolve_device(device)
    arrays, meta = read_ckpt(filename, "ivf_pq", to_device=False)
    params = IndexParams(n_lists=meta["n_lists"], metric=DistanceType(meta["metric"]),
                         pq_bits=meta["pq_bits"], codebook_kind=meta["codebook_kind"])
    f32, i32 = torch.float32, torch.int32
    index = Index(params, as_device_tensor(arrays["rotation"], dev, f32),
                  as_device_tensor(arrays["centers"], dev, f32),
                  as_device_tensor(arrays["pq_centers"], dev, f32),
                  as_device_tensor(arrays["codes"], dev, torch.uint8),
                  as_device_tensor(arrays["slot_rows"], dev, i32),
                  as_device_tensor(arrays["list_sizes"], dev, i32),
                  as_device_tensor(arrays["source_ids"], dev, i32))
    if arrays.get("list_radii") is not None:
        index.list_radii = as_device_tensor(arrays["list_radii"], dev, f32)
    if arrays.get("tombstones") is not None:
        index.tombstones = as_device_tensor(arrays["tombstones"], dev, torch.bool)
    index.mut_cursor = int(meta.get("mut_cursor", 0))
    index.append_slack = int(meta.get("append_slack", 0))
    unpack_lists(index, "ivf_pq", arrays.get("list_digests"), meta.get("table_digests"))
    return index


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
    """Trainset-fraction subsample, rotate, balanced k-means (hierarchical
    past 1024 lists); shared by the PQ and RaBitQ builds. Returns
    (centers, rotated trainset)."""
    n = x.shape[0]
    frac = min(max(params.kmeans_trainset_fraction, 0.0), 1.0)
    n_train = min(n, max(params.n_lists * 4, int(n * frac)))
    strict_f32_matmul()
    if n_train < n:
        x_train_rot = x[sample_without_replacement(gen, n, n_train)] @ rotation.T
    else:
        x_train_rot = x @ rotation.T
    fit = kmeans_balanced.fit_hierarchical if params.n_lists > 1024 else kmeans_balanced.fit
    centers = fit(x_train_rot, params.n_lists, n_iters=params.kmeans_n_iters,
                  metric=_metric_name(params.metric), seed=seed, device=x.device)
    return centers, x_train_rot


@obs.spanned("neighbors.ivf_pq.build")
@accepts_resources
def build(params: IndexParams, dataset, resources=None, seed: int = 0, device=None) -> Index:
    """Train rotation, coarse centers and codebooks; encode and pack the
    dataset (detail/ivf_pq_build.cuh:1074)."""
    x = check_matrix(dataset, device=device, name="dataset").float()
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

    # codebooks from (a capped sample of) the trainset residuals; per
    # cluster the cap grows with n_lists, so that every list keeps samples
    nb = 1 << params.pq_bits
    max_cb_rows = max(65536, 64 * nb)
    if params.codebook_kind == PER_CLUSTER:
        max_cb_rows = max(max_cb_rows, 256 * params.n_lists)
    n_train = x_train_rot.shape[0]
    if n_train > max_cb_rows:
        x_cb = x_train_rot[sample_without_replacement(gen, n_train, max_cb_rows)]
    else:
        x_cb = x_train_rot
    train_labels = kmeans_balanced._predict_long(x_cb, centers, metric=_metric_name(params.metric),
                                           device=dev)
    residuals = x_cb - centers[train_labels]
    quant = PqQuantizer(params.codebook_kind, pq_bits=params.pq_bits, pq_dim=pq_dim,
                        pq_len=pq_len, n_lists=params.n_lists)
    pq_centers = quant.train(gen, residuals, train_labels).pq_centers

    index = Index(
        params, rotation, centers, pq_centers,
        torch.zeros((params.n_lists, 1, pq_dim), dtype=torch.uint8, device=dev),
        torch.full((params.n_lists, 1), -1, dtype=torch.int32, device=dev),
        torch.zeros((params.n_lists,), dtype=torch.int32, device=dev),
        torch.zeros((0,), dtype=torch.int32, device=dev),
    )
    # zero radii on the empty index: every extend raises them
    index.list_radii = torch.zeros((params.n_lists,), dtype=torch.float32, device=dev)
    if params.add_data_on_build:
        index = extend(index, x, torch.arange(n, dtype=torch.int32, device=dev))
    from raft_tpu_torch.integrity.digest import attach

    attach(index, "ivf_pq")  # the integrity sidecar, kept fresh from here on
    return index


def label_and_encode(vectors: torch.Tensor, rotation: torch.Tensor, centers: torch.Tensor,
                     pq_centers: torch.Tensor, metric: DistanceType,
                     per_cluster: bool = False, with_dists: bool = False):
    """Rotate, assign to coarse lists, and PQ-encode the residuals (each
    against its list's codebook when `per_cluster`). Returns (labels (n,)
    int64, codes (n, pq_dim) uint8), and with `with_dists` the exact
    rotated-space residual norms (n,) f32 that the list radii take."""
    strict_f32_matmul()
    v_rot = vectors.float() @ rotation.T
    labels = kmeans_balanced._predict_long(v_rot, centers, metric=_metric_name(metric),
                                           device=v_rot.device)
    residuals = v_rot - centers[labels]
    codes = PqQuantizer.from_centers(pq_centers, per_cluster).encode(residuals, labels)["codes"]
    if with_dists:
        return labels, codes, sqrt_f32(torch.clamp(ordered_row_sum(residuals, residuals),
                                                   min=0.0))
    return labels, codes


@obs.spanned("neighbors.ivf_pq.extend")
def extend(index: Index, new_vectors, new_indices=None) -> Index:
    """Label, encode and append new vectors (ivf_pq_build.cuh:1061):
    only the new batch is encoded and placed into grown code tables. The
    mutation state carries over (new tail slots are live); the digest
    sidecar hashes again only the lists the batch touched."""
    from raft_tpu_torch.core.bitset import carry_tombstones
    from raft_tpu_torch.integrity.digest import refresh
    from raft_tpu_torch.neighbors.ivf_flat import _append_slots, _grow_and_scatter

    dev = index.device
    nv = check_matrix(new_vectors, device=dev, name="new_vectors").float()
    old_n = index.size
    if new_indices is None:
        new_indices = torch.arange(old_n, old_n + nv.shape[0], dtype=torch.int32, device=dev)
    else:
        new_indices = torch.as_tensor(new_indices, device=dev).to(torch.int32)
    labels, new_codes, dists = label_and_encode(nv, index.rotation, index.centers,
                                                index.pq_centers, index.metric,
                                                index.params.codebook_kind == PER_CLUSTER,
                                                with_dists=True)
    labels_np = labels.cpu().numpy()
    old_sizes = index.list_sizes.cpu().numpy().astype(np.int64)
    slot_abs, new_sizes, new_max = _append_slots(labels_np, old_sizes, index.n_lists)
    new_max = max(new_max, int(index.codes.shape[1]))  # a padded store never shrinks
    positions = torch.arange(old_n, old_n + nv.shape[0], dtype=torch.int32, device=dev)
    codes_tbl, slot_rows = _grow_and_scatter(
        index.codes, index.slot_rows, new_codes, labels,
        torch.as_tensor(slot_abs, device=dev), positions, new_max)
    all_ids = torch.cat([index.source_ids, new_indices]) if old_n else new_indices
    out = Index(index.params, index.rotation, index.centers, index.pq_centers,
                codes_tbl, slot_rows, torch.as_tensor(new_sizes, device=dev), all_ids)
    out.list_radii = probe_budget.updated_radii(index.list_radii, labels, dists,
                                                index.n_lists)
    out.tombstones = carry_tombstones(index.tombstones, int(codes_tbl.shape[1]))
    out.mut_cursor = index.mut_cursor
    out.append_slack = index.append_slack
    refresh(out, index, "ivf_pq")
    return out


# ---------------------------------------------------------------------------
# int8 reconstruction store
# ---------------------------------------------------------------------------


def _decode_quantize(codes: torch.Tensor, pq_centers: torch.Tensor,
                     per_cluster: bool = False, list_block: int = 64):
    """Decode PQ codes to per-dimension symmetric int8 and the decoded
    norms: (recon8 (L, S, rot) int8, scale (rot,) f32, rnorm (L, S) f32).
    The scale is a per-dimension max-abs over the codebooks, so it bounds
    every reconstruction without a pass over the decoded data; per-cluster
    codebooks share their entries across subspaces, so their scale is one
    per position in a subvector, repeated pq_dim times. The norms sum in
    the reference's CPU order (`ordered_row_sum`)."""
    n_lists, max_list, pq_dim = codes.shape
    pq_len = pq_centers.shape[-1]
    rot_dim = pq_dim * pq_len
    if per_cluster:
        amax = torch.amax(torch.abs(pq_centers), dim=(0, 1)).repeat(pq_dim)  # (rot,)
    else:
        amax = torch.amax(torch.abs(pq_centers), dim=1).reshape(rot_dim)
    # times the reciprocal, not a division: the JAX reference compiles
    # its division by the constant 127 to this multiply, and the scale
    # must agree with it bit for bit
    scale = torch.clamp(amax * (1.0 / 127.0), min=1e-12)
    inv = (1.0 / scale).reshape(pq_dim, pq_len)
    scale_pl = scale.reshape(pq_dim, pq_len)
    dev = codes.device
    recon8 = torch.empty((n_lists, max_list, rot_dim), dtype=torch.int8, device=dev)
    rnorm = torch.empty((n_lists, max_list), dtype=torch.float32, device=dev)
    sub = torch.arange(pq_dim, device=dev)[None, None, :]
    for s in range(0, n_lists, list_block):
        idx = codes[s:s + list_block].long()
        if per_cluster:
            lid = torch.arange(s, s + idx.shape[0], device=dev)[:, None, None]
            rec = pq_centers[lid, idx]  # (lb, S, P, pl)
        else:
            rec = pq_centers[sub, idx]
        q = torch.clamp(torch.round(rec * inv), -127, 127)
        deq = (q * scale_pl).reshape(*q.shape[:2], rot_dim)
        rnorm[s:s + list_block] = ordered_row_sum(deq, deq)
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

        r8, scale, rnorm = _decode_quantize(index.codes, index.pq_centers,
                                            index.params.codebook_kind == PER_CLUSTER)
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
                   n_probes: int, metric: DistanceType, plan=None):
    """Rotate queries and pick the n_probes closest coarse centers
    (select_clusters, ivf_pq_search.cuh:133). Returns (q_rot, probes,
    keep mask or None). L2 ranks by |c|^2 - 2 <q, c> (the query norm is
    constant per row), through adaptive probing's
    `probe_budget.coarse_select`; an adaptive `plan` ((keep mask, probes),
    `probe_budget.search_plan`) made that select already and brings its
    probes with its mask."""
    strict_f32_matmul()
    q_rot = queries.float() @ rotation.T
    if plan is not None:
        return q_rot, plan[1], plan[0]
    probes = probe_budget.coarse_select(q_rot, centers, metric, n_probes, pq_style=True)[1]
    return q_rot, probes, None


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
                     n_probes: int, metric: DistanceType, chunk: int,
                     plan=None, setup_impls=("sort", "gather")) -> _ListMajorBatch:
    """Coarse select, probe inversion (pairs outside an adaptive `plan`'s
    mask dropped), query rows, residuals and the additive per-slot base
    (L2: recon norm; IP: 0; +inf invalid). `setup_impls`: the
    (invert_impl, qs_impl) of `probe_invert.resolve_setup_impls`."""
    from raft_tpu_torch.neighbors.probe_invert import (
        chunk_live_rows,
        gather_query_rows,
        invert_probes_with,
    )

    nq = queries.shape[0]
    n_lists, rot_dim = centers.shape
    ip = metric == DistanceType.InnerProduct
    q_rot, probes, pvalid = _coarse_select(queries, rotation, centers, n_probes, metric, plan)
    invert_impl, qs_impl = setup_impls
    tables = invert_probes_with(invert_impl, probes, n_lists, chunk, pvalid)
    live = chunk_live_rows(tables.qid_tbl, nq)  # pad rows and empty chunks skip in-kernel
    q_pad = torch.cat([q_rot, q_rot.new_zeros((1, rot_dim))])
    qs = gather_query_rows(q_pad, tables.qid_tbl, qs_impl)  # (ncb, chunk, rot)
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
                                        kb: Optional[int] = None, int8_queries: bool = False,
                                        plan=None, setup_impls=("sort", "gather")):
    """List-major search with the fused distance + exact select-k trim:
    one kernel launch scores every chunk's list straight out of the int8
    store and keeps each row's exact top-k (ties to the smaller slot);
    the (chunk, L) scores never reach device memory. With `int8_queries`
    the rows quantize through `_quantize_query_rows`, as the pallas
    trim's do, and score int8 x int8 -> int32 ("fused_int8"). `plan`: an
    adaptive plan (keep mask, probes), or None; `setup_impls`: the
    (invert_impl, qs_impl) pair. Returns (values, slot-row positions)
    (nq, k)."""
    from raft_tpu_torch.matrix.select_k import list_scan_select_k

    ip = metric == DistanceType.InnerProduct
    b = _listmajor_batch(queries, rotation, centers, recon_scale, recon_norm, slot_rows_pad,
                         n_probes, metric, chunk, plan, setup_impls)
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
                                         int8_queries: bool = False, fold: str = "exact",
                                         plan=None, setup_impls=("sort", "gather")):
    """List-major search with the bin-fold trim (ops/pq_list_scan.py):
    per chunk, one kernel launch scores the list and folds each row's
    scores into 256 bins, best and second best each, so only (chunk, 512)
    candidates reach device memory; an exact top-min(k, 256) of them per
    row and the shared exact merge finish. With `int8_queries` the rows
    quantize through `_quantize_query_rows` and score int8 x int8 ->
    int32, the same f32 values as the fused int8 trim's. `plan`: an
    adaptive plan (keep mask, probes), or None; `setup_impls`: the
    (invert_impl, qs_impl) pair. Returns (values, slot-row positions)
    (nq, k)."""
    from raft_tpu_torch.ops.pq_list_scan import _BINS, pq_list_scan

    ip = metric == DistanceType.InnerProduct
    b = _listmajor_batch(queries, rotation, centers, recon_scale, recon_norm, slot_rows_pad,
                         n_probes, metric, chunk, plan, setup_impls)
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


def _query_blocks(nq: int, per_query: int, budget: int, query_block: Optional[int] = None):
    """Row slices of `query_block` queries, or of as many as `budget`
    holds at `per_query` values a query (one at least)."""
    qb = query_block or max(1, budget // max(1, per_query))
    return [slice(s, s + qb) for s in range(0, nq, qb)]


def _probe_residuals(qs: torch.Tensor, pc: torch.Tensor, ip: bool) -> torch.Tensor:
    """(b, n_probes, rot) residuals of each query against its probed
    centers (IP: the query itself)."""
    return qs[:, None, :].expand_as(pc) if ip else qs[:, None, :] - pc


def _score_constant(qs: torch.Tensor, pc: torch.Tensor, qres: torch.Tensor,
                    ip: bool) -> torch.Tensor:
    """The per-(query, probe) term the code scores leave out: <q, center>
    (IP) or |q - center|^2 (L2), summed in the reference's CPU order."""
    return ordered_row_sum(qs[:, None, :].expand_as(pc), pc) if ip else ordered_row_sum(qres,
                                                                                         qres)


def _probed_rows(slot_rows, pr, pvalid, sl):
    """The probed lists' slot rows (b, n_probes, L) of a query block, -1
    on the probes the keep mask `pvalid` dropped."""
    rows = slot_rows[pr]
    if pvalid is None:
        return rows
    return torch.where(pvalid[sl][:, :, None], rows, -1)


def _select_query_major(scores, rows, k: int, ip: bool):
    """Exact top-k over each query's (b, n_probes, L) candidate scores,
    -1 slots at the worst value. Returns (values, slot rows) (b, k)."""
    b = scores.shape[0]
    rows = rows.reshape(b, -1)
    scores = torch.where(rows >= 0, scores.reshape(b, -1), float("-inf") if ip else float("inf"))
    v, pos = _select_k_impl(scores, k, not ip)
    return v, torch.gather(rows, 1, pos)


def _finish(vals, rows, metric: DistanceType):
    """f32 values (from bf16 trims too), square-rooted for L2SqrtExpanded."""
    vals = vals.float()
    if metric == DistanceType.L2SqrtExpanded:
        vals = torch.sqrt(torch.clamp(vals, min=0.0))
    return vals, rows


def _search_impl(queries, rotation, centers, pq_centers, codes, slot_rows, k: int,
                 n_probes: int, metric: DistanceType, per_cluster: bool, lut_bf16: bool = False,
                 query_block: Optional[int] = None, plan=None):
    """The "lut" engine (compute_similarity, ivf_pq_search.cuh:611): per
    block of queries, each (query, probe) pair's (pq_dim, nb) table of
    sub-scores from one batched product (L2: |c_b|^2 - 2 <q_sub, c_b>;
    IP: <q_sub, c_b>), rounded to bf16 with `lut_bf16`; each slot's score
    is the sum of its codes' entries (in the reference's CPU order) plus
    the pair's constant; an exact top-k a query. Blocks hold at most
    LUT_BLOCK_ELEMS gathered entries (`query_block` queries when given);
    the select is exact, so the block does not change the answer.
    `plan`: an adaptive plan (keep mask, probes), or None; a masked
    probe's slots read -1. Returns (values, slot-table values) (nq, k)."""
    strict_f32_matmul()
    nq = queries.shape[0]
    n_lists, max_list, pq_dim = codes.shape
    nb, pq_len = pq_centers.shape[-2:]
    ip = metric == DistanceType.InnerProduct
    q_rot, probes, pvalid = _coarse_select(queries, rotation, centers, n_probes, metric, plan)
    offs = torch.arange(pq_dim, device=codes.device) * nb
    if not per_cluster:
        bn_sub = torch.sum(pq_centers * pq_centers, dim=2)  # (pq_dim, nb)
    blocks = _query_blocks(nq, n_probes * max_list * pq_dim, LUT_BLOCK_ELEMS, query_block)
    vals, rows = [], []
    for sl in blocks:
        qs, pr = q_rot[sl], probes[sl].long()
        b = qs.shape[0]
        pc = centers[pr]
        qres = _probe_residuals(qs, pc, ip)
        qsub = qres.reshape(b, n_probes, pq_dim, pq_len)
        if per_cluster:
            books = pq_centers[pr]  # (b, n_probes, nb, pq_len)
            dots = torch.matmul(qsub, books.transpose(-1, -2))
            bn = torch.sum(books * books, dim=3)[:, :, None, :]
        else:
            dots = torch.einsum("qnpl,pbl->qnpb", qsub, pq_centers)
            bn = bn_sub[None, None]
        lut = dots if ip else bn - 2.0 * dots
        if lut_bf16:
            lut = lut.to(torch.bfloat16)
        idx = (codes[pr].long() + offs).reshape(b * n_probes, max_list * pq_dim)
        gathered = torch.gather(lut.reshape(b * n_probes, pq_dim * nb), 1, idx)
        scores = ordered_row_sum(gathered.float().reshape(b, n_probes, max_list, pq_dim))
        scores = scores + _score_constant(qs, pc, qres, ip)[:, :, None]
        v, r = _select_query_major(scores, _probed_rows(slot_rows, pr, pvalid, sl), k, ip)
        vals.append(v)
        rows.append(r)
    return _finish(torch.cat(vals), torch.cat(rows), metric)


def _dequantize_bf16(r8: torch.Tensor, recon_scale: torch.Tensor) -> torch.Tensor:
    """int8 store values times the bf16-rounded scale, each product
    rounded to bf16 (the list-major engine's `r8.astype(bf16) *
    scale_bf`), as f32 for the product that follows: a product of two
    bf16 values is exact in f32, so an f32 matmul with TF32 off computes
    the reference's bf16 dot with f32 accumulation, up to its summation
    order."""
    return (r8.float() * recon_scale.to(torch.bfloat16).float()).to(torch.bfloat16).float()


def _search_impl_recon8(queries, rotation, centers, recon8, recon_scale, recon_norm,
                        slot_rows, k: int, n_probes: int, metric: DistanceType,
                        query_block: Optional[int] = None, plan=None):
    """The "recon8" engine, query-major: per block of queries, the probed
    lists of the int8 store dequantized (int8 times the bf16 scale, kept
    in f32: the reference writes a bf16 product, which XLA on the CPU
    keeps in f32 into its f32 dot) and scored against the bf16-rounded
    residuals (f32 accumulation); L2: |q - c|^2 - 2 dots +
    |recon|^2, IP: dots + <q, c>; an exact top-k a query. Blocks hold at
    most RECON8_BLOCK_ELEMS store values (`query_block` queries when
    given). `plan`: an adaptive plan (keep mask, probes), or None.
    Returns (values, slot-table values) (nq, k)."""
    strict_f32_matmul()
    nq = queries.shape[0]
    n_lists, max_list, rot_dim = recon8.shape
    ip = metric == DistanceType.InnerProduct
    q_rot, probes, pvalid = _coarse_select(queries, rotation, centers, n_probes, metric, plan)
    blocks = _query_blocks(nq, n_probes * max_list * rot_dim, RECON8_BLOCK_ELEMS, query_block)
    vals, rows = [], []
    for sl in blocks:
        qs, pr = q_rot[sl], probes[sl].long()
        pc = centers[pr]
        qres = _probe_residuals(qs, pc, ip)
        # sum_d bf16(qres_d) * (r8_d * bf16(scale_d)): every product is
        # exact in f32 however it is grouped (8 + 8 + 7 significant bits),
        # so the scale folds into the query side
        qs_scaled = qres.to(torch.bfloat16).float() * recon_scale.to(torch.bfloat16).float()
        dots = torch.matmul(recon8[pr].float(), qs_scaled[..., None])[..., 0]
        const = _score_constant(qs, pc, qres, ip)[:, :, None]
        scores = dots + const if ip else const - 2.0 * dots + recon_norm[pr]
        v, r = _select_query_major(scores, _probed_rows(slot_rows, pr, pvalid, sl), k, ip)
        vals.append(v)
        rows.append(r)
    return _finish(torch.cat(vals), torch.cat(rows), metric)


def _search_impl_recon8_listmajor(queries, rotation, centers, recon8, recon_scale, recon_norm,
                                  slot_rows_pad, k: int, n_probes: int, metric: DistanceType,
                                  chunk: int = 128, int8_queries: bool = False,
                                  trim_bf16: bool = False, plan=None,
                                  setup_impls=("sort", "gather")):
    """List-major search with the "approx" and "exact" trims: each chunk
    scores its list once for all its query rows (bf16 rows: the residuals
    and the dequantized store rounded to bf16, f32 accumulation; int8
    rows: `_quantize_query_rows` of the scale-folded residuals, int8 dots
    times the row scale), the scores of a superblock of chunks are
    materialized (bf16 with `trim_bf16`), each chunk row is trimmed to its
    exact best k and the candidates merge
    (`probe_invert.score_and_select`); pairs outside an adaptive `plan`'s
    mask are dropped before the inversion; `setup_impls` is the
    (invert_impl, qs_impl) pair. Returns (values, slot-row positions)
    (nq, k)."""
    from raft_tpu_torch.neighbors.probe_invert import (
        gather_query_rows,
        invert_probes_with,
        score_and_select,
    )

    strict_f32_matmul()
    nq = queries.shape[0]
    n_lists, max_list, rot_dim = recon8.shape
    ip = metric == DistanceType.InnerProduct
    worst = float("-inf") if ip else float("inf")
    q_rot, probes, pvalid = _coarse_select(queries, rotation, centers, n_probes, metric, plan)
    invert_impl, qs_impl = setup_impls
    tables = invert_probes_with(invert_impl, probes, n_lists, chunk, pvalid)
    q_pad = torch.cat([q_rot, q_rot.new_zeros((1, rot_dim))])

    def block(lofb, qids):
        lb = lofb.long()
        cent = centers[lb]
        qs = gather_query_rows(q_pad, qids, qs_impl)  # (b, chunk, rot)
        qres = qs if ip else qs - cent[:, None, :]
        if int8_queries:
            # int8 x int8 dots are exact in f32: |sum| < 2^24 to rot_dim 1040
            u8, row_scale = _quantize_query_rows(qres * recon_scale)
            dots = torch.bmm(u8.float(), recon8[lb].float().transpose(1, 2)) * row_scale
        else:
            dots = torch.bmm(qres.to(torch.bfloat16).float(),
                             _dequantize_bf16(recon8[lb], recon_scale).transpose(1, 2))
        if ip:
            scores = dots + ordered_row_sum(qs, cent[:, None, :])[:, :, None]
        else:
            scores = ordered_row_sum(qres, qres)[:, :, None] - 2.0 * dots + recon_norm[lb][:, None]
        scores = torch.where(slot_rows_pad[lb][:, None, :] >= 0, scores, worst)
        return scores.to(torch.bfloat16) if trim_bf16 else scores

    v, rows = score_and_select(tables, block, slot_rows_pad, _select_k_impl, nq, n_probes, int(k),
                               not ip, chunk, max_list)
    return _finish(v, rows, metric)


def _resolve_score_mode(params: SearchParams, nq: int, n_probes: int, n_lists: int,
                        device=None) -> str:
    """score_mode="auto": an int8 or a pallas, exact or fused trim pins
    "recon8_list" (the only engine that honors them); else the tuned
    `pq_auto_engine` where the table governs `device` (CUDA; "lut" is
    allowed: the JAX package's fence against it guards a TPU fault); else
    "recon8_list" when the batch re-reads each list at least 4 times
    (nq * n_probes / n_lists >= 4), and "lut" below that."""
    mode = params.score_mode
    if mode != "auto":
        return mode
    if params.score_dtype == "int8" or params.trim_engine in ("pallas", "exact", "fused"):
        return "recon8_list"
    if tuned.applies(device):
        t = tuned.get("pq_auto_engine")
        if t in ("lut", "recon8", "recon8_list"):
            return t
    return "recon8_list" if nq * n_probes / max(1, n_lists) >= 4.0 else "lut"


def _resolve_distance_dtype(params: SearchParams, device=None) -> str:
    """internal_distance_dtype="auto": the tuned hint
    `hints()["internal_distance_dtype"]` where the table governs `device`
    (CUDA) and names a known dtype, else "float32"."""
    idd = params.internal_distance_dtype
    if idd != "auto":
        return idd
    if tuned.applies(device):
        hinted = tuned.hints().get("internal_distance_dtype")
        if hinted in ("float32", "float16", "bfloat16"):
            return hinted
    return "float32"


def resolve_listmajor_chunk(nq: int, n_probes: int, n_lists: int, device=None) -> int:
    """Chunk rows of the "approx" and "exact" trims: the tuned
    `listmajor_chunk` where the table governs `device` (CUDA), names one
    of `_LISTMAJOR_CHUNKS` and the batch re-reads each list at most
    `_LOW_DUP_CHUNK_BOUND` times (the shapes it was measured at); else
    128."""
    if tuned.applies(device) and nq * n_probes / max(1, n_lists) <= _LOW_DUP_CHUNK_BOUND:
        t = tuned.get("listmajor_chunk", 128)
        if t in _LISTMAJOR_CHUNKS:
            return int(t)
    return 128


def resolve_search(params: SearchParams, nq: int, n_probes: int, n_lists: int, device=None,
                   k: Optional[int] = None, L: Optional[int] = None, rot: Optional[int] = None,
                   kbuf: Optional[int] = None):
    """(score_mode, trim_engine, internal_distance_dtype) that a search
    with `params` runs on `device`; raises ValueError on an unknown or
    contradictory request. Each "auto" resolves through the tuned table
    for a CUDA device (module docstring), and as the JAX package resolves
    it without a tuned value otherwise. The int8 trim's promotion needs
    the search's `k`, the store's lane-padded slot width `L`, `rot` and
    the index's recorded buffer width `kbuf`."""
    if params.score_dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown score_dtype {params.score_dtype!r}")
    idd = _resolve_distance_dtype(params, device)
    if idd not in ("float32", "float16", "bfloat16"):
        raise ValueError(f"unknown internal_distance_dtype {params.internal_distance_dtype!r}")
    if params.lut_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown lut_dtype {params.lut_dtype!r}")
    mode = params.score_mode
    if mode == "auto":
        mode = _resolve_score_mode(params, nq, n_probes, n_lists, device)
    elif params.score_dtype == "int8" and mode != "recon8_list":
        raise ValueError(
            f"score_dtype='int8' requires score_mode 'recon8_list' or 'auto', got {mode!r}")
    if mode not in ("lut", "recon8", "recon8_list"):
        raise ValueError(f"unknown score_mode {mode!r}")
    trim = params.trim_engine
    if trim not in ("auto", "approx", "exact", "pallas", "fused"):
        raise ValueError(f"unknown trim_engine {trim!r}")
    if trim == "auto":
        trim = "approx"
        if (mode == "recon8_list" and params.score_dtype == "int8" and k is not None
                and L is not None and rot is not None):
            from raft_tpu_torch.matrix.select_k import resolve_int8_trim_strategy
            from raft_tpu_torch.ops.fused_scan import FUSED_MAX_K, fused_kbuf

            if 0 < int(k) <= FUSED_MAX_K:
                kb_probe = max(fused_kbuf(int(k)), kbuf or 0)
                if resolve_int8_trim_strategy(L, rot, int(k), kbuf=kb_probe,
                                              device=device) == "fused_int8":
                    trim = "fused"
    if trim in ("pallas", "exact", "fused") and mode != "recon8_list":
        raise ValueError(f"trim_engine='{trim}' requires score_mode 'recon8_list'")
    return mode, trim, idd


@obs.spanned("neighbors.ivf_pq.search")
@auto_convert_output
@accepts_resources
def search(params: SearchParams, index: Index, queries, k: int, resources=None, prefilter=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN search; returns (distances (nq, k) f32, neighbor source ids
    (nq, k) int32, -1 where fewer than k candidates exist), on the
    index's device. The engine is `resolve_search`'s (module docstring).
    Caps and shared-memory budgets of the fused and pallas trims are
    checked before the first search builds the index's reconstruction
    store, so a rejected request leaves the index as it was. `prefilter`:
    a `core.bitset.Bitset` or 1-d boolean mask over the index's id space
    (`index.id_bound` ids); samples whose bit is clear are excluded
    before any selection. Adaptive probing (`recall_target`,
    `budget_tau`, `adaptive`) plans one keep mask for the batch over the
    probes the engine then scans (`probe_budget.search_plan`), with radius
    bounds for L2 metrics when the index has radii, no tombstones and no
    prefilter is given."""
    from raft_tpu_torch.core.bitset import make_slot_filter
    from raft_tpu_torch.matrix.select_k import check_fused_list_request
    from raft_tpu_torch.neighbors.probe_invert import macro_batched, resolve_setup_impls
    from raft_tpu_torch.ops.pq_list_scan import _BINS, fits_pq_list_scan, fold_variant, lane_padded

    q = check_matrix(queries, device=index.device, name="queries").float()
    if q.shape[1] != index.dim:
        raise ValueError(f"query dim {q.shape[1]} != index dim {index.dim}")
    if index.size == 0:
        raise ValueError("index is empty")
    n_probes = int(min(max(1, params.n_probes), index.n_lists))
    lpad = lane_padded(int(index.codes.shape[1]))
    mode, trim, idd = resolve_search(params, q.shape[0], n_probes, index.n_lists, index.device,
                                     k=int(k), L=lpad, rot=index.rot_dim, kbuf=index.fused_kb)
    int8 = params.score_dtype == "int8"
    per_cluster = index.params.codebook_kind == PER_CLUSTER
    # bounds off under a prefilter or tombstones: the sizes count the
    # members they drop
    ap = probe_budget.resolve_params(params, n_probes, index.device)
    plan = probe_budget.search_plan(
        ap, q, index.centers,
        n_probes=n_probes, k=int(k), metric=index.metric, rotation=index.rotation,
        radii=index.list_radii if prefilter is None and index.tombstones is None else None,
        sizes=index.list_sizes)
    if obs.enabled():
        scanned_mean = (probe_budget.account_plan("ivf_pq", plan, q.shape[0], n_probes)
                        if ap is not None else None)
        # the JAX charge: list-major modes but the fused trim as a scan of
        # every padded list, query-major modes and the fused trim the
        # probed lists (the adaptive mean where budgets are on); the fused
        # and pallas trims never materialize the score tile
        obs.span_cost(**obs.perf.cost_for(
            "neighbors.ivf_pq.search", nq=int(q.shape[0]), n_probes=n_probes,
            n_lists=int(index.n_lists),
            n_rows=int(index.codes.shape[0] * index.codes.shape[1]) - index.n_tombstones,
            dim=int(index.dim), pq_dim=int(index.pq_dim), k=int(k), dtype=params.score_dtype,
            scanned_lists=(int(index.n_lists) if (mode.endswith("_list") and trim != "fused")
                           else (scanned_mean if scanned_mean is not None else n_probes)),
            fused=mode == "recon8_list" and trim in ("pallas", "fused")))
    # a filtered view of a slot table is the whole prefilter (and the
    # whole tombstone mask): every engine scores its -1 slots as the worst
    maybe_filter = make_slot_filter(prefilter, index.id_bound, index.source_ids,
                                    tombstones=index.tombstones)
    # the list-major engines' (invert_impl, qs_impl), resolved once a search
    setup = resolve_setup_impls(index.n_lists, device=index.device)
    if mode == "lut":
        vals, rows = _search_impl(q, index.rotation, index.centers, index.pq_centers,
                                  index.codes, maybe_filter(index.slot_rows), int(k), n_probes,
                                  index.metric, per_cluster, params.lut_dtype == "bfloat16",
                                  plan=plan)
    elif mode == "recon8":
        build_reconstruction(index)
        vals, rows = _search_impl_recon8(q, index.rotation, index.centers, index.recon8,
                                         index.recon_scale, index.recon_norm,
                                         maybe_filter(index.slot_rows_pad), int(k), n_probes,
                                         index.metric, plan=plan)
    elif trim in ("approx", "exact"):
        build_reconstruction(index)
        srows_pad = maybe_filter(index.slot_rows_pad)
        chunk = resolve_listmajor_chunk(q.shape[0], n_probes, index.n_lists, index.device)
        vals, rows = macro_batched(
            lambda sl, pl=None: _search_impl_recon8_listmajor(
                sl, index.rotation, index.centers, index.recon8, index.recon_scale,
                index.recon_norm, srows_pad, int(k), n_probes, index.metric, chunk=chunk,
                int8_queries=int8, trim_bf16=idd != "float32", plan=pl,
                setup_impls=setup), q, int(k), extra=plan)
    elif trim == "fused":
        # at the buffer width the kernel will run with
        kb = check_fused_list_request("trim_engine='fused'", lpad, index.rot_dim, int(k),
                                      index.fused_kb, "trim_engine='pallas'", q_int8=int8)
        build_reconstruction(index)
        index.fused_kb = kb
        srows_pad = maybe_filter(index.slot_rows_pad)
        vals, rows = macro_batched(
            lambda sl, pl=None: _search_impl_recon8_listmajor_fused(
                sl, index.rotation, index.centers, index.recon8, index.recon_scale,
                index.recon_norm, srows_pad, int(k), n_probes, index.metric, kb=kb,
                int8_queries=int8, plan=pl, setup_impls=setup), q, int(k), extra=plan)
    else:
        if int(k) > _BINS:
            raise ValueError(f"trim_engine='pallas' caps per-list candidates at {_BINS}; k={k}")
        if not fits_pq_list_scan(lpad, index.rot_dim, int8):
            raise ValueError(
                f"trim_engine='pallas': list length {lpad} or rot_dim {index.rot_dim} exceed "
                "the kernel's shared-memory budget; use trim_engine='fused'")
        build_reconstruction(index)
        fold = fold_variant(index.device)
        srows_pad = maybe_filter(index.slot_rows_pad)
        vals, rows = macro_batched(
            lambda sl, pl=None: _search_impl_recon8_listmajor_pallas(
                sl, index.rotation, index.centers, index.recon8, index.recon_scale,
                index.recon_norm, srows_pad, int(k), n_probes, index.metric,
                int8_queries=int8, fold=fold, plan=pl, setup_impls=setup), q, int(k),
            extra=plan)
    ids = torch.where(rows >= 0, index.source_ids[torch.clamp(rows, min=0).long()], -1)
    return vals, ids.to(torch.int32)
