"""Vector quantizers of the IVF indexes (counterpart of
raft_tpu/neighbors/quantizer.py).

  `PqQuantizer`      product quantization. Per-subspace codebooks (every
                     subspace trains its own 2^pq_bits-entry codebook)
                     or per-cluster ones (every list trains one codebook
                     over the pooled subvectors of its residuals); either
                     way one batched balanced-EM call trains them all
                     (the JAX package vmaps the same trainer).
  `RabitqQuantizer`  RaBitQ: the sign bits of a rotated residual packed
                     into 32-bit words, plus two correction scalars per
                     row (|r| and <o, x_bar>), scored by AND+popcount
                     over the query's quantized bit planes and the
                     unbiased estimator <q, x_bar> / <o, x_bar>.

Packed words are `int32` tensors holding the bits of the JAX package's
`uint32` words (carry them across with `.view(np.int32)`): torch has no
popcount and no shifts on `uint32`, so the bit helpers work in `int64`
(`pack_bits`, `unpack_bits`, and `popcount32`, which lives beside the
bit-plane kernel and its scorer `bitplane_scores` in ops/fused_scan.py).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from raft_tpu_torch.cluster.kmeans_balanced import _balanced_em
from raft_tpu_torch.core.config import strict_f32_matmul
from raft_tpu_torch.ops.fused_scan import _as_uint_values, _fma_f32, popcount32, rsqrt_dim

PER_SUBSPACE = "per_subspace"
PER_CLUSTER = "per_cluster"


def _train_codebooks_per_subspace(gen: torch.Generator, residuals: torch.Tensor,
                                  pq_dim: int, n_codebook: int, n_iters: int) -> torch.Tensor:
    """residuals (n, rot_dim) -> (pq_dim, n_codebook, pq_len) codebooks
    (train_per_subset, ivf_pq_build.cuh:393). Each subspace starts from
    distinct random rows (with replacement when n < n_codebook)."""
    n, rot_dim = residuals.shape
    pq_len = rot_dim // pq_dim
    sub = residuals.float().reshape(n, pq_dim, pq_len).transpose(0, 1).contiguous()
    dev = residuals.device
    if n < n_codebook:
        init_idx = torch.randint(0, n, (pq_dim, n_codebook), generator=gen, device=dev)
    else:
        keys = torch.rand((pq_dim, n), generator=gen, device=dev)
        init_idx = torch.topk(keys, n_codebook, dim=1).indices
    inits = torch.gather(sub, 1, init_idx[..., None].expand(-1, -1, pq_len))
    return _balanced_em(gen, sub, inits, n_iters, "sqeuclidean")


def _train_codebooks_per_cluster(gen: torch.Generator, residuals: torch.Tensor,
                                 labels: torch.Tensor, n_lists: int, pq_len: int,
                                 n_codebook: int, n_iters: int,
                                 samples_per_cluster: int = 2048) -> torch.Tensor:
    """Per-cluster codebooks (train_per_cluster, ivf_pq_build.cuh:473):
    residuals (n, rot_dim) with their lists `labels` -> (n_lists,
    n_codebook, pq_len). Each list trains one codebook over the pooled
    pq_len-subvectors of its residuals, all lists in one batched EM. A
    list's `samples_per_cluster` training subvectors are drawn on the
    device: without replacement from its subvectors when it has enough,
    with replacement when it has fewer, and gaussian when it has none (as
    the JAX package's host loop draws them)."""
    n, rot_dim = residuals.shape
    pq_dim = rot_dim // pq_len
    dev = residuals.device
    sub = residuals.float().reshape(n * pq_dim, pq_len)
    sub_labels = labels.long().repeat_interleave(pq_dim)
    # each list's subvectors in a random order: sort by (list, random key)
    keys = sub_labels.double() + torch.rand(sub.shape[0], generator=gen, device=dev,
                                            dtype=torch.float64)
    order = torch.argsort(keys)
    counts = torch.bincount(sub_labels, minlength=n_lists)
    starts = torch.cumsum(counts, 0) - counts
    j = torch.arange(samples_per_cluster, device=dev)[None, :]
    redraw = torch.floor(torch.rand((n_lists, samples_per_cluster), generator=gen, device=dev)
                         * counts[:, None]).long()
    pos = torch.where(counts[:, None] >= samples_per_cluster, j, redraw)
    take = order[torch.clamp(starts[:, None] + pos, max=sub.shape[0] - 1)]
    batch = sub[take]  # (n_lists, spc, pq_len)
    empty = counts == 0
    if bool(empty.any()):
        noise = torch.randn((n_lists, samples_per_cluster, pq_len), generator=gen, device=dev)
        batch = torch.where(empty[:, None, None], noise, batch)
    init_idx = torch.topk(torch.rand((n_lists, samples_per_cluster), generator=gen, device=dev),
                          n_codebook, dim=1).indices
    inits = torch.gather(batch, 1, init_idx[..., None].expand(-1, -1, pq_len))
    return _balanced_em(gen, batch, inits, n_iters, "sqeuclidean")


def _encode(residuals: torch.Tensor, labels: Optional[torch.Tensor], pq_centers: torch.Tensor,
            per_cluster: bool = False, block_elems: int = 1 << 26) -> torch.Tensor:
    """Residuals (n, rot_dim) -> codes (n, pq_dim) uint8, the nearest
    codebook entry of each subvector (compute_pq_code,
    ivf_pq_build.cuh:578), ties to the lower entry as `jnp.argmin`.
    Per-subspace codebooks (pq_dim, nb, pq_len); per-cluster ones
    (n_lists, nb, pq_len), each row against its list's (`labels`)."""
    strict_f32_matmul()
    n, rot_dim = residuals.shape
    nb, pq_len = pq_centers.shape[1:]
    pq_dim = rot_dim // pq_len
    cb = pq_centers.float()
    cn = torch.sum(cb * cb, dim=2)  # (books, nb)
    codes = torch.empty((n, pq_dim), dtype=torch.uint8, device=residuals.device)
    bm = max(1, block_elems // max(1, pq_dim * nb + (nb * pq_len if per_cluster else 0)))
    for s in range(0, n, bm):
        rb = residuals[s:s + bm].float().reshape(-1, pq_dim, pq_len)
        if per_cluster:
            lb = labels[s:s + bm].long()
            d = (torch.sum(rb * rb, dim=2)[:, :, None]
                 - 2.0 * torch.bmm(rb, cb[lb].transpose(1, 2))
                 + cn[lb][:, None, :])  # (bm, pq_dim, nb)
            codes[s:s + bm] = torch.argmin(d, dim=2).to(torch.uint8)
        else:
            rb = rb.transpose(0, 1)
            d = (torch.sum(rb * rb, dim=2)[:, :, None]
                 - 2.0 * torch.bmm(rb, cb.transpose(1, 2))
                 + cn[:, None, :])  # (pq_dim, bm, nb)
            codes[s:s + bm] = torch.argmin(d, dim=2).T.to(torch.uint8)
    return codes


class Quantizer:
    """The verb every quantizer shares: the exact re-rank of candidate
    rows through neighbors/refine, so a lossy code format never reaches
    the exact stage."""

    kind = "?"

    def rerank_candidates(self, dataset, queries, candidates, k: int, metric="sqeuclidean",
                          resources=None):
        """Exact re-rank of candidate rows through the shared refine stage
        (`neighbors.refine`, its default dispatch), on the candidates'
        device; `resources` is passed on."""
        from raft_tpu_torch.neighbors.refine import refine

        return refine(dataset, queries, candidates, k, metric=metric, resources=resources,
                      device=torch.as_tensor(candidates).device)


class PqQuantizer(Quantizer):
    """Product-quantization state: per-subspace codebooks
    (pq_dim, 2^pq_bits, pq_len) or per-cluster ones (n_lists, 2^pq_bits,
    pq_len)."""

    kind = "pq"

    def __init__(self, codebook_kind: str = PER_SUBSPACE, pq_bits: int = 8,
                 pq_dim: int = 0, pq_len: int = 0, n_lists: int = 0,
                 pq_centers: Optional[torch.Tensor] = None, n_iters: int = 25):
        if codebook_kind not in (PER_SUBSPACE, PER_CLUSTER):
            raise ValueError(f"bad codebook_kind {codebook_kind}")
        self.codebook_kind = codebook_kind
        self.pq_bits = int(pq_bits)
        self.pq_dim = int(pq_dim)
        self.pq_len = int(pq_len)
        self.n_lists = int(n_lists)
        self.n_iters = int(n_iters)
        self.pq_centers = pq_centers

    @property
    def per_cluster(self) -> bool:
        return self.codebook_kind == PER_CLUSTER

    @classmethod
    def from_centers(cls, pq_centers: torch.Tensor, per_cluster: bool = False) -> "PqQuantizer":
        """Wrap already-trained codebooks (the encode-only path of extend)."""
        q = cls(PER_CLUSTER if per_cluster else PER_SUBSPACE,
                pq_len=int(pq_centers.shape[-1]))
        q.pq_centers = pq_centers
        return q

    def train(self, key: torch.Generator, residuals: torch.Tensor, labels=None) -> "PqQuantizer":
        """Fit the codebooks to a residual sample, drawing from `key` (a
        `torch.Generator` where the JAX package takes a PRNG key);
        per-cluster training needs the residuals' lists (`labels`)."""
        nb = 1 << self.pq_bits
        if self.per_cluster:
            self.pq_centers = _train_codebooks_per_cluster(
                key, residuals, labels, self.n_lists, self.pq_len, nb, self.n_iters)
        else:
            self.pq_centers = _train_codebooks_per_subspace(
                key, residuals, self.pq_dim, nb, self.n_iters)
        return self

    def encode(self, residuals: torch.Tensor, labels=None) -> Dict[str, torch.Tensor]:
        return {"codes": _encode(residuals, labels, self.pq_centers, self.per_cluster)}


# ---------------------------------------------------------------------------
# RaBitQ bit codes
# ---------------------------------------------------------------------------

WORD_BITS = 32
#: query-side quantization bits of the bit-plane scan (the JAX package's
#: fallback when no tuned value exists; tuned values do not carry over)
DEFAULT_QUERY_BITS = 8
_SIGN32 = 1 << 31


def packed_words(rot_dim: int) -> int:
    """32-bit words per packed code row (rot_dim must be 32-aligned)."""
    if rot_dim % WORD_BITS:
        raise ValueError(f"rot_dim {rot_dim} must be a multiple of {WORD_BITS}")
    return rot_dim // WORD_BITS


def _as_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same 32 bits."""
    return torch.where(v >= _SIGN32, v - (1 << 32), v).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., rot_dim) {0,1} -> (..., W) int32 little-endian words (bit i
    of word w = dimension w*32 + i), built in int64 so that bit 31 does
    not overflow."""
    b = bits.to(torch.int64)
    w = b.reshape(*b.shape[:-1], -1, WORD_BITS)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=b.device)
    return _as_int32_bits(torch.sum(w << shifts, dim=-1))


def unpack_bits(words: torch.Tensor, rot_dim: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., rot_dim) {0,1} int32, pack's inverse."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=words.device)
    bits = (_as_uint_values(words)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], rot_dim).to(torch.int32)


_XLA_BLOCK = 32


def sqrt_f32(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as the reference's: through
    float64, since torch's vectorized CPU sqrt is not correctly rounded."""
    return torch.sqrt(v.double()).float()


def ordered_row_sum(x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of x (or of x * y) over the last axis in the order the JAX
    reference's compiled reduction takes on the CPU (checked for rows of
    up to 128): a row of at most 32 is summed left to right from 0, the
    products as fused multiply-adds; a longer row is cut into blocks of 32
    (the last padded with zeros), each block summed left to right from its
    rounded terms, then the block sums the same way. RaBitQ's sums go
    through here (|r| and sum |r| at encode; each (query, list) pair's
    residual sum and qconst at search), so that the port's estimator
    agrees with the reference's: torch.sum's order moves near-tie ranks.
    It costs one step per element of a block; the summed axis is moved to
    the front once, so that each step reads contiguous memory."""
    D = x.shape[-1]
    if D <= _XLA_BLOCK:
        shape = torch.broadcast_shapes(x.shape, x.shape if y is None else y.shape)
        xt = x.expand(shape).movedim(-1, 0).contiguous()
        yt = None if y is None else y.expand(shape).movedim(-1, 0).contiguous()
        acc = torch.zeros(shape[:-1], dtype=torch.float32, device=x.device)
        for i in range(D):
            acc = acc + xt[i] if y is None else _fma_f32(xt[i], yt[i], acc)
        return acc
    if y is not None:
        x = x * y
    blocks = torch.nn.functional.pad(x, (0, (-D) % _XLA_BLOCK)).reshape(*x.shape[:-1], -1,
                                                                       _XLA_BLOCK)
    bt = blocks.movedim(-1, 0).contiguous()
    acc = torch.zeros(blocks.shape[:-1], dtype=torch.float32, device=x.device)
    for i in range(_XLA_BLOCK):
        acc = acc + bt[i]
    return ordered_row_sum(acc)


def quantize_queries(qres: torch.Tensor, query_bits: int):
    """Per-row scalar quantization of query residuals for the bit-plane
    scan: qres_i ~= lo + delta * u_i with u in [0, 2^bits). Returns
    (planes (..., bits, W) int32, lo (..., 1), delta (..., 1)).

    delta is (hi - lo) times the f32 reciprocal of the level count: the
    jitted JAX reference compiles its division by that constant to this
    multiply, and delta moves every plane bit. torch.round rounds half to
    even, as jnp.round does."""
    lo = torch.amin(qres, dim=-1, keepdim=True)
    hi = torch.amax(qres, dim=-1, keepdim=True)
    levels = (1 << query_bits) - 1
    inv_levels = float(np.float32(1.0) / np.float32(levels))
    delta = torch.clamp((hi - lo) * inv_levels, min=1e-12)
    u = torch.clamp(torch.round((qres - lo) / delta), 0, levels).to(torch.int32)
    planes = torch.stack([pack_bits((u >> j) & 1) for j in range(query_bits)], dim=-2)
    return planes, lo, delta


def binary_dot(codes: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """sum_{i: code bit i set} u_i by AND+popcount over the query's bit
    planes, the fast scan's integer core. `codes` (..., W) int32
    broadcast against `planes` (..., bits, W); returns f32 of the
    broadcast shape minus the (bits, W) axes (exact below 2^24)."""
    per_plane = torch.sum(popcount32(codes[..., None, :] & planes), dim=-1)  # (..., bits)
    weights = 1 << torch.arange(per_plane.shape[-1], dtype=torch.int32, device=planes.device)
    return torch.sum(per_plane * weights, dim=-1).float()


def estimate_dot(s_set, pop, qsum, o_dot, rot_dim: int) -> torch.Tensor:
    """The unbiased RaBitQ estimator of <q_res, o>: <q_res, x_bar> /
    <o, x_bar>, with <q_res, x_bar> = (2*S - sum(q_res)) / sqrt(D) and S
    the sum of q_res over the set bits. `pop` is unused (S already folds
    it), as in the JAX signature."""
    del pop
    return ((2.0 * s_set - qsum) * rsqrt_dim(rot_dim)) / torch.clamp(o_dot, min=1e-12)


class RabitqQuantizer(Quantizer):
    """RaBitQ: 1-bit sign codes over rotated residuals plus two
    correction scalars per row.

    encode(residuals) returns
        codes (n, W) int32    packed sign bits of the rotated residual
        aux   (n, 2) f32      [|r|, <o, x_bar>] with o = r/|r| and
                              x_bar = sign(r)/sqrt(D)
    The estimator: <q, o> ~= <q, x_bar>/<o, x_bar>, unbiased over the
    random rotation, so |q - v|^2 ~= |q_res|^2 + |r|^2 - 2|r| <q,o>.
    Training is a no-op: there is nothing to fit."""

    kind = "rabitq"

    def __init__(self, rot_dim: int, query_bits: int = DEFAULT_QUERY_BITS):
        self.rot_dim = int(rot_dim)
        self.words = packed_words(self.rot_dim)
        if not (1 <= int(query_bits) <= 8):
            raise ValueError(f"query_bits must be in [1, 8], got {query_bits}")
        self.query_bits = int(query_bits)

    def train(self, key, residuals, labels=None) -> "RabitqQuantizer":
        return self

    def encode(self, residuals: torch.Tensor, labels=None) -> Dict[str, torch.Tensor]:
        r = residuals.float()
        # the sums in the reference build's order and a correctly rounded
        # square root, so that aux agrees with the reference bit for bit
        rnorm = sqrt_f32(ordered_row_sum(r, r))
        # zero residuals (a row on its center) get o_dot 1 so the
        # correction divide stays finite; rnorm 0 zeroes their term
        denom = torch.clamp(rnorm, min=1e-30) * float(np.float32(math.sqrt(float(self.rot_dim))))
        o_dot = torch.where(rnorm > 0, ordered_row_sum(torch.abs(r)) / denom,
                            torch.ones_like(rnorm))
        return {"codes": pack_bits(r >= 0), "aux": torch.stack([rnorm, o_dot], dim=-1)}

    def decode(self, payload: Dict[str, torch.Tensor]) -> torch.Tensor:
        """|r| <o, x_bar> x_bar: the L2-optimal reconstruction of the
        residual from its sign code."""
        signs = unpack_bits(payload["codes"], self.rot_dim) * 2 - 1
        aux = payload["aux"].float()
        scale = aux[..., 0] * aux[..., 1] / float(np.float32(math.sqrt(float(self.rot_dim))))
        return signs.float() * scale[..., None]

    def score_table(self, query_residuals: torch.Tensor, **kw) -> Dict[str, torch.Tensor]:
        qres = query_residuals.float()
        planes, lo, delta = quantize_queries(qres, self.query_bits)
        return {"planes": planes, "lo": lo, "delta": delta,
                "qsum": torch.sum(qres, dim=-1, keepdim=True),
                "qnorm2": torch.sum(qres * qres, dim=-1, keepdim=True)}

    def estimate_distances(self, table, payload, exact_queries=None) -> torch.Tensor:
        """(nq, m) estimated squared L2 distances. With `exact_queries`
        (the raw (nq, rot_dim) residuals) the set-bit sums are exact f32
        dots instead of the quantized planes."""
        codes = payload["codes"]
        aux = payload["aux"].float()
        rnorm, o_dot = aux[..., 0], aux[..., 1]
        pop = torch.sum(popcount32(codes), dim=-1).float()  # (m,)
        if exact_queries is not None:
            strict_f32_matmul()
            q = exact_queries.float()
            s = q @ unpack_bits(codes, self.rot_dim).float().T
            qsum = torch.sum(q, dim=-1, keepdim=True)
            qnorm2 = torch.sum(q * q, dim=-1, keepdim=True)
        else:
            s_u = binary_dot(codes[None, :, :], table["planes"][:, None])
            s = table["lo"] * pop[None, :] + table["delta"] * s_u
            qsum, qnorm2 = table["qsum"], table["qnorm2"]
        est = estimate_dot(s, pop, qsum, o_dot[None, :], self.rot_dim)
        return qnorm2 + rnorm[None, :] ** 2 - 2.0 * rnorm[None, :] * est

    # -- serialize hooks (the index's save writes them) --
    def state_arrays(self) -> Dict[str, torch.Tensor]:
        return {}

    def state_meta(self) -> dict:
        return {"quantizer": self.kind, "rot_dim": self.rot_dim,
                "query_bits": self.query_bits}

    @classmethod
    def from_state(cls, arrays, meta) -> "RabitqQuantizer":
        return cls(int(meta["rot_dim"]), int(meta.get("query_bits", DEFAULT_QUERY_BITS)))
