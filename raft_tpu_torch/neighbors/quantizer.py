"""Product quantizer: codebook training and encode (counterpart of the
`PqQuantizer` part of raft_tpu/neighbors/quantizer.py).

Per-subspace codebooks only in this slice: every subspace trains its own
2^pq_bits-entry codebook with balanced EM, all subspaces in one batched
call (the JAX package vmaps the same trainer). Per-cluster codebooks and
the RaBitQ quantizer are still to be ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from raft_tpu_torch.cluster.kmeans_balanced import _balanced_em
from raft_tpu_torch.core.config import strict_f32_matmul

PER_SUBSPACE = "per_subspace"
PER_CLUSTER = "per_cluster"


def _per_cluster_not_ported():
    return NotImplementedError(
        "codebook_kind='per_cluster' is not ported yet (ROADMAP Queue A, "
        "left out of the first slice)"
    )


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


def _encode(residuals: torch.Tensor, pq_centers: torch.Tensor,
            block_elems: int = 1 << 26) -> torch.Tensor:
    """Residuals (n, rot_dim) -> codes (n, pq_dim) uint8: per-subspace
    nearest codebook entry (compute_pq_code, ivf_pq_build.cuh:578), ties
    to the lower entry as `jnp.argmin`."""
    strict_f32_matmul()
    n, rot_dim = residuals.shape
    pq_dim, nb, pq_len = pq_centers.shape
    cb = pq_centers.float()
    cn = torch.sum(cb * cb, dim=2)  # (pq_dim, nb)
    codes = torch.empty((n, pq_dim), dtype=torch.uint8, device=residuals.device)
    bm = max(1, block_elems // max(1, pq_dim * nb))
    for s in range(0, n, bm):
        rb = residuals[s:s + bm].float().reshape(-1, pq_dim, pq_len).transpose(0, 1)
        d = (torch.sum(rb * rb, dim=2)[:, :, None]
             - 2.0 * torch.bmm(rb, cb.transpose(1, 2))
             + cn[:, None, :])  # (pq_dim, bm, nb)
        codes[s:s + bm] = torch.argmin(d, dim=2).T.to(torch.uint8)
    return codes


class PqQuantizer:
    """Product-quantization state: per-subspace codebooks
    (pq_dim, 2^pq_bits, pq_len)."""

    kind = "pq"

    def __init__(self, codebook_kind: str = PER_SUBSPACE, pq_bits: int = 8,
                 pq_dim: int = 0, pq_len: int = 0, n_lists: int = 0,
                 pq_centers: Optional[torch.Tensor] = None, n_iters: int = 25):
        if codebook_kind not in (PER_SUBSPACE, PER_CLUSTER):
            raise ValueError(f"bad codebook_kind {codebook_kind}")
        if codebook_kind == PER_CLUSTER:
            raise _per_cluster_not_ported()
        self.codebook_kind = codebook_kind
        self.pq_bits = int(pq_bits)
        self.pq_dim = int(pq_dim)
        self.pq_len = int(pq_len)
        self.n_lists = int(n_lists)
        self.n_iters = int(n_iters)
        self.pq_centers = pq_centers

    @classmethod
    def from_centers(cls, pq_centers: torch.Tensor, per_cluster: bool = False) -> "PqQuantizer":
        """Wrap already-trained codebooks (the encode-only path of extend)."""
        if per_cluster:
            raise _per_cluster_not_ported()
        q = cls(PER_SUBSPACE, pq_dim=int(pq_centers.shape[0]),
                pq_len=int(pq_centers.shape[-1]))
        q.pq_centers = pq_centers
        return q

    def train(self, gen: torch.Generator, residuals: torch.Tensor, labels=None) -> "PqQuantizer":
        self.pq_centers = _train_codebooks_per_subspace(
            gen, residuals, self.pq_dim, 1 << self.pq_bits, self.n_iters)
        return self

    def encode(self, residuals: torch.Tensor, labels=None) -> Dict[str, torch.Tensor]:
        return {"codes": _encode(residuals, self.pq_centers)}
