"""Shared k-means machinery: blocked assign + centroid reduce
(counterpart of raft_tpu/cluster/kmeans_common.py).

One pass over row blocks computes each block's (bm, k) distance tile with
a full-float32 matmul, its argmin (ties to the lower center id, as
`jnp.argmin`), and the per-center sums as a one-hot matmul, as the JAX
package does: unlike `index_add_`, whose float atomics add in a
different order on every run, it gives the same centers from the same
seed. Every function takes an optional leading batch axis, so the PQ
trainer runs all of its independent per-subspace problems in one call
(the JAX package vmaps).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.config import strict_f32_matmul


def _block_rows(m: int, k: int, d: int, batch: int = 1,
                budget_elems: int = 1 << 23) -> int:
    bm = max(1, budget_elems // max(1, batch * (k + d)))
    return max(1, min(bm, m))


def assign_and_reduce(x: torch.Tensor, centers: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      needs_sums: bool = True, precision=None, budget_elems: int = 1 << 23
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stream x once; return (labels, sums, counts, inertia).

    x (n, d) or (B, n, d); centers (k, d) or (B, k, d); weights (n,) or
    (B, n). labels int64 nearest-center ids; sums (k, d) weighted
    per-center coordinate sums (zeros if not `needs_sums`); counts (k,)
    weighted member counts; inertia the weighted sum of min squared L2
    distances (per batch entry when batched). Rows go in blocks of about
    `budget_elems` / (k + d) (the distributed k-means passes a larger
    budget: fewer, larger launches). `precision` (the JAX package's MXU
    precision of the distance matmul) is accepted and ignored, as
    `KMeansParams.precision` is: f32 with TF32 off."""
    strict_f32_matmul()
    batched = x.ndim == 3
    xb3 = x.float() if batched else x.float()[None]
    cb3 = centers.float() if batched else centers.float()[None]
    w3 = None
    if weights is not None:
        w3 = weights.float() if batched else weights.float()[None]
    B, n, d = xb3.shape
    k = cb3.shape[1]
    dev = xb3.device
    cn = torch.sum(cb3 * cb3, dim=2)  # (B, k)
    labels = torch.empty((B, n), dtype=torch.int64, device=dev)
    sums = torch.zeros((B, k, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((B, k), dtype=torch.float32, device=dev)
    inertia = torch.zeros((B,), dtype=torch.float32, device=dev)
    bm = _block_rows(n, k, d, B, budget_elems)
    for s in range(0, n, bm):
        xs = xb3[:, s:s + bm]
        xn = torch.sum(xs * xs, dim=2, keepdim=True)
        dist = torch.clamp(xn + cn[:, None, :] - 2.0 * torch.bmm(xs, cb3.transpose(1, 2)),
                           min=0.0)
        best, lbl = torch.min(dist, dim=2)
        labels[:, s:s + bm] = lbl
        wb = torch.ones_like(best) if w3 is None else w3[:, s:s + bm]
        onehot = torch.nn.functional.one_hot(lbl, k).float() * wb[..., None]  # (B, bm, k)
        counts += torch.sum(onehot, dim=1)
        if needs_sums:
            sums += torch.bmm(onehot.transpose(1, 2), xs)
        inertia += torch.sum(best * wb, dim=1)
    if batched:
        return labels, sums, counts, inertia
    return labels[0], sums[0], counts[0], inertia[0]


def predict_labels(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    labels, _, _, _ = assign_and_reduce(x, centers, needs_sums=False)
    return labels


def cluster_cost_impl(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Sum of every row's squared L2 distance to its nearest center."""
    _, _, _, inertia = assign_and_reduce(x, centers, needs_sums=False)
    return inertia
