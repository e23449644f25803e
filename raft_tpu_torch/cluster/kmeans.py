"""k-means seeding (counterpart of raft_tpu/cluster/kmeans.py).

Only the k-means++ initializer is ported in this slice: balanced k-means
seeds with it up to 512 clusters. The Lloyd trainer and its public
`fit`/`predict` are still to be ported.
"""

from __future__ import annotations

import torch


def _kmeans_plusplus(gen: torch.Generator, x: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """k-means++ seeding (detail/kmeans.cuh:88 kmeansPlusPlus): each next
    center is a row drawn with probability proportional to its squared
    distance to the nearest center chosen so far."""
    n, d = x.shape
    xf = x.float()
    centers = torch.empty((n_clusters, d), dtype=torch.float32, device=x.device)
    first = int(torch.randint(0, n, (1,), generator=gen, device=x.device))
    centers[0] = xf[first]
    mind = torch.sum((xf - xf[first]) ** 2, dim=1)
    for i in range(1, n_clusters):
        total = torch.sum(mind)
        probs = mind / torch.clamp(total, min=1e-30)
        if float(total) <= 0.0:  # every row sits on a center: draw uniformly
            probs = torch.ones_like(mind)
        nxt = torch.multinomial(probs, 1, generator=gen)
        c = xf[nxt[0]]
        centers[i] = c
        mind = torch.minimum(mind, torch.sum((xf - c) ** 2, dim=1))
    return centers
