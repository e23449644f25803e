"""Isotropic Gaussian blobs (counterpart of raft_tpu/random/make_blobs.py;
random/make_blobs.cuh:63): centres given or uniform in `center_box`, a
label a row, the row its centre plus `cluster_std` gaussian noise,
optionally shuffled. Draws come from a `torch.Generator` on the target
device (`generator`, or one seeded with `seed`), so they differ from the
JAX package's by construction; their distributions are the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.config import resolve_device
from raft_tpu_torch.random.rng import generator_of, make_generator


def make_blobs(n_samples: int, n_features: int, centers=None, n_clusters: int = 5,
               cluster_std: float = 1.0, shuffle: bool = True,
               center_box: Tuple[float, float] = (-10.0, 10.0), seed: int = 0,
               dtype=torch.float32, state=None, generator: Optional[torch.Generator] = None,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(data (n_samples, n_features), labels (n_samples,) int32). The
    draws come from `state` (an `RngState`, as in the JAX package) or
    `generator`, else from a generator seeded with `seed`."""
    generator = generator_of(state, generator)
    dev = resolve_device(device if generator is None or device is not None
                         else generator.device)
    gen = make_generator(seed, dev) if generator is None else generator
    if centers is None:
        lo, hi = float(center_box[0]), float(center_box[1])
        centers = lo + (hi - lo) * torch.rand((n_clusters, n_features), generator=gen,
                                              device=dev)
    else:
        centers = torch.as_tensor(centers, device=dev).float()
        n_clusters = centers.shape[0]
    labels = torch.randint(0, n_clusters, (n_samples,), generator=gen, device=dev)
    data = centers[labels] + cluster_std * torch.randn((n_samples, n_features), generator=gen,
                                                       device=dev)
    if shuffle:
        perm = torch.randperm(n_samples, generator=gen, device=dev)
        data, labels = data[perm], labels[perm]
    return data.to(dtype), labels.to(torch.int32)
