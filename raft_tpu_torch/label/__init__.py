"""Label utilities (counterpart of raft_tpu/label): `get_unique_labels` and
`make_monotonic` (label/classlabels.cuh) and `merge_labels`
(label/merge_labels.cuh).

Integer labels come back as int32, as the JAX package returns them (its
int64 arrays become int32 with x64 off); float labels keep their dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.validation import as_tensor

__all__ = [
    "get_unique_labels",
    "make_monotonic",
    "merge_labels",
]


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_floating_point() else t.to(torch.int32)


def get_unique_labels(labels, device=None) -> torch.Tensor:
    """Sorted unique labels (classlabels.cuh getUniquelabels)."""
    return _int32(torch.unique(as_tensor(labels, device), sorted=True))


def make_monotonic(labels, ignore_value: Optional[int] = None,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Labels remapped to 0..n_unique-1 in the order of their values
    (classlabels.cuh make_monotonic): (int32 monotonic labels, sorted
    unique values). With `ignore_value`, that value is left out of the
    unique values and kept where it stands.

    Host numpy integer labels take the C++ host library (one sort and
    dedup pass) when it is available; tensors stay on their device."""
    if (ignore_value is None and isinstance(labels, np.ndarray)
            and np.issubdtype(labels.dtype, np.integer)):
        from raft_tpu_torch import native

        packed = native.make_monotonic(labels)
        if packed is not None:
            mono, uniq = packed
            return (as_tensor(mono, device).to(torch.int32),
                    as_tensor(uniq, device).to(torch.int32))
    lab = as_tensor(labels, device)
    uniq = torch.unique(lab, sorted=True)
    if ignore_value is not None:
        uniq = uniq[uniq != ignore_value]
    mono = torch.searchsorted(uniq, lab)
    if ignore_value is not None:
        mono = torch.where(lab == ignore_value, ignore_value, mono)
    return mono.to(torch.int32), _int32(uniq)


def merge_labels(labels_a, labels_b, mask=None, max_iter: Optional[int] = None,
                 device=None) -> torch.Tensor:
    """Merge two labelings (merge_labels.cuh): labels that share a point
    collapse to their minimum. Each round takes every point's minimum over
    its a-group and then over its b-group (masked points neither give nor
    take) until nothing changes; the host reads one flag a round."""
    a = as_tensor(labels_a, device).long()
    b = as_tensor(labels_b, a.device).long()
    n = a.shape[0]
    na = int(a.max()) + 1 if n else 1
    nb = int(b.max()) + 1 if n else 1
    m = (torch.ones((n,), dtype=torch.bool, device=a.device) if mask is None
         else as_tensor(mask, a.device).bool())
    cur = a.float()

    def seg_min(vals, keys, num):
        out = torch.full((num,), torch.inf, dtype=torch.float32, device=a.device)
        return out.scatter_reduce_(0, keys, torch.where(m, vals, torch.inf), "amin",
                                   include_self=True)

    changed = True
    while changed:
        cur1 = torch.where(m, torch.minimum(cur, seg_min(cur, a, na)[a]), cur)
        cur2 = torch.where(m, torch.minimum(cur1, seg_min(cur1, b, nb)[b]), cur1)
        changed = bool(torch.any(cur2 != cur))
        cur = cur2
    return cur.to(torch.int32)
