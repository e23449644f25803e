"""List-packing helpers of the IVF indexes (counterpart of the helpers
in raft_tpu/neighbors/ivf_flat.py that IVF-PQ builds on).

An IVF index keeps each list in a padded slot table: (n_lists, max_list,
...) payload plus (n_lists, max_list) source-row positions, -1 on empty
slots. The IVF-Flat index itself is still to be ported.
"""

from __future__ import annotations

import numpy as np
import torch


def _pack_lists(labels: np.ndarray, n_lists: int, group: int = 32):
    """Padded slot table from assignment labels: (row_ids (n_lists,
    max_sz) int32 with -1 padding, sizes (n_lists,) int32). max_sz is
    rounded up to a multiple of `group` (kIndexGroupSize=32,
    ivf_list_types.hpp:42); members keep their row order."""
    labels = np.asarray(labels, np.int64)
    sizes = np.bincount(labels, minlength=n_lists)
    max_sz = max(int(sizes.max()) if len(labels) else 0, 1)
    max_sz = -(-max_sz // group) * group
    row_ids = np.full((n_lists, max_sz), -1, np.int32)
    order = np.argsort(labels, kind="stable")
    starts = np.zeros(n_lists + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    rank = np.arange(len(labels)) - starts[labels[order]]
    row_ids[labels[order], rank] = order
    return row_ids, sizes.astype(np.int32)


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
