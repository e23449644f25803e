"""Candidate refinement: exact re-ranking of ANN results (counterpart of
raft_tpu/neighbors/refine.py).

Given candidate ids from a lossy index (IVF-PQ), recompute exact
distances against the original dataset and keep the best k.

  "two_phase"  gather the candidate rows, one batched full-float32 dot
               per query block, select (`_refine_impl`);
  "fused"      hand each query's gathered candidate block to the
               `fused_list_topk` kernel as one "list" (chunk = 1), so the
               (nq, n_cand) scores never reach device memory; exact over
               the bf16-rounded rows (`_fused_rerank_gathered`).

The default (None / "auto") resolves as the JAX package's does
(`_resolve_refine_strategy`): two-phase, unless the tuned
`select_k_strategy` governs the queries' device (`core.tuned.applies`:
CUDA only) and names "fused", and the candidate block fits the kernel.

`refine_host` serves the dataset that stays in host memory (a numpy
array or memmap, 10M+ rows): only the (nq, n_cand, dim) candidate rows
are gathered on the host and sent to the device, then re-ranked as
above.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.config import auto_convert_output, strict_f32_matmul
from raft_tpu_torch.core.resources import accepts_resources
from raft_tpu_torch.core.validation import as_tensor, check_matrix
from raft_tpu_torch.distance.distance_types import DistanceType, resolve_metric
from raft_tpu_torch.matrix.select_k import _select_k_impl

_LANES = 128


def _refine_impl(dataset, queries, candidates, k: int, metric: DistanceType,
                 gathered: bool = False):
    """The two-phase re-rank by query blocks. `gathered`: `dataset` is
    the candidate rows already gathered (nq, nc, dim), aligned with
    `candidates`."""
    nq, nc = candidates.shape
    select_min = metric != DistanceType.InnerProduct
    worst = float("inf") if select_min else float("-inf")
    strict_f32_matmul()
    qb = min(max(1, (1 << 22) // max(1, nc * dataset.shape[-1])), max(1, nq))
    vals, ids = [], []
    for s in range(0, nq, qb):
        qs = queries[s:s + qb].float()
        cand = candidates[s:s + qb]
        if gathered:
            cdata = dataset[s:s + qb].float()
        else:
            cdata = dataset[torch.clamp(cand, min=0).long()].float()  # (qb, nc, dim)
        dots = torch.bmm(cdata, qs[:, :, None])[:, :, 0]
        if metric == DistanceType.InnerProduct:
            score = dots
        else:
            qn = torch.sum(qs * qs, dim=1)[:, None]
            cn = torch.sum(cdata * cdata, dim=2)
            score = torch.clamp(qn + cn - 2.0 * dots, min=0.0)
        score = torch.where(cand >= 0, score, worst)
        v, pos = _select_k_impl(score, k, select_min)
        vals.append(v)
        ids.append(torch.gather(cand, 1, pos))
    v, i = torch.cat(vals), torch.cat(ids)
    if metric == DistanceType.L2SqrtExpanded:
        v = torch.sqrt(v)
    return v, i


def _fused_rerank_gathered(cdata, queries, candidates, k: int, metric: DistanceType):
    """Fused rerank over gathered candidate rows cdata (nq, nc, dim),
    aligned with candidates (nq, nc). |v|^2 and |q|^2 come from the SAME
    bf16-rounded rows the kernel multiplies: mixing unrounded norms with
    bf16 dots cancels wrongly on data with a large common offset."""
    from raft_tpu_torch.ops.fused_scan import fused_list_topk

    ip = metric == DistanceType.InnerProduct
    nq, nc = candidates.shape
    ncp = -(-nc // _LANES) * _LANES
    cb = cdata.to(torch.bfloat16)
    if ncp > nc:
        cb = torch.nn.functional.pad(cb, (0, 0, 0, ncp - nc))
        candidates = torch.nn.functional.pad(candidates, (0, ncp - nc), value=-1)
    cb = cb.contiguous()
    cf = cb.float()
    valid = candidates >= 0
    if ip:
        base = torch.where(valid, 0.0, float("inf"))[:, None, :]
    else:
        base = torch.where(valid, torch.sum(cf * cf, dim=2), float("inf"))[:, None, :]
    qf = queries.float().contiguous()
    lof = torch.arange(nq, dtype=torch.int32, device=qf.device)
    vals, slots = fused_list_topk(lof, qf[:, None, :], cb, base.contiguous(), k,
                                  inner_product=ip)  # (nq, 1, kbuf) best-first
    vals = vals[:, 0, :k]
    slots = slots[:, 0, :k]
    invalid = ~torch.isfinite(vals)
    slots = torch.where(invalid, 0, slots).long()  # sentinel -> safe gather
    ids = torch.where(invalid, -1, torch.gather(candidates, 1, slots))
    if ip:
        return torch.where(invalid, float("-inf"), -vals), ids
    qb = qf.to(torch.bfloat16).float()
    v = torch.clamp(vals + torch.sum(qb * qb, dim=1, keepdim=True), min=0.0)
    if metric == DistanceType.L2SqrtExpanded:
        v = torch.sqrt(v)
    return v, ids


def _refine_fused_impl(dataset, queries, candidates, k: int, metric: DistanceType):
    cdata = dataset[torch.clamp(candidates, min=0).long()]
    return _fused_rerank_gathered(cdata, queries, candidates, k, metric)


def _resolve_refine_strategy(strategy, metric: DistanceType, nc: int, dim: int, k: int,
                             device=None) -> str:
    """Refine's select dispatch, the JAX package's: an explicit strategy
    wins ("fused" raises outside the fused list kernel's metrics or
    envelope); None/"auto" is `select_k.resolve_scan_strategy`'s (the
    tuned `select_k_strategy` where it governs `device`, see
    `core.tuned.applies`), gated on the candidate block fitting the list
    kernel: one lane-padded "list" a query (`fits_fused_list`)."""
    from raft_tpu_torch.matrix.select_k import _fused_metric_kind, resolve_scan_strategy
    from raft_tpu_torch.ops.fused_scan import fits_fused_list

    ncp = -(-nc // _LANES) * _LANES
    fits = 0 < k <= ncp and fits_fused_list(ncp, dim, k)
    if strategy == "fused":
        if _fused_metric_kind(metric) is None:
            raise ValueError(f"strategy='fused' supports L2/inner_product metrics, got {metric}")
        if not fits:
            raise ValueError(
                f"strategy='fused': candidate block ({ncp} x dim {dim}, k={k}) "
                "exceeds the fused kernel's shared-memory budget; use strategy='two_phase'"
            )
        return "fused"
    return resolve_scan_strategy(nc, dim, k, strategy,
                                 fused_ok=_fused_metric_kind(metric) is not None and fits,
                                 device=device)


def _charge_refine_cost(nq: int, nc: int, dim: int, k: int, fused: bool) -> None:
    if obs.enabled():
        obs.span_cost(**obs.perf.cost_for(
            "neighbors.refine", nq=nq, n_cand=nc, dim=dim, k=k,
            dtype="bf16" if fused else "f32", fused=fused))


@obs.spanned("neighbors.refine")
@auto_convert_output
@accepts_resources
def refine(dataset, queries, candidates, k: int, metric="sqeuclidean", resources=None,
           strategy: Optional[str] = None, device=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank `candidates` (nq, n_cand) with exact distances; return the
    best (distances, int32 ids), each (nq, k). Ids of -1 are skipped.
    `strategy`: "two_phase" (full float32), "fused" (the fused kernel,
    exact over bf16-rounded rows; L2/inner product, k <= 256), or
    None/"auto": `_resolve_refine_strategy` (two-phase on the CPU; on the
    card the tuned `select_k_strategy` may promote "fused")."""
    q = check_matrix(queries, device=device, name="queries")
    ds = check_matrix(dataset, device=q.device, name="dataset")
    cand = as_tensor(candidates, q.device).to(torch.int32)
    if cand.ndim != 2 or cand.shape[0] != q.shape[0]:
        raise ValueError("candidates must be (n_queries, n_candidates)")
    m = resolve_metric(metric)
    nc = int(cand.shape[1])
    if k > nc:
        raise ValueError(f"k={k} > n_candidates={nc}")
    fused = _resolve_refine_strategy(strategy, m, nc, int(ds.shape[1]), int(k),
                                     q.device) == "fused"
    _charge_refine_cost(int(q.shape[0]), nc, int(ds.shape[1]), int(k), fused)
    if fused:
        return _refine_fused_impl(ds, q, cand, int(k), m)
    return _refine_impl(ds, q, cand, int(k), m)


@obs.spanned("neighbors.refine")
@auto_convert_output
@accepts_resources
def refine_host(dataset, queries, candidates, k: int, metric="sqeuclidean", resources=None,
                strategy: Optional[str] = None, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`refine` over a dataset held in host memory (a numpy array or
    memmap): the full table never reaches the device. Only the candidate
    rows are gathered on the host (ids of -1 clipped into range, then
    masked by id) and sent to `resolve_device(device)` as one (nq,
    n_cand, dim) f32 block, which the chosen `strategy` re-ranks as
    `refine` does. Returns the best (distances, int32 ids), each (nq, k),
    on that device."""
    q = check_matrix(queries, device=device, name="queries")
    cand = candidates.cpu().numpy() if isinstance(candidates, torch.Tensor) else candidates
    cand = np.asarray(cand)
    if cand.ndim != 2 or cand.shape[0] != q.shape[0]:
        raise ValueError("candidates must be (n_queries, n_candidates)")
    m = resolve_metric(metric)
    host = np.asarray(dataset)
    if host.ndim != 2 or host.shape[1] != q.shape[1]:
        raise ValueError(f"dataset must be (n, {q.shape[1]}), got {host.shape}")
    nc = int(cand.shape[1])
    if k > nc:
        raise ValueError(f"k={k} > n_candidates={nc}")
    fused = _resolve_refine_strategy(strategy, m, nc, int(host.shape[1]), int(k),
                                     q.device) == "fused"
    _charge_refine_cost(int(q.shape[0]), nc, int(host.shape[1]), int(k), fused)
    cdata = torch.from_numpy(np.ascontiguousarray(
        host[np.clip(cand, 0, host.shape[0] - 1)], dtype=np.float32)).to(q.device)
    cand_t = torch.from_numpy(cand.astype(np.int32)).to(q.device)
    if fused:
        return _fused_rerank_gathered(cdata, q, cand_t, int(k), m)
    return _refine_impl(cdata, q, cand_t, int(k), m, gathered=True)
