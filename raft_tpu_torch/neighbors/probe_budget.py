"""Query-adaptive probe budgets and early-terminating list scans
(counterpart of raft_tpu/neighbors/probe_budget.py).

  budgets      after the coarse top-n_probes select, each query gets a
               probe budget from the normalized gap profile of its sorted
               coarse scores, g_j = (v_j - v_0) / (v_last - v_0 + eps):
               the prefix with g <= tau, clamped to [min_probes,
               n_probes]. tau >= 1 keeps every probe (the fixed-n_probes
               search, bit for bit); tau -> 0 keeps min_probes.
  early term   with per-list radii r_l (the largest member distance to its
               centroid), a probed list whose lower bound max(0, d_l - r_l)
               exceeds a provable upper bound on the query's k-th distance
               is skipped. Sound for L2 metrics (triangle inequality);
               inner product, a prefilter and indexes without radii keep
               budgets only.
  masking      both decisions land in one (nq, n_probes) keep mask over
               the probe list the engine then scans (`search_plan` hands
               it the probes with the mask): query-major engines mask
               the slot gather, list-major engines drop masked pairs
               before the inversion (probe_invert), and the list kernels
               skip the rows and chunks that empty out.
  accounting   with obs enabled, `account` lands the lists the queries
               scanned in the obs registry (`ivf.scanned_lists`,
               `ivf.budget_hist`) and returns their mean for the span's
               cost; disabled, it returns None and reads nothing.

A `recall_target` resolves to tau through the tuned
`adaptive_probe_policy` (core/tuned.py; CUDA only), else
`DEFAULT_POLICY`; `recall_target >= 1.0` resolves to the saturated plan,
which `search_plan` does not compute: the engines run the fixed search.

The budgets pass the `ivf.probe_budget` fault hook (`BUDGET_SITE`,
`_maybe_corrupt_budgets`): a corrupted budget shrinks to `min_probes`.
Not ported yet: `resolve` / `policy_token`, which serve only the
distributed (MNMG) searches and the server.

This module is imported by the three index engines and imports none of
them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import tuned
from raft_tpu_torch.core.config import strict_f32_matmul
from raft_tpu_torch.core.tuned import POLICY_KEY
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.matrix.select_k import _select_k_impl
from raft_tpu_torch.neighbors.quantizer import sqrt_f32

#: the calibration used until a measured one is in the tuned table:
#: generous taus, so that an uncalibrated deployment scans more rather
#: than missing recall (the JAX package's values)
DEFAULT_POLICY = {
    "default_tau": 0.6,
    "targets": [[0.85, 0.35], [0.90, 0.45], [0.95, 0.60], [0.99, 0.80]],
}

_EPS = 1e-12

#: chaos site (core/faults): the per-query budget vector of the plan
BUDGET_SITE = "ivf.probe_budget"


@dataclasses.dataclass(frozen=True)
class AdaptiveResolved:
    """A search's resolved adaptive probing: the profile cutoff `tau`
    (>= 1.0: saturated budgets), the per-query budget floor, and whether
    bound-based early termination may engage (the engine still requires
    radii and an L2 metric)."""

    tau: float
    min_probes: int
    early_term: bool


def resolve_tau(recall_target: Optional[float], device=None) -> float:
    """recall_target -> tau through the policy (the tuned one where the
    table governs `device`, else DEFAULT_POLICY): the smallest banked tau
    whose target covers the request; a request above every banked target,
    or >= 1.0, saturates (1.0). Malformed policy entries are skipped."""
    policy = tuned.get(POLICY_KEY) if tuned.applies(device) else None
    if not (isinstance(policy, dict) and isinstance(policy.get("targets"), list)):
        policy = DEFAULT_POLICY
    if recall_target is None:
        try:
            return float(policy.get("default_tau", DEFAULT_POLICY["default_tau"]))
        except (TypeError, ValueError):
            return float(DEFAULT_POLICY["default_tau"])
    rt = float(recall_target)
    if rt >= 1.0:
        return 1.0
    entries = []
    for entry in policy["targets"]:
        try:
            entries.append((float(entry[0]), float(entry[1])))
        except (TypeError, ValueError, IndexError):
            continue
    best = None
    for target, tau in sorted(entries):
        if target >= rt:
            best = tau
            break
    return 1.0 if best is None else min(max(best, 0.0), 1.0)


def resolve_params(params, n_probes: int, device=None) -> Optional[AdaptiveResolved]:
    """A SearchParams' adaptive fields (`adaptive`, `recall_target`,
    `budget_tau`, `min_probes`, `early_term`) -> `AdaptiveResolved`, or
    None for the fixed-n_probes search. `recall_target` or `budget_tau`
    implies adaptive. A saturated `recall_target` keeps early termination
    off, so recall_target=1.0 is the fixed search bit for bit; an explicit
    `budget_tau` keeps the caller's `early_term`."""
    adaptive = bool(getattr(params, "adaptive", False))
    rt = getattr(params, "recall_target", None)
    bt = getattr(params, "budget_tau", None)
    if not (adaptive or rt is not None or bt is not None):
        return None
    if bt is not None:
        tau = float(bt)
        early = bool(getattr(params, "early_term", True))
    else:
        tau = resolve_tau(rt, device)
        early = bool(getattr(params, "early_term", True)) and tau < 1.0
    mp = int(min(max(1, int(getattr(params, "min_probes", 1))), int(n_probes)))
    return AdaptiveResolved(tau=tau, min_probes=mp, early_term=early)


def resolve(n_probes: int, adaptive: bool = False, recall_target=None, budget_tau=None,
            min_probes: int = 1, early_term: bool = True,
            device=None) -> Optional[AdaptiveResolved]:
    """Keyword spelling of `resolve_params` for callers without a
    SearchParams object (the distributed drivers, the serve adapters)."""
    import types

    return resolve_params(
        types.SimpleNamespace(adaptive=adaptive, recall_target=recall_target,
                              budget_tau=budget_tau, min_probes=min_probes,
                              early_term=early_term),
        n_probes, device)


def policy_token(params, n_probes: int, device=None):
    """A hashable token of how the adaptive fields shape a search: None for
    the fixed search, else ("adaptive", early_term). `tau` and
    `min_probes` are operands of one search program, so they stay out of
    it (the JAX package's serve compile-cache key component)."""
    ap = resolve_params(params, n_probes, device)
    if ap is None:
        return None
    return ("adaptive", bool(ap.early_term))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _coarse_dists(q_eff: torch.Tensor, centers: torch.Tensor, metric: DistanceType,
                  pq_style: bool = False):
    """The coarse scores of every engine (`coarse_select`): clamped
    squared L2 (IVF-Flat), or, with `pq_style`, the unshifted
    |c|^2 - 2 <q, c> (IVF-PQ and IVF-RaBitQ); inner products for IP.
    Returns (scores, the dropped |q|^2 or None, select_min)."""
    from raft_tpu_torch.distance.pairwise import _dot

    d = _dot(q_eff, centers)
    if metric == DistanceType.InnerProduct:
        return d, None, False
    if pq_style:
        qn = torch.sum(q_eff.float() ** 2, dim=1)[:, None]
        return torch.sum(centers * centers, dim=1)[None, :] - 2.0 * d, qn, True
    qn = torch.sum(q_eff.float() ** 2, dim=1)[:, None]
    cn = torch.sum(centers.float() ** 2, dim=1)[None, :]
    return torch.clamp(qn + cn - 2.0 * d, min=0.0), None, True


def assign_budgets(cvals: torch.Tensor, select_min: bool, tau, min_probes) -> torch.Tensor:
    """(nq,) int32 budgets from the gap profile of the sorted coarse scores
    `cvals` (nq, P), best first: the prefix with g <= tau, clamped to
    [min_probes, P]."""
    v0 = cvals[:, :1]
    vl = cvals[:, -1:]
    if select_min:
        g = (cvals - v0) / (vl - v0 + _EPS)
    else:
        g = (v0 - cvals) / (v0 - vl + _EPS)
    t = torch.tensor(float(tau), dtype=torch.float32, device=cvals.device)
    budgets = torch.sum(g <= t, dim=1, dtype=torch.int32)
    return torch.clamp(budgets, int(min_probes), int(cvals.shape[1]))


def _maybe_corrupt_budgets(budgets: torch.Tensor, min_probes) -> torch.Tensor:
    """The `BUDGET_SITE` chaos hook: corrupt_shard NaNs a seeded fraction
    of the (float-viewed) budget vector and the corrupted entries shrink
    to the floor, so recall degrades visibly and the plan never crashes.
    `budgets` itself without an installed plan."""
    from raft_tpu_torch.core.faults import active_for, corrupt_in_trace

    if not active_for(BUDGET_SITE):
        return budgets
    bf = corrupt_in_trace(BUDGET_SITE, budgets.float(), 0)
    return torch.where(torch.isnan(bf), torch.full_like(budgets, int(min_probes)), budgets)


def early_term_keep(cvals: torch.Tensor, pradii: torch.Tensor, psizes: torch.Tensor, k: int,
                    base_keep: torch.Tensor) -> torch.Tensor:
    """The sound bound-based keep mask over the budget-kept probed lists
    (L2 geometry; `cvals` squared distances). A list at distance d with
    radius r holds members in [max(0, d - r), d + r]. Along the kept
    prefix, once the members counted reach k, the running largest upper
    bound U bounds the query's k-th distance, and a list whose lower bound
    exceeds U cannot hold a top-k neighbour. Fewer than k members in the
    kept set: U = +inf, nothing is skipped."""
    d = sqrt_f32(torch.clamp(cvals, min=0.0))
    ub = d + pradii
    lb = torch.clamp(d - pradii, min=0.0)
    sizes_eff = torch.where(base_keep, psizes.to(torch.int32), 0)
    ub_eff = torch.where(base_keep, ub, float("-inf"))
    csize = torch.cumsum(sizes_eff, dim=1)
    run_ub = torch.cummax(ub_eff, dim=1).values
    need = csize >= int(k)
    U = torch.amin(torch.where(need, run_ub, float("inf")), dim=1, keepdim=True)
    return lb <= U


def coarse_select(q_eff: torch.Tensor, centers: torch.Tensor, metric: DistanceType,
                  n_probes: int, pq_style: bool = False):
    """The engines' coarse select: ((nq, n_probes) sorted scores, best
    first, (nq, n_probes) probed lists, the dropped |q|^2 or None,
    select_min). Every engine's probe list comes from here, and so does
    the plan's."""
    cs, qn_shift, select_min = _coarse_dists(q_eff, centers, metric, pq_style=pq_style)
    cvals, probes = _select_k_impl(cs, int(n_probes), select_min)
    return cvals, probes, qn_shift, select_min


def keep_mask(cvals: torch.Tensor, probes: torch.Tensor, qn_shift, select_min: bool, tau,
              min_probes, k: int, radii: Optional[torch.Tensor] = None,
              sizes: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Budgets -> optional bounds over one coarse select (`coarse_select`'s
    result). Returns ((nq, n_probes) bool keep mask, (nq,) int32
    scanned-list counts); `radii` and `sizes` engage the bound pass (the
    caller keeps them for L2 metrics only)."""
    n_probes = int(cvals.shape[1])
    budgets = _maybe_corrupt_budgets(assign_budgets(cvals, select_min, tau, min_probes),
                                     min_probes)
    pos = torch.arange(n_probes, device=cvals.device)[None, :]
    keep = pos < budgets[:, None]
    if radii is not None and sizes is not None:
        # the bounds need the full squared L2: restore the |q|^2 the
        # pq-style ordering drops
        dist2 = torch.clamp(cvals + qn_shift, min=0.0) if qn_shift is not None else cvals
        keep = keep & early_term_keep(dist2, radii[probes], sizes[probes], k, keep)
        # the floor survives the bound pass (position 0 is kept anyway)
        keep = keep | (pos < int(min_probes))
    return keep, torch.sum(keep, dim=1, dtype=torch.int32)


def plan_keep_mask(q_eff: torch.Tensor, centers: torch.Tensor, tau, min_probes,
                   n_probes: int, k: int, metric: DistanceType,
                   radii: Optional[torch.Tensor] = None,
                   sizes: Optional[torch.Tensor] = None,
                   pq_coarse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse select -> budgets -> optional bounds. Returns ((nq, n_probes)
    bool keep mask, (nq,) int32 scanned-list counts). `q_eff` is the
    engine's coarse-space query matrix (rotated for IVF-PQ and RaBitQ,
    with `pq_coarse`); `radii` and `sizes` engage the bound pass (the
    caller keeps them for L2 metrics only)."""
    return keep_mask(*coarse_select(q_eff, centers, metric, n_probes, pq_style=pq_coarse),
                     tau, min_probes, k, radii=radii, sizes=sizes)


def _coarse_space(queries: torch.Tensor, rotation=None) -> torch.Tensor:
    q = queries.float()
    if rotation is not None:
        strict_f32_matmul()
        q = q @ rotation.T
    return q


def probe_plan(queries: torch.Tensor, centers: torch.Tensor, *, n_probes: int, min_probes: int,
               k: int, metric: DistanceType, tau: float, rotation=None, radii=None,
               sizes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (nq, n_probes) keep mask and per-query scanned-list counts of
    one batch, on the queries' device (the JAX package's host entry; the
    engines plan through `search_plan`). A query's budget depends on that
    query only. `radii` engage the bounds for L2 metrics only."""
    use_bounds = (radii is not None and sizes is not None
                  and metric != DistanceType.InnerProduct)
    return plan_keep_mask(_coarse_space(queries, rotation), centers, tau, min_probes,
                          int(n_probes), int(k), metric,
                          radii=radii.float() if use_bounds else None,
                          sizes=sizes if use_bounds else None,
                          pq_coarse=rotation is not None)


def search_plan(ap: Optional[AdaptiveResolved], queries: torch.Tensor, centers: torch.Tensor, *,
                n_probes: int, k: int, metric: DistanceType, rotation=None, radii=None,
                sizes=None) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """An engine search's plan for the resolved `ap` (`radii`: the
    index's, None where the caller turns the bounds off): None for the
    fixed search, else ((nq, n_probes) keep mask, (nq, n_probes) probed
    lists). The engine scans these probes in place of its own coarse
    select, so the coarse pass runs once and the positional mask is over
    the engine's probe list by construction; a mask of the whole batch
    slices into the engines' macro-batches with its probes. No adaptive
    fields, or tau >= 1 without the bounds, is the fixed search: every
    gap-profile value is at most 1, so that plan keeps every probe and
    is skipped, unless a fault plan targets the budgets (`BUDGET_SITE`)."""
    from raft_tpu_torch.core.faults import active_for

    if ap is None:
        return None
    use_bounds = (ap.early_term and radii is not None and sizes is not None
                  and metric != DistanceType.InnerProduct)
    if ap.tau >= 1.0 and not use_bounds and not active_for(BUDGET_SITE):
        return None
    cvals, probes, qn_shift, select_min = coarse_select(
        _coarse_space(queries, rotation), centers, metric, n_probes, pq_style=rotation is not None)
    keep, _ = keep_mask(cvals, probes, qn_shift, select_min, ap.tau, ap.min_probes, int(k),
                        radii=radii.float() if use_bounds else None,
                        sizes=sizes if use_bounds else None)
    return keep, probes


# ---------------------------------------------------------------------------
# list radii
# ---------------------------------------------------------------------------


def list_radii_from_store(list_data: torch.Tensor, slot_rows: torch.Tensor,
                          centers: torch.Tensor) -> torch.Tensor:
    """(n_lists,) f32 largest member distance to its centroid, from a
    padded list-major store (IVF-Flat; empty lists get 0)."""
    d2 = torch.sum((list_data.float() - centers[:, None, :]) ** 2, dim=2)
    d2 = torch.where(slot_rows >= 0, d2, 0.0)
    return sqrt_f32(torch.amax(d2, dim=1))


def list_radii_from_aux(aux: torch.Tensor, slot_rows: torch.Tensor) -> torch.Tensor:
    """(n_lists,) f32 radii of an IVF-RaBitQ index: `aux` stores each
    member's residual norm |r| (its distance to the centroid in rotated
    space), so a radius is a per-list max."""
    return torch.amax(torch.where(slot_rows >= 0, aux[..., 0], 0.0), dim=1)


def updated_radii(old_radii, labels, dists, n_lists: int):
    """Radii after an extend: each list's max of its old radius and the
    new members' distances, on the radii's device. None stays None (an
    index without radii cannot recover them from one batch: budgets only,
    by design)."""
    del n_lists
    if old_radii is None:
        return None
    dev = old_radii.device
    labels = torch.as_tensor(labels, device=dev).long().reshape(-1)
    dists = torch.as_tensor(dists, dtype=torch.float32, device=dev).reshape(-1)
    return old_radii.float().scatter_reduce(0, labels, dists, reduce="amax", include_self=True)


def account(engine: str, scanned: torch.Tensor, nq: int, n_probes: int) -> Optional[float]:
    """Land one batch's scanned-list totals in the obs registry
    (`ivf.scanned_lists`, with the worst case `ivf.scanned_lists_worst_case`
    beside it, the per-query counts in the `ivf.budget_hist` histogram
    and one "probe_budget" event) and return the per-query mean a cost
    model should charge instead of n_probes.

    With obs disabled this is a no-op returning None: the mean's only
    consumer is the span-cost charge, and reading the counts would stall
    the host on the device for nothing."""
    from raft_tpu_torch import obs

    if not obs.enabled():
        return None
    counts = torch.as_tensor(scanned).cpu().numpy()
    total = int(counts.sum())
    mean = float(total) / max(1, int(nq))
    obs.counter("ivf.scanned_lists").inc(total)
    obs.counter("ivf.scanned_lists_worst_case").inc(int(nq) * int(n_probes))
    hist = obs.histogram("ivf.budget_hist")
    vals, reps = np.unique(counts, return_counts=True)
    for v, r in zip(vals, reps):
        hist.observe_n(float(v), int(r))  # one locked update per value
    obs.event("probe_budget", engine=engine, queries=int(nq),
              scanned_lists=total, worst_case=int(nq) * int(n_probes))
    return mean


def account_plan(engine: str, plan, nq: int, n_probes: int) -> Optional[float]:
    """`account` of an adaptive search's `plan` (`search_plan`): each
    query's kept probes, or all n_probes where the plan was skipped
    (None, a saturated plan)."""
    if plan is None:
        scanned = torch.full((int(nq),), int(n_probes), dtype=torch.int64)
    else:
        scanned = plan[0].sum(dim=1)
    return account(engine, scanned, nq, n_probes)
