"""Distance metric enum + name resolution (a copy of
raft_tpu/distance/distance_types.py; the port imports nothing of the JAX
package). Values match raft::distance::DistanceType.
"""

from __future__ import annotations

import enum


class DistanceType(enum.IntEnum):
    # Values match distance_types.hpp:23-67 for interop/debuggability.
    L2Expanded = 0
    L2SqrtExpanded = 1
    CosineExpanded = 2
    L1 = 3
    L2Unexpanded = 4
    L2SqrtUnexpanded = 5
    InnerProduct = 6
    Linf = 7
    Canberra = 8
    LpUnexpanded = 9
    CorrelationExpanded = 10
    JaccardExpanded = 11
    HellingerExpanded = 12
    Haversine = 13
    BrayCurtis = 14
    JensenShannon = 15
    HammingUnexpanded = 16
    KLDivergence = 17
    RusselRaoExpanded = 18
    DiceExpanded = 19
    Precomputed = 100


# pylibraft-compatible metric names (pairwise_distance.pyx DISTANCE_TYPES)
DISTANCE_TYPES = {
    "l2": DistanceType.L2SqrtExpanded,
    "sqeuclidean": DistanceType.L2Expanded,
    "euclidean": DistanceType.L2SqrtExpanded,
    "l1": DistanceType.L1,
    "cityblock": DistanceType.L1,
    "manhattan": DistanceType.L1,
    "taxicab": DistanceType.L1,
    "inner_product": DistanceType.InnerProduct,
    "chebyshev": DistanceType.Linf,
    "linf": DistanceType.Linf,
    "canberra": DistanceType.Canberra,
    "cosine": DistanceType.CosineExpanded,
    "lp": DistanceType.LpUnexpanded,
    "minkowski": DistanceType.LpUnexpanded,
    "correlation": DistanceType.CorrelationExpanded,
    "jaccard": DistanceType.JaccardExpanded,
    "hellinger": DistanceType.HellingerExpanded,
    "haversine": DistanceType.Haversine,
    "braycurtis": DistanceType.BrayCurtis,
    "jensenshannon": DistanceType.JensenShannon,
    "hamming": DistanceType.HammingUnexpanded,
    "kl_divergence": DistanceType.KLDivergence,
    "kldivergence": DistanceType.KLDivergence,
    "russellrao": DistanceType.RusselRaoExpanded,
    "dice": DistanceType.DiceExpanded,
    "sqeuclidean_unexpanded": DistanceType.L2Unexpanded,
    "euclidean_unexpanded": DistanceType.L2SqrtUnexpanded,
}

# Metrics for which smaller is better=closer. InnerProduct is a similarity.
SIMILARITY_METRICS = frozenset({DistanceType.InnerProduct})


def resolve_metric(metric) -> DistanceType:
    """Accept a DistanceType, its int value, or a pylibraft metric string."""
    if isinstance(metric, DistanceType):
        return metric
    if isinstance(metric, int):
        return DistanceType(metric)
    name = str(metric).lower()
    try:
        return DISTANCE_TYPES[name]
    except KeyError:
        raise ValueError(
            f"unsupported metric {metric!r}; supported: {sorted(DISTANCE_TYPES)}"
        ) from None
