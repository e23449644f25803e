"""Common ANN parameter types (counterpart of raft_tpu/neighbors/ann_types.py;
neighbors/ann_types.hpp:29-49): typed dataclasses, not a runtime flag
system."""

from __future__ import annotations

import dataclasses

from raft_tpu_torch.distance.distance_types import DistanceType, resolve_metric


@dataclasses.dataclass
class IndexParamsBase:
    metric: DistanceType = DistanceType.L2Expanded
    metric_arg: float = 2.0
    add_data_on_build: bool = True

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)


@dataclasses.dataclass
class SearchParamsBase:
    pass
