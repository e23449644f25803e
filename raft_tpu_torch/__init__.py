"""raft_tpu_torch: the PyTorch/CUDA port of raft_tpu for NVIDIA Hopper.

Mirrors raft_tpu module for module (`raft_tpu_torch/neighbors/ivf_pq.py`
<-> `raft_tpu/neighbors/ivf_pq.py`). Entry points take an explicit
`device` and run on the CUDA card unless the caller passes
`device="cpu"`; without a card a default request raises
(`resolve_device`). The kernels the JAX package wrote in Pallas are
hand-written CUDA C++ for `sm_90a` under `raft_tpu_torch/csrc/`, built at
first use.

The top level follows the JAX package's: `__version__`, `Resources`,
`device_ndarray`, the degraded-search types of the distributed layer
(`DegradedSearchResult`, `RankHealth`), the IVF-RaBitQ entry points and
the subpackages, which resolve lazily (PEP 562) so `import raft_tpu_torch`
stays light. The serving and jobs layers (`serve`, `jobs`) are still to
come.
"""

__version__ = "0.1.0"

from raft_tpu_torch.core.config import resolve_device  # noqa: E402
from raft_tpu_torch.core.resources import Resources  # noqa: E402
from raft_tpu_torch.core.device_ndarray import device_ndarray  # noqa: E402

_SUBPACKAGES = (
    "cluster",
    "comms",
    "core",
    "distance",
    "integrity",
    "io",
    "label",
    "linalg",
    "matrix",
    "native",
    "neighbors",
    "obs",
    "ops",
    "random",
    "solver",
    "sparse",
    "spatial",
    "spectral",
    "stats",
    "util",
)

# (module, attribute) of the renamed lazy aliases
_LAZY_ATTRS = {
    "DegradedSearchResult": ("raft_tpu_torch.comms.resilience", "DegradedSearchResult"),
    "RankHealth": ("raft_tpu_torch.comms.resilience", "RankHealth"),
    "ivf_rabitq_build": ("raft_tpu_torch.neighbors.ivf_rabitq", "build"),
    "ivf_rabitq_search": ("raft_tpu_torch.neighbors.ivf_rabitq", "search"),
}

__all__ = [
    "Resources",
    "device_ndarray",
    "__version__",
    *_LAZY_ATTRS,
    *_SUBPACKAGES,
]


def __getattr__(name):
    import importlib

    if name in _SUBPACKAGES:
        return importlib.import_module(f"raft_tpu_torch.{name}")
    if name in _LAZY_ATTRS:
        mod, attr = _LAZY_ATTRS[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list(__all__)))
