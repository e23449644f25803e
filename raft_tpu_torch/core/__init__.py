"""Core runtime (counterpart of raft_tpu/core): the JAX package's
`__all__`, in its order, less `enable_compilation_cache` (XLA's cache;
the port's kernels cache in `_build/`)."""

from raft_tpu_torch.core.resources import Resources, auto_sync_resources
from raft_tpu_torch.core.device_ndarray import device_ndarray
from raft_tpu_torch.core.validation import check_array, check_matrix, check_vector, cai_wrapper
from raft_tpu_torch.core.logger import logger, set_level
from raft_tpu_torch.core.tracing import trace_range
from raft_tpu_torch.core.serialize import serialize_arrays, deserialize_arrays
from raft_tpu_torch.core.interruptible import (
    synchronize,
    cancel,
    InterruptedException,
    TimeoutException,
)
from raft_tpu_torch.core import faults
from raft_tpu_torch.core.config import (
    set_output_as,
    get_output_as,
    convert_output,
    auto_convert_output,
)
from raft_tpu_torch.core import operators
from raft_tpu_torch.core.operators import KeyValuePair
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.mdarray import (
    make_device_matrix,
    make_device_vector,
    make_device_scalar,
    make_host_matrix,
    make_host_vector,
    make_device_matrix_view,
    make_device_vector_view,
)

__all__ = [
    "operators",
    "KeyValuePair",
    "Bitset",
    "make_device_matrix",
    "make_device_vector",
    "make_device_scalar",
    "make_host_matrix",
    "make_host_vector",
    "make_device_matrix_view",
    "make_device_vector_view",
    "set_output_as",
    "get_output_as",
    "convert_output",
    "auto_convert_output",
    "Resources",
    "auto_sync_resources",
    "device_ndarray",
    "check_array",
    "check_matrix",
    "check_vector",
    "cai_wrapper",
    "logger",
    "set_level",
    "trace_range",
    "serialize_arrays",
    "deserialize_arrays",
    "synchronize",
    "cancel",
    "InterruptedException",
    "TimeoutException",
    "faults",
]
