"""raft_tpu_torch: the PyTorch/CUDA port of raft_tpu for NVIDIA Hopper.

Mirrors raft_tpu module for module (`raft_tpu_torch/neighbors/ivf_pq.py`
<-> `raft_tpu/neighbors/ivf_pq.py`). Entry points take an explicit
`device` and run on the CUDA card unless the caller passes
`device="cpu"`; without a card a default request raises. The kernels
the JAX package wrote in Pallas are hand-written CUDA C++ for `sm_90a`
under `raft_tpu_torch/csrc/`, built at first use.
"""

from raft_tpu_torch.core.config import resolve_device

__all__ = ["resolve_device"]
