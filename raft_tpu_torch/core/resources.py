"""Resources: the light-weight handle (counterpart of
raft_tpu/core/resources.py; `raft::resources` core/resources.hpp:46,
`raft::device_resources` core/device_resources.hpp:60, pylibraft's
`DeviceResources`).

PyTorch owns the streams, the allocator and cuBLAS, so `Resources` keeps
what still has meaning: the target `device` (the card unless told
otherwise), a seeded stream of `torch.Generator`s (`new_key`), a registry
of user resources with lazy factories (`add_resource_factory` /
`get_resource`), the comms object and named sub-comms (stored here;
their users come with the distributed layer), and `sync()`, which waits
for the work queued on the device's current stream (`sync_stream`).
Like the reference's shallow copies, `with_mesh` shares the registry.
"""

from __future__ import annotations

import functools
import inspect
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from raft_tpu_torch.core.config import resolve_device


class ResourceError(RuntimeError):
    """A requested resource (comms, sub-comms) is not set on this handle."""


class Resources:
    """`raft::device_resources` analogue.

    device: where work goes (`core.config.resolve_device`: the card unless
        `device="cpu"`). mesh: kept for the distributed layer. seed: seeds
        the handle's generator stream.
    """

    def __init__(self, device=None, mesh=None, seed: int = 0):
        self._registry: dict = {}
        self._factories: dict = {}
        self._lock = threading.Lock()
        self._device = device
        self._mesh = mesh
        self._seeds = np.random.SeedSequence(int(seed))
        self._events: list = []

    # -- device / mesh ---------------------------------------------------
    @property
    def device(self) -> torch.device:
        if not isinstance(self._device, torch.device):
            self._device = resolve_device(self._device)
        return self._device

    @property
    def mesh(self):
        return self._mesh

    def with_mesh(self, mesh) -> "Resources":
        """Shallow copy sharing the registry, with a different mesh."""
        r = Resources.__new__(Resources)
        r.__dict__.update(self.__dict__)
        r._mesh = mesh
        return r

    # -- RNG -------------------------------------------------------------
    def new_key(self) -> torch.Generator:
        """A fresh generator on the device, seeded from the handle's seed
        stream (each call a new child of the handle's `SeedSequence`)."""
        from raft_tpu_torch.random.rng import make_generator

        with self._lock:
            child = self._seeds.spawn(1)[0]
        seed = int(child.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)
        return make_generator(seed, self.device)

    # -- generic resource registry (resources.hpp parity) ----------------
    def add_resource_factory(self, name: str, factory: Callable[[], Any]) -> None:
        with self._lock:
            self._factories[name] = factory
            self._registry.pop(name, None)

    def get_resource(self, name: str) -> Any:
        with self._lock:
            if name not in self._registry:
                if name not in self._factories:
                    raise KeyError(f"no resource or factory registered for {name!r}")
                self._registry[name] = self._factories[name]()
            return self._registry[name]

    def has_resource(self, name: str) -> bool:
        with self._lock:
            return name in self._registry or name in self._factories

    # -- comms (core/resource/comms.hpp, sub_comms.hpp parity) -----------
    def set_comms(self, comms) -> None:
        with self._lock:
            self._registry["comms"] = comms

    def get_comms(self):
        with self._lock:
            if "comms" not in self._registry:
                raise ResourceError("no comms set on this Resources; call set_comms()")
            return self._registry["comms"]

    def comms_initialized(self) -> bool:
        with self._lock:
            return "comms" in self._registry

    def set_sub_comms(self, key: str, comms) -> None:
        with self._lock:
            self._registry[f"sub_comms/{key}"] = comms

    def get_sub_comms(self, key: str):
        with self._lock:
            try:
                return self._registry[f"sub_comms/{key}"]
            except KeyError:
                raise ResourceError(f"no sub-comms registered under {key!r}") from None

    # -- synchronization (sync_stream parity) ----------------------------
    def track(self, *tensors) -> None:
        """Remember CUDA tensors whose work `sync()` should wait for (an
        event on their device's current stream); CPU tensors are ready."""
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(t.device))
                self._events.append(ev)

    def sync(self) -> None:
        """Block until the tracked work and the work queued on the
        device's current stream are done (`device_resources::sync_stream`)."""
        events, self._events = self._events, []
        for ev in events:
            ev.synchronize()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()


def auto_sync_resources(f: Callable) -> Callable:
    """pylibraft's `@auto_sync_handle` (handle.pyx:209): called without
    `resources=`, the function gets a default `Resources` and its `sync()`
    runs before returning; with an explicit handle, syncing is the
    caller's."""

    @functools.wraps(f)
    def wrapper(*args, resources: Optional[Resources] = None, **kwargs):
        sync = resources is None
        if resources is None:
            resources = Resources()
        out = f(*args, resources=resources, **kwargs)
        if sync:
            resources.sync()
        return out

    return wrapper


def _same_device(a: torch.device, b: torch.device) -> bool:
    """`a` and `b` name one device (a CUDA device without an index is the
    current one)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device
    return (cur() if a.index is None else a.index) == (cur() if b.index is None else b.index)


def _outputs(out) -> tuple:
    """The tensors of an entry point's result: the result itself, the
    items of a tuple or list, or the tensor fields of an index object."""
    if isinstance(out, torch.Tensor):
        return (out,)
    if isinstance(out, (tuple, list)):
        return tuple(t for o in out for t in _outputs(o))
    if hasattr(out, "__dict__"):
        return tuple(v for v in vars(out).values() if isinstance(v, torch.Tensor))
    return ()


def accepts_resources(f: Callable) -> Callable:
    """JAX's `resources=` on an entry point whose signature names it at
    the JAX package's position. Given a handle, the call runs on its
    device where `device=` is not given (a `device=` naming another
    device raises ValueError; an entry point without `device=` runs on
    its index's device), and the result's tensors are `track`ed, so
    `resources.sync()` waits for them. Without one, `f` runs as it is."""
    sig = inspect.signature(f)
    params = list(sig.parameters)
    pos = params.index("resources")
    has_device = "device" in params

    @functools.wraps(f)
    def wrapper(*args, **kwargs):
        res = args[pos] if len(args) > pos else kwargs.get("resources")
        if res is None:
            return f(*args, **kwargs)
        if has_device:
            bound = sig.bind(*args, **kwargs)
            dev = bound.arguments.get("device")
            if dev is not None and not _same_device(resolve_device(dev), res.device):
                raise ValueError(
                    f"device={dev!r} differs from resources.device={res.device}")
            bound.arguments["device"] = res.device
            args, kwargs = bound.args, bound.kwargs
        out = f(*args, **kwargs)
        res.track(*_outputs(out))
        return out

    return wrapper
