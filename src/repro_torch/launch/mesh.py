"""Device meshes: the reference's builders over lists of ``torch.device``s.

A ``Mesh`` is what the reference's sharding rules read of a jax mesh: the
``axis_names``, the ``shape`` (axis name -> size) and the ``devices`` grid,
here a numpy object array of ``torch.device``s.  Nothing is compiled or
partitioned by it: ``repro_torch.parallel.sharding.shard`` places the
blocks of a tensor on the grid's devices, and the code that serves reads
them from there.

The default pool is the visible CUDA cards; with none, a builder raises.
The CPU is used only when the caller passes CPU devices (the tests pass
``[torch.device("cpu")] * 8`` where the reference forces an 8-device host
platform).  A device may appear more than once in a pool: that is how one
card carries several logical shards.  The carving works on positions in
the pool, never on device identity.

Every builder validates the requested shape against the pool up front and
raises a ``ValueError`` naming both counts.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """A grid of devices with named axes, laid out row-major over a pool."""

    def __init__(self, devices: Sequence, shape: Sequence[int],
                 axis_names: Sequence[str]):
        devices = [torch.device(d) for d in devices]
        if len(devices) != math.prod(shape) or len(shape) != len(axis_names):
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} does not "
                             f"fit {len(devices)} device(s)")
        grid = np.empty(len(devices), dtype=object)
        grid[:] = devices
        self.devices = grid.reshape(tuple(shape))
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def device_list(self) -> List[torch.device]:
        """The pool in position order (row-major over the grid)."""
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_list})"


def visible_devices() -> List[torch.device]:
    """The default pool: every visible CUDA card (empty without one)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _require(needed: int, available: int, what: str) -> None:
    """Fail fast with both counts named."""
    if available < needed:
        raise ValueError(
            f"{what} needs {needed} device(s) but only {available} "
            f"available; pass a pool of {needed} devices (a card may appear "
            f"more than once) or shrink the requested topology")


def _mesh(shape, axes, devices=None) -> Mesh:
    pool = visible_devices() if devices is None else list(devices)
    _require(math.prod(shape), len(pool), f"mesh {dict(zip(axes, shape))}")
    return Mesh(pool[:math.prod(shape)], shape, axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """16x16 = 256 devices; multi_pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, devices)


def make_host_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """Single-device mesh: the first device of the pool."""
    return _mesh((1, 1), ("data", "model"), devices)


def make_serve_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """Data-parallel serving mesh over the pool.

    One embedding tier fans its batches out over every device it was given
    (``('data', 'model')`` axes with the whole device count on ``data``), so
    the serve-mode sharding rules apply unchanged: weights replicated,
    batch split over ``data``.  ``devices=None`` uses every visible card; a
    single device is ``make_host_mesh()``'s layout.
    """
    devices = visible_devices() if devices is None else list(devices)
    if not devices:
        raise ValueError("need at least one device for a serve mesh")
    return _mesh((len(devices), 1), ("data", "model"), devices)


def make_replica_meshes(hosts: int = 1, replicas: int = 1,
                        devices: Optional[Sequence] = None) -> List[Mesh]:
    """Carve a device pool into ``hosts * replicas`` independent serve
    meshes, the hardware side of the multi-replica topology.

    The pool splits into equal contiguous groups, one serve mesh per
    replica, ordered host-major/replica-minor so index ``h * replicas + r``
    is replica ``(h, r)``, the order ``core.routing.replicate`` emits its
    ``TierSpec``s in.  ``1 x 1`` returns ``[make_serve_mesh(devices)]``.  A
    pool that does not split evenly raises a ``ValueError`` naming required
    and available counts.
    """
    if hosts < 1 or replicas < 1:
        raise ValueError(f"hosts and replicas must be >= 1, "
                         f"got {hosts}x{replicas}")
    devices = visible_devices() if devices is None else list(devices)
    groups = hosts * replicas
    if groups == 1:
        return [make_serve_mesh(devices)]
    _require(groups, len(devices),
             f"replica topology {hosts} host(s) x {replicas} replica(s)")
    if len(devices) % groups:
        raise ValueError(
            f"device pool of {len(devices)} does not split evenly over "
            f"{hosts} host(s) x {replicas} replica(s) = {groups} groups; "
            f"each replica needs an equal device group")
    per = len(devices) // groups
    return [make_serve_mesh(devices[g * per:(g + 1) * per])
            for g in range(groups)]


def mesh_context(mesh: Mesh):
    """The reference's context for bare-spec sharding constraints.  The port
    places tensors explicitly (``sharding.shard``) and its layout hints are
    the identity (``sharding.hidden_constraint``), so there is nothing to
    install: the context only yields the mesh."""
    return contextlib.nullcontext(mesh)
