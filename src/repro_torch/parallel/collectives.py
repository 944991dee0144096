"""Sums and gathers over mesh axes, on the blocks each mesh position holds.

A mesh position's value is one tensor on that position's device; a
collective takes the list of every position's value, in position order
(row-major over the mesh grid, as ``sharding.Sharded.blocks``), and
returns the list of results.  The positions that differ only along
``axes`` form a group; each collective combines the values of a group and
hands every member the result on its own device:

* ``all_reduce_sum`` -- the sum over the group, added in one fixed order
  (the group's positions by their coordinates along ``axes``, the first
  axis major), so a run is repeatable bit for bit;
* ``all_reduce_max`` -- the elementwise maximum;
* ``all_gather``     -- the values concatenated along ``dim`` in that
  order, the inverse of ``sharding.shard``'s split of a dim over ``axes``.

This is the one-process backend: the mesh's positions run in turn in the
calling thread, a group's result is formed on the device of its first
position, and blocks on other devices move with ``.to(device)``.  Members
that share a device share the result tensor, so callers treat results as
read-only.  A process-per-card backend would take the same arguments with
the list holding the calling process's own positions.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch


def coords(mesh, position: int) -> Dict[str, int]:
    """Position ``position``'s coordinate along each axis of ``mesh``."""
    out, i = {}, position
    for name, size in reversed(list(zip(mesh.axis_names,
                                        mesh.devices.shape))):
        out[name] = i % size
        i //= size
    return {name: out[name] for name in mesh.axis_names}


def axis_index(mesh, position: int, axes: Sequence[str]) -> int:
    """The flat index of ``position`` along ``axes`` (the first axis
    major), the block of a dim split over ``axes`` that it holds."""
    c, k = coords(mesh, position), 0
    for a in axes:
        k = k * mesh.shape[a] + c[a]
    return k


def axis_size(mesh, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def groups(mesh, axes: Sequence[str]) -> List[List[int]]:
    """The positions of ``mesh`` grouped by their coordinates outside
    ``axes``, each group ordered along ``axes``."""
    axes = tuple(axes)
    out: Dict[Tuple, List[int]] = {}
    for p in range(mesh.size):
        c = coords(mesh, p)
        out.setdefault(tuple(c[a] for a in mesh.axis_names
                             if a not in axes), []).append(p)
    return [sorted(g, key=lambda p: axis_index(mesh, p, axes))
            for g in out.values()]


def _combine(xs: Sequence[torch.Tensor], mesh, axes,
             fold: Callable[[List[torch.Tensor], torch.device],
                            torch.Tensor]) -> List[torch.Tensor]:
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} values for a mesh of {mesh.size} "
                         f"positions")
    devices = mesh.device_list
    out: List[torch.Tensor] = [None] * mesh.size
    for g in groups(mesh, axes):
        if len(g) == 1:
            out[g[0]] = xs[g[0]]
            continue
        home = devices[g[0]]
        res = fold([xs[p].to(home) for p in g], home)
        for p in g:
            out[p] = res.to(devices[p])
    return out


def _sum(parts, _home):
    acc = parts[0]
    for t in parts[1:]:
        acc = acc + t
    return acc


def _max(parts, _home):
    acc = parts[0]
    for t in parts[1:]:
        acc = torch.maximum(acc, t)
    return acc


def all_reduce_sum(xs: Sequence[torch.Tensor], mesh,
                   axes: Sequence[str]) -> List[torch.Tensor]:
    """Every position's value summed over its group along ``axes``."""
    return _combine(xs, mesh, axes, _sum)


def all_reduce_max(xs: Sequence[torch.Tensor], mesh,
                   axes: Sequence[str]) -> List[torch.Tensor]:
    """The elementwise maximum over each group along ``axes``."""
    return _combine(xs, mesh, axes, _max)


def all_gather(xs: Sequence[torch.Tensor], mesh, axes: Sequence[str],
               dim: int) -> List[torch.Tensor]:
    """Each group's values concatenated along ``dim`` in their order along
    ``axes``."""
    return _combine(xs, mesh, axes, lambda parts, _: torch.cat(parts, dim))


__all__ = ["coords", "axis_index", "axis_size", "groups", "all_reduce_sum",
           "all_reduce_max", "all_gather"]
