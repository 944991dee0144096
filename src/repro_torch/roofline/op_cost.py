"""Flops, bytes and kernel calls of a step traced on the meta device, the
reference's ``roofline/hlo_cost.py`` for eager PyTorch.

XLA hands the reference one optimised program to walk; eager PyTorch runs a
step op by op.  So the port watches the aten ops that a step dispatches (a
``TorchDispatchMode``) while the step runs on meta tensors: shapes and
dtypes only, no memory and no card.  ``hlo_cost``'s costing rules, applied
to those ops:

* flops: a product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, a
  convolution) is 2 x the result's elements x the contracted size
  (``torch.utils.flop_counter``'s formulas); an elementwise op, a type
  conversion or a softmax counts its result's elements, a reduction its
  input's;
* bytes: each op reads its operands and writes its result (a broadcast
  dim, stride 0, is read once); a view, an allocation or a metadata op
  moves nothing.  An in-place write into a slice (``copy_`` into a view,
  ``index_put_``, ``scatter_``, ``index_copy_``) counts the slice, not the
  buffer: the dynamic-update-slice rule, which decides a KV-cache decode
  step;
* a hand-written kernel is one op, as a fusion is in ``hlo_cost``: its
  router's meta branch reports its flops and bytes from its own cost
  function (``roofline.kernel_cost``), and the calls are counted a kernel;
* the backward of ``torch.utils.checkpoint`` runs its recomputation as
  ops, so it is counted, as XLA's remat is;
* collectives: the reference's five kinds, each 0.  A step over a mesh of
  meta positions (``models.tp``) reports every position's kernel calls;
  the bytes its sums and gathers move between positions are not counted
  yet (ROADMAP Queue 1 item 6).

These are eager bytes: what a fused program would keep in registers or
shared memory between ops is counted here as written and read again.
``peak_temp_bytes`` is the peak of the bytes held by storages that the
step created (its outputs among them), freed as their last tensor goes.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline import kernel_cost

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

aten = torch.ops.aten
# ops that move no bytes and do no work: views (also caught by
# ``is_view``), allocations and metadata
_FREE = {aten._unsafe_view, aten.empty, aten.empty_like, aten.empty_strided,
         aten.new_empty, aten.new_empty_strided, aten.lift_fresh,
         aten.resize_, aten.set_, aten.detach, aten.alias, aten.sym_size,
         aten.sym_stride, aten.sym_numel, aten.sym_storage_offset, aten.dim,
         aten.is_same_size}
# in-place writes of an update into part of a buffer: bytes of the update
_SLICE_WRITES = {aten.index_put_, aten._index_put_impl_, aten.index_copy_,
                 aten.index_add_, aten.scatter_, aten.scatter_add_,
                 aten.scatter_reduce_, aten.index_fill_}
# in-place ops that overwrite their destination without reading it
_OVERWRITES = {aten.copy_, aten.fill_, aten.zero_}
# not tagged pointwise, but elementwise work in the HLO sense
_ELEMENTWISE = {aten._softmax, aten._log_softmax,
                aten._softmax_backward_data, aten._log_softmax_backward_data,
                aten.softmax, aten.log_softmax}
_POINTWISE = getattr(torch.Tag, "pointwise", None)
_REDUCTION = getattr(torch.Tag, "reduction", None)


@dataclass
class Cost:
    """A step's totals.  ``flops`` and ``bytes`` include the kernels';
    ``dot_flops`` are the products' alone, ``kernel_flops`` and
    ``kernel_bytes`` the kernels' alone."""
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    dot_flops: float = 0.0
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    ops: int = 0
    peak_temp_bytes: int = 0
    output_bytes: int = 0


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a (strided) tensor addresses: a
    broadcast dim (stride 0) counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a (nested dict / tuple / list) tree."""
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _update_elems(packet, args) -> int:
    """Elements an in-place slice write updates."""
    self = args[0]
    if packet in (aten.index_put_, aten._index_put_impl_):
        idx = [i for i in args[1] if i is not None]
        lead = math.prod(torch.broadcast_shapes(*(i.shape for i in idx)))
        rest = math.prod(self.shape[len(args[1]):])
        gaps = math.prod(s for s, i in zip(self.shape, args[1]) if i is None)
        return lead * rest * gaps
    if packet in (aten.scatter_, aten.scatter_add_, aten.scatter_reduce_):
        return args[2].numel()
    if packet in (aten.index_copy_, aten.index_add_):
        return args[3].numel()
    # index_fill_(self, dim, index, value): the index's slices along dim
    dim = args[1] % max(self.dim(), 1)
    return args[2].numel() * self.numel() // max(self.shape[dim], 1)


class CostMode(TorchDispatchMode):
    """Counts the aten ops dispatched inside it, and the kernel calls that
    the routers' meta branches report, into ``self.cost``."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._live = 0
        self._storages: Dict[int, int] = {}

    def __enter__(self):
        kernel_cost.listen(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_cost.unlisten(self._kernel)
        return super().__exit__(*exc)

    # -- kernel calls (from the routers' meta branches) ---------------------
    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        c = self.cost
        c.flops += flops
        c.bytes += nbytes
        c.kernel_flops += flops
        c.kernel_bytes += nbytes
        c.kernel_calls[name] = c.kernel_calls.get(name, 0) + 1

    # -- memory -------------------------------------------------------------
    def _track(self, outs, ins) -> None:
        """Counts the storages an op created; views and in-place results
        share an input's storage and add nothing."""
        known = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in known or key in self._storages:
                continue
            nbytes = st.nbytes()
            self._storages[key] = nbytes
            self._live += nbytes
            self.cost.peak_temp_bytes = max(self.cost.peak_temp_bytes,
                                            self._live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live -= self._storages.pop(key, 0)

    # -- ops ----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self._track(outs, ins)
        packet = func._overloadpacket
        if func.is_view or packet in _FREE:
            return out
        c = self.cost
        c.ops += 1
        c.bytes += self._bytes(func, packet, args, ins, outs)
        c.flops += self._flops(func, packet, args, kwargs, ins, outs, out)
        return out

    @staticmethod
    def _bytes(func, packet, args, ins, outs) -> float:
        if packet in _SLICE_WRITES:
            self_t = args[0]
            reads = sum(tensor_bytes(t) for t in ins if t is not self_t)
            return reads + _update_elems(packet, args) * self_t.element_size()
        if packet in _OVERWRITES:
            self_t = args[0]
            return (sum(tensor_bytes(t) for t in ins if t is not self_t)
                    + tensor_bytes(self_t))
        return (sum(tensor_bytes(t) for t in ins)
                + sum(tensor_bytes(t) for t in outs))

    def _flops(self, func, packet, args, kwargs, ins, outs, out) -> float:
        formula = flop_registry.get(packet)
        if formula is not None:
            f = float(formula(*args, **kwargs, out_val=out))
            self.cost.dot_flops += f
            return f
        tags = func.tags
        if _REDUCTION is not None and _REDUCTION in tags:
            return float(max((t.numel() for t in ins), default=0))
        if (packet in _ELEMENTWISE
                or (_POINTWISE is not None and _POINTWISE in tags)
                or (packet in (aten._to_copy, aten.copy_) and ins and outs
                    and ins[-1].dtype != outs[0].dtype)):
            return float(sum(t.numel() for t in outs))
        return 0.0


def analyse_step(fn: Callable, *args: Any, **kwargs: Any) -> Cost:
    """Runs ``fn(*args, **kwargs)`` under a ``CostMode`` (on meta tensors:
    nothing is computed) and returns its ``Cost``: flops, bytes and
    collective bytes, with the kernel calls by name (``kernel_calls``),
    the peak of the storages it created (``peak_temp_bytes``) and the
    bytes of every tensor it returned (``output_bytes``)."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)
    mode.cost.output_bytes = tree_bytes(out)
    return mode.cost


__all__ = ["COLLECTIVE_KINDS", "Cost", "CostMode", "analyse_step",
           "tensor_bytes", "tree_bytes"]
