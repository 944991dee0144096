"""Partition specs for params, batches and caches, and the port's
placement of a tensor's blocks on a mesh.

The rules are the reference's (``parallel/sharding.py``), copied:

* ``model`` axis -- tensor/expert parallelism: d_ff-like dims, vocab of
  the embedding table, expert dim of MoE weights, d_inner of mamba.
* ``data`` axis -- FSDP in training: the d_model-like dim of every weight;
  the batch dim of activations also runs over ``data`` (plus ``pod``).
  Serving (``mode="serve"``) keeps weights resident: no ``data`` entries.
* ``pod`` axis -- data parallelism across pods (batch only).
* decode KV caches shard their *sequence* dim over ``model``; a batch too
  small for the data axes (``long_500k``, batch 1) shards the sequence over
  ``('data', 'model')`` jointly.

A spec is a plain tuple with one entry per leading dim: None (the dim is
whole on every device), an axis name, or a tuple of axis names (the dim is
split over their product, the first axis major).  A sharding is a ``(mesh,
spec)`` pair.  There is no compiler to partition a program by them:
``shard`` cuts a tensor into the block each mesh position holds and places
each block on that position's device, ``unshard`` puts the blocks back
together, and the code that serves runs on the blocks (``models.tp``, each
mesh position in turn, its sums and gathers those of
``parallel.collectives``).  A mamba ``in_proj`` (D, 2 * d_inner) holds the
x and z halves side by side; ``shard_tree`` splits each half's channels
under the spec's last entry (``HALVED``), so a position holds its channel
range of both halves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.parallel import collectives as C

STACK_KEYS = ("blocks", "enc_blocks", "dec_blocks")
# leaves whose last dim is two halves split alike: [x | z] of mamba's in_proj
HALVED = ("in_proj",)
Spec = Tuple


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes the batch dim is sharded over."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


# ---------------------------------------------------------------------------
# param rules
# ---------------------------------------------------------------------------

_RULES: Dict[str, Tuple] = {
    # name -> spec for the *unstacked* shape
    "embed": ("model", "data"),
    "lm_head": ("data", "model"),
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    "router": ("data", None),
    "in_proj": ("data", "model"),
    "x_proj": ("model", None),
    "dt_proj": (None, "model"),
    "dt_bias": ("model",),
    "A_log": ("model", None),
    "D": ("model",),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "scale": (None,),
    "bias": (None,),
}

_MOE_RULES: Dict[str, Tuple] = {
    # 3-D expert-stacked weights: experts over `model` (expert parallelism)
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
}

_MLP_RULES: Dict[str, Tuple] = {
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    "w_in": ("data", "model"),
    "w_out": ("model", "data"),
}


# fallback when the expert count does not divide the model axis (e.g.
# granite's 40 experts on a 16-way axis): shard the FFN dims instead.
_MOE_FALLBACK: Dict[str, Tuple] = {
    "w_gate": (None, "data", "model"),
    "w_up": (None, "data", "model"),
    "w_down": (None, "model", "data"),
}


def _path_names(path) -> Tuple[str, ...]:
    return tuple(p for p in path if isinstance(p, str))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh, entry) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return math.prod(sizes[a] for a in _axes(entry))


def _fit(mesh, shape, rule) -> Tuple:
    """Drop spec entries whose mesh-axis size does not divide the dim: a
    block is an exact share of its dim."""
    return tuple(
        (a if d % _axis_size(mesh, a) == 0 else None)
        for d, a in zip(shape, rule))


def param_spec(path, leaf, mesh, mode: str = "train") -> Spec:
    names = _path_names(path)
    name = names[-1]
    stacked = any(n in STACK_KEYS for n in names)
    eff_ndim = leaf.ndim - (1 if stacked else 0)
    moe = name in _MOE_RULES and eff_ndim == 3
    if moe:
        rule = _MOE_RULES[name]
    elif name in _MLP_RULES:
        rule = _MLP_RULES[name]
    elif name in _RULES:
        rule = _RULES[name]
    else:
        rule = (None,) * eff_ndim
    rule = tuple(rule)[:eff_ndim]
    rule = rule + (None,) * (eff_ndim - len(rule))
    if mode == "serve":
        # serving keeps weights RESIDENT: tensor/expert parallelism only
        # (FSDP's per-layer weight gathers amortise over training batches,
        # not over a decode step)
        rule = tuple(None if a == "data" else a for a in rule)
    if stacked:
        rule = (None,) + rule
    rule = _fit(mesh, leaf.shape, rule)
    if moe and rule[1 if stacked else 0] is None:
        # expert axis didn't divide: shard the FFN dims instead
        alt = _MOE_FALLBACK[name]
        if mode == "serve":
            alt = tuple(None if a == "data" else a for a in alt)
        alt = ((None,) + alt) if stacked else alt
        rule = _fit(mesh, leaf.shape, alt)
    return rule


def tree_map_with_path(fn: Callable, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a nested dict, path = the tuple of keys."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(mesh, params_shape, mode: str = "train") -> Any:
    """Tree of specs matching a param tree (tensors or meta tensors)."""
    return tree_map_with_path(
        lambda p, l: param_spec(p, l, mesh, mode), params_shape)


def param_shardings(mesh, params_shape, mode: str = "train") -> Any:
    return tree_map_with_path(lambda _, s: (mesh, s),
                              param_pspecs(mesh, params_shape, mode))


def serve_embed_shardings(mesh, params_shape) -> Tuple[Any, Tuple]:
    """(param shardings, batch sharding) for the data-parallel embed path.

    Serve-mode param rules (weights resident: no ``data``-axis specs) and
    the (B, S) token/mask batch split over the data axes.  The same pair
    shards the (B, D) output, whose trailing dim is always whole.
    """
    dp = dp_axes(mesh)
    b = dp if len(dp) > 1 else (dp[0] if dp else None)
    return param_shardings(mesh, params_shape, mode="serve"), (mesh, (b, None))


# ---------------------------------------------------------------------------
# activation / batch / cache rules
# ---------------------------------------------------------------------------

def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Spec]:
    """Specs for the input batch dict of a step."""
    dp = dp_axes(mesh)
    dps = dp if len(dp) > 1 else (dp[0] if dp else None)
    big_batch = shape.global_batch >= _dp_size(mesh)
    b = dps if big_batch else None
    specs: Dict[str, Spec] = {}
    if shape.kind == "train":
        specs["tokens"] = (b, None)
        specs["labels"] = (b, None)
    elif shape.kind == "prefill":
        specs["tokens"] = (b, None)
    else:  # decode
        specs["token"] = (b,)
    if shape.kind != "decode":
        if cfg.frontend == "vision":
            specs["patches"] = (b, None, None)
        if cfg.frontend == "audio":
            specs["frames"] = (b, None, None)
    return specs


def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 cache_shape) -> Any:
    """Specs for the decode cache tree (tensors or meta tensors; ``pos`` is
    a Python int and gets the empty spec)."""
    dp = dp_axes(mesh)
    dps = dp if len(dp) > 1 else (dp[0] if dp else None)
    big_batch = shape.global_batch >= _dp_size(mesh)
    b = dps if big_batch else None
    # batch=1 long-context: shard the cache sequence over every axis we have
    seq_axes = ("model",) if big_batch else tuple(dp) + ("model",)
    seq = seq_axes if len(seq_axes) > 1 else seq_axes[0]

    def spec(path, leaf):
        name = _path_names(path)[-1]
        if name in ("k", "v"):            # (L, B, S, KV, hd)
            rule = (None, b, seq, None, None)
        elif name in ("cross_k", "cross_v"):  # (L, B, F, KV, hd)
            rule = (None, b, None, None, None)
        elif name == "kpos":              # (S,)
            rule = (seq,)
        elif name == "ssm":               # (L, B, DI, N)
            rule = (None, b, "model", None)
        elif name == "conv":              # (L, B, CK-1, DI)
            rule = (None, b, None, "model")
        else:
            return ()                     # pos
        return _fit(mesh, leaf.shape, rule)

    return tree_map_with_path(spec, cache_shape)


def hidden_constraint(mesh, batch_sharded: bool):
    """The reference's layout hint for the residual stream between layers
    (batch over the data axes, D whole), which GSPMD reads to place
    intermediates.  The port runs each layer where its inputs lie and
    places what it shards with ``shard``, so the hint is the identity, as
    ``layers._moe_constrain`` is left out."""
    return lambda h: h


def logits_pspec(mesh, batch_sharded: bool) -> Spec:
    dp = dp_axes(mesh)
    dps = dp if len(dp) > 1 else (dp[0] if dp else None)
    b = dps if batch_sharded else None
    return (b, None, "model")


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@dataclass
class Sharded:
    """A tensor of ``shape`` laid out on ``mesh`` under ``spec``: position
    i of the mesh (row-major over its grid) holds ``blocks[i]``, the slice
    ``index[i]`` of the whole, on ``mesh.device_list[i]``.  Positions that
    hold the same slice on the same device share one block (one card that
    carries several logical positions holds a replicated weight once)."""
    mesh: Any
    spec: Spec
    shape: Tuple[int, ...]
    blocks: List[torch.Tensor]
    index: List[Tuple[slice, ...]]

    @classmethod
    def of(cls, mesh, spec: Spec, shape, blocks) -> "Sharded":
        """The layout of ``blocks``, one a position, already cut under
        ``spec`` from a ``shape`` tensor."""
        return cls(mesh, tuple(spec), tuple(shape), list(blocks),
                   [block_index(mesh, spec, shape, p)
                    for p in range(mesh.size)])

    def along(self, dim: int) -> List[torch.Tensor]:
        """One block for each distinct slice of ``dim``, in order along it
        (the first position that holds each), e.g. a cache's sequence
        shards."""
        seen: Dict[int, torch.Tensor] = {}
        for idx, blk in zip(self.index, self.blocks):
            seen.setdefault(idx[dim].start, blk)
        return [seen[s] for s in sorted(seen)]


def block_index(mesh, spec: Spec, shape, position: int) -> Tuple[slice, ...]:
    """The slice of a ``shape`` tensor that mesh ``position`` holds."""
    coords = dict(zip(mesh.axis_names,
                      (int(c) for c in
                       _unravel(position, mesh.devices.shape))))
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for d, entry in zip(shape, spec):
        n, k = 1, 0
        for a in _axes(entry):
            k = k * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        if d % n:
            raise ValueError(f"dim {d} does not split over {entry!r} "
                             f"({n} blocks) of {mesh.shape}")
        size = d // n
        out.append(slice(k * size, (k + 1) * size))
    return tuple(out)


def _unravel(i: int, shape) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(i % s)
        i //= s
    return tuple(reversed(out))


def shard(tensor: torch.Tensor, spec: Spec, mesh) -> Sharded:
    """Cut ``tensor`` into the blocks each position of ``mesh`` holds under
    ``spec`` and copy each block to its position's device (on the current
    stream).  A block that is the whole tensor, for a position on the
    device the tensor lies on, is the tensor itself.  A dim that does not
    split evenly raises."""
    if len(spec) > tensor.dim():
        raise ValueError(f"spec {spec} is longer than the rank of a "
                         f"{tuple(tensor.shape)} tensor")
    placed: Dict[Tuple, torch.Tensor] = {}
    blocks, index = [], []
    for pos, dev in enumerate(mesh.device_list):
        idx = block_index(mesh, spec, tensor.shape, pos)
        key = (dev, tuple((s.start, s.stop) for s in idx))
        if key not in placed:
            part = tensor[idx]
            if part.shape == tensor.shape and dev == tensor.device:
                blk = tensor          # the whole, where it already lies
            else:
                blk = torch.empty(part.shape, dtype=part.dtype, device=dev)
                blk.copy_(part)
            placed[key] = blk
        blocks.append(placed[key])
        index.append(idx)
    return Sharded(mesh, tuple(spec), tuple(tensor.shape), blocks, index)


def unshard(sharded: Sharded, device=None) -> torch.Tensor:
    """The whole tensor from its blocks, on ``device`` (default: the first
    position's)."""
    first = sharded.blocks[0]
    out = torch.empty(sharded.shape, dtype=first.dtype,
                      device=first.device if device is None else device)
    for idx, blk in zip(sharded.index, sharded.blocks):
        out[idx] = blk
    return out


def shard_tree(tree, shardings, free: bool = False) -> Any:
    """``shard`` every leaf of ``tree`` under the matching ``(mesh, spec)``
    of ``shardings`` (a tree of the same keys), leaf by leaf.  A ``HALVED``
    leaf of last dim n is placed as (..., 2, n / 2) with each half split
    under the spec's last entry (dropped where it does not divide n / 2):
    a block's ``flatten(-2)`` is its x channels, then the same z
    channels.

    With ``free`` each leaf is deleted from ``tree`` as soon as its blocks
    are placed, so a caller that holds no other reference to it never
    holds a whole tree and all its blocks at once (qwen2-72b at 24 layers:
    47.1 GB of bf16 either way)."""
    out: Dict[str, Any] = {}
    for key in list(tree):
        sub = tree[key]
        if isinstance(sub, dict):
            out[key] = shard_tree(sub, shardings[key], free)
            continue
        mesh, spec = shardings[key]
        if key in HALVED:
            sub = sub.unflatten(-1, (2, -1))
            spec = tuple(spec) + (None,) * (sub.dim() - 1 - len(spec))
            spec = spec[:-1] + _fit(mesh, sub.shape[-2:], (None, spec[-1]))
        out[key] = shard(sub, spec, mesh)
        if free:
            del tree[key], sub
    return out


def is_placed(tree) -> bool:
    """Whether a param tree's leaves are ``Sharded`` (placed over a mesh by
    ``shard_tree``) rather than whole tensors."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()), None)
    return isinstance(tree, Sharded)


def replicated_axes(sharded: Sharded) -> Tuple[str, ...]:
    """The mesh axes ``sharded``'s spec does not name: the positions that
    differ only along them hold the same slice."""
    named = {a for e in sharded.spec for a in _axes(e)}
    return tuple(a for a in sharded.mesh.axis_names if a not in named)


def distinct_blocks(sharded: Sharded) -> List[torch.Tensor]:
    """Each block tensor of ``sharded`` once (positions may share one), in
    position order."""
    seen: Dict[int, torch.Tensor] = {}
    for blk in sharded.blocks:
        seen.setdefault(id(blk), blk)
    return list(seen.values())


def sum_copies(sharded: Sharded,
               grad_of: Callable[[torch.Tensor], torch.Tensor]) -> Sharded:
    """The gradient of a placed leaf, ``grad_of(block)`` being what autograd
    gave each distinct block: every distinct slice's gradient counted once.

    Positions that share a block share its gradient: autograd has already
    added every use of the block into it, so it is not summed again.  The
    copies of one slice that are distinct blocks (on different devices, or
    cloned) each hold a partial gradient; these are summed over the slice's
    group (``collectives.groups`` along the axes the spec does not name) in
    that group's fixed order, first copy first, and every copy gets the sum
    on its own device.  The result shares blocks as ``sharded`` does."""
    mesh, devices = sharded.mesh, sharded.mesh.device_list
    out: List[torch.Tensor] = [None] * mesh.size
    for g in C.groups(mesh, replicated_axes(sharded)):
        first: Dict[int, int] = {}
        for p in g:
            first.setdefault(id(sharded.blocks[p]), p)
        if len(first) == 1:
            grad = grad_of(sharded.blocks[g[0]])
            for p in g:
                out[p] = grad
            continue
        home = devices[g[0]]
        total = None
        for p in first.values():
            part = grad_of(sharded.blocks[p]).to(home)
            total = part if total is None else total + part
        got = {key: total.to(devices[p]) for key, p in first.items()}
        for p in g:
            out[p] = got[id(sharded.blocks[p])]
    return Sharded(mesh, sharded.spec, sharded.shape, out,
                   list(sharded.index))


def local_tree(sharded_tree, position: int) -> Any:
    """The blocks mesh ``position`` holds, as a tree of plain tensors."""
    return tree_map_with_path(lambda _, s: s.blocks[position], sharded_tree)
