"""Hand-rolled AdamW, the reference's ``steps/optim.py`` in PyTorch.

State layout mirrors the param tree: ``{"m": tree, "v": tree, "step":
int32 scalar tensor}``, the moments fp32 whatever the params' dtype.  The
math is the reference's, in fp32: the gradients clipped to a global norm
of ``grad_clip``, bias-corrected moments, decoupled weight decay.

``update`` writes the new params and moments into the given tensors in
place (under ``torch.no_grad()``): at stablelm-1.6b's 1.64 B parameters a
second copy of params and state (26 GB in fp32) would not fit beside the
first on one card.  It returns the same trees, as the reference returns
new ones.

A tree placed over a mesh (leaves ``parallel.sharding.Sharded``) keeps its
placement: the moments are placed under each param's spec and share blocks
as the param's blocks do, the global norm counts every element of the
whole once (each distinct slice's squares, added slice by slice in
position order and leaf by leaf), and each distinct block is updated once.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.parallel.sharding import Sharded


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict / tuple / list tree in the reference's
    order: dict keys sorted, sequences in order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of trees of the same structure, visited
    in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *parts) for parts in zip(tree, *rest))
    return fn(tree, *rest)


def leaf_device(leaf) -> torch.device:
    """A leaf's device: a placed leaf's first position's."""
    return (leaf.blocks[0] if isinstance(leaf, Sharded) else leaf).device


def _zeros_like(p):
    """fp32 zeros beside param ``p``: a tensor, or a ``Sharded`` whose
    blocks mirror ``p``'s (positions that share a param block share the
    moment's block)."""
    if not isinstance(p, Sharded):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    made: Dict[int, torch.Tensor] = {}
    for b in p.blocks:
        if id(b) not in made:
            made[id(b)] = torch.zeros(b.shape, dtype=torch.float32,
                                      device=b.device)
    return Sharded(p.mesh, p.spec, p.shape, [made[id(b)] for b in p.blocks],
                   list(p.index))


def init(params) -> Dict[str, Any]:
    """Zero moments in fp32 beside each param, and step 0 (on the first
    leaf's device, a placed tree's first position's)."""
    device = leaf_device(tree_leaves(params)[0])
    return {"m": tree_map(_zeros_like, params),
            "v": tree_map(_zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _squares(leaf, home) -> torch.Tensor:
    """The sum of a leaf's squares in fp32 on ``home``: a placed leaf's
    distinct slices once each, in position order."""
    if not isinstance(leaf, Sharded):
        return leaf.float().square().sum()
    total, seen = None, set()
    for idx, blk in zip(leaf.index, leaf.blocks):
        key = tuple((s.start, s.stop) for s in idx)
        if key in seen:
            continue
        seen.add(key)
        part = blk.float().square().sum().to(home)
        total = part if total is None else total + part
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, fp32, summed leaf by leaf
    in the reference's order (on the first leaf's device)."""
    leaves = tree_leaves(tree)
    home = leaf_device(leaves[0])
    total = None
    for leaf in leaves:
        s = _squares(leaf, home)
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig = AdamWConfig()
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (params, state, {"grad_norm"}), the params
    and the state's moments updated in place (a placed tree's distinct
    blocks once each)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    consts = {}

    def upd(p, g, m, v):
        if p.device not in consts:
            consts[p.device] = tuple(t.to(p.device)
                                     for t in (scale, bc1, bc2))
        sc, b1, b2 = consts[p.device]
        g = g.float() * sc
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_() * (1 - cfg.b2))
        u = (m / b1) / (torch.sqrt(v / b2) + cfg.eps)
        u.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(p.float() - cfg.lr * u)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        if not isinstance(p, Sharded):
            upd(p, g, m, v)
            continue
        done = set()
        for blocks in zip(p.blocks, g.blocks, m.blocks, v.blocks):
            if id(blocks[0]) not in done:
                done.add(id(blocks[0]))
                upd(*blocks)
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm}
