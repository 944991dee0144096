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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch


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


def init(params) -> Dict[str, Any]:
    """Zero moments in fp32 beside each param, and step 0."""
    device = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, fp32, summed leaf by leaf
    in the reference's order."""
    total = None
    for leaf in tree_leaves(tree):
        s = leaf.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig = AdamWConfig()
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (params, state, {"grad_norm"}), the params
    and the state's moments updated in place."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_() * (1 - cfg.b2))
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        u.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(p.float() - cfg.lr * u)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        upd(p, g, m, v)
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm}
