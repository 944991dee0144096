"""Train-step builder: remat'd forward + chunked cross-entropy + AdamW,
the reference's ``steps/train.py`` in PyTorch.

The CE is computed in sequence chunks (logits per chunk in fp32, each
chunk recomputed in the backward under ``torch.utils.checkpoint``), so
(B, S, V) is never held: with vocabularies of 100-152 k that matters more
than anything else in the step.

On the card the step runs the port's hand-written kernels forward and
backward: ``flash_attention``, ``rmsnorm`` and ``ssm_scan`` carry
gradients through their backward kernels, and a kernel without one raises
under autograd rather than cut the graph.  CPU tensors take the plain
versions throughout.  The step runs on one device: a mesh of more than one
raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, lm
from repro_torch.parallel import sharding
from repro_torch.steps import optim

TP_ITEM = "ROADMAP.md Queue 1 item 6, tensor parallelism across cards"


def _chunk_size(S: int, target: int = 512) -> int:
    for c in range(min(target, S), 0, -1):
        if S % c == 0:
            return c
    return S


def _chunk_nll(hc: torch.Tensor, head: torch.Tensor,
               lc: torch.Tensor) -> torch.Tensor:
    """-sum of the log-probabilities of labels lc (B, c) under the fp32
    logits of hidden states hc (B, c, D)."""
    logits = (hc @ head.to(hc.dtype)).float()
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(lp, -1, lc.long()[..., None]).sum()


def chunked_ce(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               target_chunk: int = 512) -> torch.Tensor:
    """Mean next-token CE from final hidden states h (B, S, D), chunked
    over the sequence, each chunk's logits recomputed in the backward."""
    B, S, D = h.shape
    c = _chunk_size(S, target_chunk)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, c):
        part = slice(c0, c0 + c)
        tot = tot + checkpoint(_chunk_nll, h[:, part], head, labels[:, part],
                               use_reentrant=False)
    return tot / (B * S)


def _check_mesh(mesh) -> None:
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"training over a mesh of {mesh.size} devices ({mesh.shape}) is "
            f"not ported ({TP_ITEM})")


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))   # a copy: x may be read-only
    return x.to(device)


def build_loss_fn(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                  aux_weight: float = 0.01, compute_dtype=None):
    """``loss_fn(params, batch) -> (loss, (ce, moe_aux))``: the remat'd
    forward, the chunked CE over the text positions, plus ``aux_weight``
    times the MoE load-balance loss.  ``batch`` holds ``tokens``,
    ``labels`` and, per family, ``frames`` or ``patches`` (numpy arrays
    or tensors; moved to the params' device)."""
    _check_mesh(mesh)
    big = mesh is None or shape.global_batch >= sharding._dp_size(mesh)
    constrain = sharding.hidden_constraint(mesh, big)

    def loss_fn(params, batch):
        dev = optim.tree_leaves(params)[0].device
        b = {k: _as_tensor(v, dev) for k, v in batch.items()}
        if cfg.cross_attention:
            h, aux = encdec.forward(params, cfg, b["tokens"], b["frames"],
                                    remat=True, return_hidden=True,
                                    compute_dtype=compute_dtype)
            head = params["lm_head"]
        else:
            h, aux = lm.forward(params, cfg, b["tokens"],
                                extra_embed=b.get("patches"), remat=True,
                                return_hidden=True, constrain=constrain,
                                compute_dtype=compute_dtype)
            head = lm.head_weights(params, cfg)
            if cfg.frontend == "vision":
                h = h[:, cfg.num_patches:]   # loss only over text positions
        ce = chunked_ce(h, head, b["labels"])
        return ce + aux_weight * aux, (ce, aux)

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((loss, (ce, aux)), grads): the loss and the gradient of every param
    leaf, a tree of params' structure (zeros for a leaf the loss does not
    reach).  The params are marked as requiring grad for the call."""
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, (ce, aux) = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    grad_tree = optim.tree_map(lambda _: next(it), params)
    return (loss.detach(), (ce.detach(), aux.detach())), grad_tree


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                     opt_cfg: optim.AdamWConfig = optim.AdamWConfig(),
                     aux_weight: float = 0.01, compute_dtype=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``loss``, ``ce``, ``moe_aux`` and ``grad_norm``
    (0-dim tensors).  The params and the optimizer state are updated in
    place (``optim.update``).  ``compute_dtype``: the activations' dtype
    (None: ``layers.COMPUTE_DTYPE``, bf16)."""
    loss_fn = build_loss_fn(cfg, shape, mesh, aux_weight, compute_dtype)

    def train_step(params, opt_state, batch):
        (loss, (ce, aux)), grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, om = optim.update(grads, opt_state, params,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, "ce": ce, "moe_aux": aux,
                                   **om}

    return train_step


def train_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    params_shape):
    """The reference's (in, out) shardings of the train step: trees of
    ``(mesh, spec)`` pairs for (params, opt state, batch) in and (params,
    opt state, metrics) out.  The port executes them on one device only
    (``build_train_step`` refuses a larger mesh)."""
    psh = sharding.param_shardings(mesh, params_shape)
    osh = {"m": psh, "v": psh, "step": (mesh, ())}
    bsh = {k: (mesh, v)
           for k, v in sharding.batch_pspecs(cfg, shape, mesh).items()}
    metrics_sh = {k: (mesh, ()) for k in ("loss", "ce", "moe_aux",
                                          "grad_norm")}
    return (psh, osh, bsh), (psh, osh, metrics_sh)
