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
versions throughout.

A param tree placed over a mesh (``parallel.sharding.shard_tree`` under
``train_shardings``: the reference's train-mode rules, every weight's
d_model-like dim over ``data`` and its d_ff, heads, vocab, experts or
d_inner dim over ``model``) runs on the mesh's positions in one process:
the forward is ``models.tp.forward`` (each layer rematerialised with its
FSDP gathers inside), the CE runs at each position on its batch rows and
its vocab columns (``mesh_chunked_ce``), autograd carries the gradients
back through ``parallel.collectives`` (a gather's into the slices of its
blocks, a sum's to every member), ``sharding.sum_copies`` counts every
distinct slice's gradient once, and ``optim`` updates each distinct block
once.  A tree of whole tensors runs on the device it lies on.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, lm, tp
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding
from repro_torch.steps import optim


def _chunk_size(S: int, target: int = 512) -> int:
    for c in range(min(target, S), 0, -1):
        if S % c == 0:
            return c
    return S


def _chunk_nll(hc: torch.Tensor, head: torch.Tensor,
               lc: torch.Tensor) -> torch.Tensor:
    """-sum of the log-probabilities of labels lc (B, c) under the fp32
    logits of hidden states hc (B, c, D)."""
    return _chunk_nll_of((hc @ head.to(hc.dtype)).float(), lc)


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


def _mesh_chunk_nll(run: tp.Run, vsplit: bool, hcs, heads, lcs):
    """Per position: -sum of the log-probabilities of its rows' labels lcs
    (b, c) under the fp32 logits of hcs (b, c, D) and its head block.  With
    the vocab columns split over ``model`` the log-sum-exp comes from the
    group's maximum and sum over ``model`` and the label's logit from the
    position whose columns hold it, so every member of a group gets the
    same sum and none holds the chunk's whole logits."""
    logits = [(h @ w.to(h.dtype)).float() for h, w in zip(hcs, heads)]
    if not vsplit:
        return [_chunk_nll_of(lg, lc) for lg, lc in zip(logits, lcs)]
    mx = C.all_reduce_max([lg.detach().amax(-1, keepdim=True)
                           for lg in logits], run.mesh, run.model)
    se = run.sum_model([torch.exp(lg - m).sum(-1, keepdim=True)
                        for lg, m in zip(logits, mx)])
    picked = []
    for p, (lg, lc) in enumerate(zip(logits, lcs)):
        n = lg.shape[-1]
        t = lc.long()[..., None] - run.mi[p] * n
        inside = (t >= 0) & (t < n)
        picked.append(torch.gather(lg, -1, t.clamp(0, n - 1))
                      .masked_fill(~inside, 0))
    ll = run.sum_model(picked)
    return [(m + torch.log(e) - y).sum() for m, e, y in zip(mx, se, ll)]


def _chunk_nll_of(logits: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(lp, -1, lc.long()[..., None]).sum()


def mesh_chunked_ce(run: tp.Run, hs, labels: torch.Tensor,
                    target_chunk: int = 512) -> torch.Tensor:
    """``chunked_ce`` over a mesh's positions: hs holds each position's
    final hidden states of its rows (b, S, D), ``labels`` the whole (B, S).
    Each chunk runs at every position on its rows and its head block, and
    is recomputed in the backward.  A group over ``model`` holds one sum of
    its rows; the first member's sums are added over the data axes in the
    collectives' fixed order where the batch is split over them (else the
    first position's whole batch is counted once), then divided by B * S:
    a 0-dim fp32 tensor on the first position's device."""
    S = hs[0].shape[1]
    c = _chunk_size(S, target_chunk)
    heads, vsplit = run.head()
    lbl = run.split_rows(labels)
    tot = [torch.zeros((), dtype=torch.float32, device=d)
           for d in run.devices]
    for c0 in range(0, S, c):
        part = slice(c0, c0 + c)
        sums = checkpoint(_mesh_chunk_nll, run, vsplit,
                          [h[:, part] for h in hs], heads,
                          [lc[:, part] for lc in lbl], use_reentrant=False)
        tot = [t + x for t, x in zip(tot, sums)]
    if run.b_split:
        tot = C.all_reduce_sum(tot, run.mesh, run.dp)
    return tot[0] / (run.B * S)


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
    or tensors; moved to the params' device, or to the first mesh
    position's).  On a tree placed over ``mesh`` the step runs on the
    mesh's positions (``models.tp``) and the CE is ``mesh_chunked_ce``."""
    big = mesh is None or shape.global_batch >= sharding._dp_size(mesh)
    constrain = sharding.hidden_constraint(mesh, big)

    def mesh_loss(params, b):
        if cfg.cross_attention:
            hs, aux = tp.encdec_forward(params, cfg, b["tokens"],
                                        b["frames"], mesh,
                                        compute_dtype=compute_dtype)
        else:
            hs, aux = tp.forward(params, cfg, b["tokens"], mesh,
                                 extra_embed=b.get("patches"),
                                 compute_dtype=compute_dtype)
            if cfg.frontend == "vision":
                hs = [h[:, cfg.num_patches:] for h in hs]
        run = tp.Run(cfg, mesh, params, b["tokens"].shape[0])
        return mesh_chunked_ce(run, hs, b["labels"]), aux

    def loss_fn(params, batch):
        dev = optim.leaf_device(optim.tree_leaves(params)[0])
        b = {k: _as_tensor(v, dev) for k, v in batch.items()}
        if mesh is not None and sharding.is_placed(params):
            ce, aux = mesh_loss(params, b)
        elif cfg.cross_attention:
            h, aux = encdec.forward(params, cfg, b["tokens"], b["frames"],
                                    remat=True, return_hidden=True,
                                    compute_dtype=compute_dtype)
            ce = chunked_ce(h, params["lm_head"], b["labels"])
        else:
            h, aux = lm.forward(params, cfg, b["tokens"],
                                extra_embed=b.get("patches"), remat=True,
                                return_hidden=True, constrain=constrain,
                                compute_dtype=compute_dtype)
            if cfg.frontend == "vision":
                h = h[:, cfg.num_patches:]   # loss only over text positions
            ce = chunked_ce(h, lm.head_weights(params, cfg), b["labels"])
        return ce + aux_weight * aux, (ce, aux)

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((loss, (ce, aux)), grads): the loss and the gradient of every param
    leaf, a tree of params' structure (zeros for a leaf the loss does not
    reach).  The params are marked as requiring grad for the call.  For a
    placed tree each distinct block is marked and the gradients come back
    placed alike, every distinct slice's counted once
    (``sharding.sum_copies``)."""
    leaves = optim.tree_leaves(params)
    placed = isinstance(leaves[0], sharding.Sharded)
    tensors = ([b for s in leaves for b in sharding.distinct_blocks(s)]
               if placed else leaves)
    for p in tensors:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, (ce, aux) = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    finally:
        for p in tensors:
            p.requires_grad_(False)
    got = {id(p): torch.zeros_like(p) if g is None else g
           for p, g in zip(tensors, grads)}
    if placed:
        grad_tree = optim.tree_map(
            lambda s: sharding.sum_copies(s, lambda b: got[id(b)]), params)
    else:
        grad_tree = optim.tree_map(lambda p: got[id(p)], params)
    return (loss.detach(), (ce.detach(), aux.detach())), grad_tree


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                     opt_cfg: optim.AdamWConfig = optim.AdamWConfig(),
                     aux_weight: float = 0.01, compute_dtype=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``loss``, ``ce``, ``moe_aux`` and ``grad_norm``
    (0-dim tensors).  The params and the optimizer state are updated in
    place (``optim.update``).  ``compute_dtype``: the activations' dtype
    (None: ``layers.COMPUTE_DTYPE``, bf16).  On a tree placed over ``mesh``
    the params and the state stay placed and the metrics lie on the first
    position's device."""
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
    opt state, metrics) out.  ``sharding.shard_tree(params, psh)`` places
    a tree the step runs on the mesh's positions; the optimizer state
    follows the params' placement (``optim.init``) and the metrics come
    back on the first position's device."""
    psh = sharding.param_shardings(mesh, params_shape)
    osh = {"m": psh, "v": psh, "step": (mesh, ())}
    bsh = {k: (mesh, v)
           for k, v in sharding.batch_pspecs(cfg, shape, mesh).items()}
    metrics_sh = {k: (mesh, ()) for k in ("loss", "ce", "moe_aux",
                                          "grad_norm")}
    return (psh, osh, bsh), (psh, osh, metrics_sh)
