"""Bidirectional text embedder -- the model WindVE serves -- in PyTorch.

bge-large-zh-v1.5 (CLS pooling) and jina-v2 (mean pooling) style: a
BERT-like encoder stack, then pooling and L2 normalisation through the
fused ``pool_norm`` op.  Params are the reference's nested dict, with every
``blocks/*`` leaf stacked on a leading layer dimension; ``params_from_numpy``
carries a reference tree over, so both packages compute the same thing.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.pool_norm import pool_norm
from repro_torch.models import layers as L

Params = Dict[str, Any]


def init_embedder(cfg: ModelConfig, generator: torch.Generator,
                  device="cuda", dtype=torch.float32) -> Params:
    """Random embedder params, drawn from ``generator`` on its own device and
    moved to ``device``.  Dense weights are N(0, 1/fan_in), the embedding
    table N(0, 0.02^2), norms start at scale 1 and bias 0 -- the reference's
    initialisers, with torch's random numbers."""
    lead = (cfg.num_layers,)
    ffn = L.init_mlp(generator, cfg, lead, dtype, device)
    attn = L.init_attention(generator, cfg, lead, dtype, device)
    return {
        "embed": L.dense_init(generator, (cfg.vocab_size, cfg.d_model), (),
                              dtype, device, scale=0.02),
        "blocks": {"norm1": L.init_norm(cfg, lead, dtype, device),
                   "attn": attn,
                   "norm2": L.init_norm(cfg, lead, dtype, device),
                   "ffn": ffn},
        "final_norm": L.init_norm(cfg, (), dtype, device),
    }


def unflatten(flat: Mapping[str, np.ndarray], prefix: str = "") -> Params:
    """{"a/b/c": array} -> {"a": {"b": {"c": array}}}, for keys that start
    with ``prefix`` (the golden file stores its tree as "param:a/b/c")."""
    tree: Params = {}
    for key in flat:
        if not key.startswith(prefix):
            continue
        node, parts = tree, key[len(prefix):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = flat[key]
    return tree


def params_from_numpy(tree: Mapping[str, Any], device="cuda") -> Params:
    """The reference's nested param dict of numpy arrays (``blocks/*``
    stacked on the layer dimension, as in ``tests/golden/golden_embed.npz``)
    -> the same nesting of tensors on ``device``, values and dtypes kept.
    An already quantized tree comes over as it is: int8 weights stay int8
    and their ``_scale`` siblings stay fp32.  A bfloat16 leaf (numpy's
    ``ml_dtypes.bfloat16``, which torch cannot read) comes over bit for bit
    through a 16-bit integer view."""
    out: Params = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[name] = params_from_numpy(leaf, device)
            continue
        # np.array copies: the file's arrays may be read-only
        a = np.array(leaf)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out[name] = t.to(device)
    return out


def layer_params(blocks: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked ``blocks`` tree (views, no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
          mask: Optional[torch.Tensor] = None, *,
          compute_dtype: Optional[torch.dtype] = None,
          act_quant: bool = False) -> torch.Tensor:
    """tokens: (B, S) ints; mask: (B, S) 1 = real token, left-aligned.
    Returns (B, d_model) float32 L2-normalised embeddings.

    The mask is honoured end to end: padded keys leave every attention
    softmax (``kv_len``), so an embedding does not depend on how far its
    batch was padded.  ``compute_dtype`` is the trunk's activation dtype
    (weights are cast to it at use); None keeps ``layers.COMPUTE_DTYPE``.
    The pooling epilogue accumulates in fp32 for any compute dtype.  An fp32
    forward on the card raises while TF32 matmuls are on
    (``quantize.serve_params`` switches them off for every fp32-compute
    policy, the int8 ones included).  ``act_quant`` turns on W8A8
    projections on an int8-quantized tree (``layers.dense_apply``); it
    changes nothing on a float tree.
    """
    B, S = tokens.shape
    device = tokens.device
    positions = torch.arange(S, dtype=torch.int32, device=device)
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    if (device.type == "cuda" and cdt == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "fp32 embed on the card with TF32 matmuls on: set "
            "torch.backends.cuda.matmul.allow_tf32 = False (serve_params("
            "params, 'fp32') does) so fp32 means fp32")
    h = params["embed"][tokens.long()].to(cdt)
    h = h + L.sinusoidal_positions(positions, cfg.d_model).to(h.dtype)
    blocks = params["blocks"]
    for i in range(blocks["norm1"]["scale"].shape[0]):
        bp = layer_params(blocks, i)
        hin = L.apply_norm(bp["norm1"], cfg, h)
        h = h + L.attn_forward(bp["attn"], cfg, hin, positions, causal=False,
                               kv_mask=mask, act_quant=act_quant)
        hin = L.apply_norm(bp["norm2"], cfg, h)
        h = h + L.apply_mlp(bp["ffn"], cfg, hin, act_quant)
    h = L.apply_norm(params["final_norm"], cfg, h)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=device)
    return pool_norm(h, mask, pool="mean" if cfg.pool == "mean" else "cls")
