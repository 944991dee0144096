"""Serving precision policies for the embedder's param tree, and the one-shot
int8 weight quantization the two int8 policies serve.

``serve_params`` is the one load-time entry every serving backend uses to
realise an ``embed_dtype`` policy: ``fp32`` (the precision oracle),
``bf16`` (every float leaf cast once, bf16 activations), ``int8`` (dense
projections quantized by ``quantize_params``, fp32 activations) and
``int8_w8a8`` (the same tree; the backends also quantize activations at
every projection, ``wants_act_quant``).

``quantize_dense`` gives per-output-channel symmetric scales: a weight
``w: (K, N)`` (or layer-stacked ``(L, K, N)``) quantizes along its
contraction axis, ``scale[n] = max|w[:, n]| / 127`` and
``q = round(w / scale)`` clipped to [-127, 127], so the dequant commutes
with the contraction and the kernels apply the scale once in their
epilogue (``repro_torch.kernels.quant_matmul``).  The scale rides in the
tree as a ``{name}_scale`` fp32 sibling of the int8 weight, so
``layers.dense_apply`` picks the quantized route from the params alone.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Params = Dict[str, Any]

# embed_dtype perf-flag values a serving backend names
EMBED_DTYPES = ("fp32", "bf16", "int8", "int8_w8a8")

# policies that additionally quantize activations at every projection
ACT_QUANT_DTYPES = frozenset({"int8_w8a8"})

# 2-D dense projections consumed as ``x @ w`` by ``layers.dense_apply``
DENSE_KEYS = frozenset({"wq", "wk", "wv", "wo",
                        "w_in", "w_out", "w_gate", "w_up", "w_down"})

SCALE_SUFFIX = "_scale"

# subtrees whose leaves are stacked on a leading layer dimension
STACK_KEYS = ("blocks", "enc_blocks", "dec_blocks")

FLT_MIN = torch.finfo(torch.float32).tiny


def wants_act_quant(dtype: str | None) -> bool:
    """True when the policy quantizes activations too (W8A8)."""
    return dtype in ACT_QUANT_DTYPES


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` with every subnormal value replaced by zero.

    XLA flushes subnormal floats to zero on the CPU and on the TPU, so the
    JAX package quantizes a subnormal value as 0 (and an all-subnormal row
    or channel as an all-zero one, scale 1).  The port does the same
    explicitly, on every device, so its int8 values and scales equal the
    reference's bit for bit."""
    return torch.where(x.abs() < FLT_MIN, torch.zeros_like(x), x)


def div127(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` as a true division on every device.  The divisor is a
    tensor on purpose: on the card PyTorch divides by a Python scalar as a
    multiply by its reciprocal, which rounds differently for some values."""
    return amax / torch.full_like(amax, 127.0)


def quantize_dense(w: torch.Tensor, axis: int = -2
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w8 int8, scale fp32) with per-output-channel symmetric scales.

    ``axis`` is the contraction dim of ``x @ w`` (-2: rows of the 2-D
    weight; a leading layer-stack dim broadcasts through).  An all-zero
    output channel gets scale 1 so the dequant never divides by zero.  The
    scale is a true division by 127 (``div127``) and ``torch.round`` rounds
    half to even, as ``jnp.round`` does.  (A channel whose max lies in
    [FLT_MIN, 127 * FLT_MIN) gets a subnormal scale here; under XLA's
    flush-to-zero the reference's scale there is 0.)"""
    wf = flush_subnormals(w.float())
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, div127(amax), torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(axis)


def quantize_params(params: Params) -> Params:
    """A new tree with every dense projection int8-quantized and its
    ``{name}_scale`` sibling added; other leaves are kept as they are (the
    caller owns their dtype policy).  A leaf under a ``STACK_KEYS`` subtree
    carries a leading layer dim; only leaves that are 2-D once that dim is
    set aside are projections (an expert stack has one dim more)."""

    def walk(node: Params, stacked: bool) -> Params:
        out: Params = {}
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf, stacked or name in STACK_KEYS)
                continue
            eff_ndim = leaf.dim() - (1 if stacked else 0)
            if (name in DENSE_KEYS and eff_ndim == 2
                    and leaf.is_floating_point()):
                out[name], out[name + SCALE_SUFFIX] = quantize_dense(leaf)
            else:
                out[name] = leaf
        return out

    return walk(params, False)


def is_quantized(params: Params) -> bool:
    """True if any key of the tree carries a dequant scale sibling."""
    return any(name.endswith(SCALE_SUFFIX)
               or (isinstance(leaf, dict) and is_quantized(leaf))
               for name, leaf in params.items())


def _cast_floats(tree: Params, dtype: torch.dtype) -> Params:
    return {k: _cast_floats(v, dtype) if isinstance(v, dict)
            else (v.to(dtype) if v.is_floating_point() else v)
            for k, v in tree.items()}


def serve_params(params: Params, dtype: str) -> Tuple[Params, torch.dtype]:
    """Realise an ``embed_dtype`` policy on a float param tree.

    Returns ``(tree, compute_dtype)``:

    * ``fp32`` -- the tree untouched, fp32 activations;
    * ``bf16`` -- every float leaf cast once to bf16, bf16 activations;
    * ``int8`` -- dense projections quantized by ``quantize_params``
      (int8 weights + fp32 scales), every other leaf as given, fp32
      activations: quantization error enters through the weights alone;
    * ``int8_w8a8`` -- the same tree; the backends also thread
      ``act_quant=True`` into ``embed`` (``wants_act_quant``), so every
      projection contracts int8 x int8 with int32 accumulation.

    The fp32-compute policies (``fp32``, ``int8``, ``int8_w8a8``) switch
    TF32 off for the process (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``): TF32 keeps about three decimal
    digits in every fp32 matmul on the card, and ``embed`` refuses an fp32
    forward on the card while it is on.
    """
    if dtype not in EMBED_DTYPES:
        raise ValueError(f"embed dtype must be one of {'|'.join(EMBED_DTYPES)}"
                         f", got {dtype!r}")
    if dtype == "bf16":
        return _cast_floats(params, torch.bfloat16), torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dtype in ("int8", "int8_w8a8"):
        return quantize_params(params), torch.float32
    return params, torch.float32
