"""Serving precision policies for the embedder's param tree.

``serve_params`` is the one load-time entry every serving backend uses to
realise an ``embed_dtype`` policy.  This port serves ``fp32`` (the
precision oracle) and ``bf16`` (every float leaf cast once, bf16
activations).  The two int8 policies need the port's quant_matmul kernels
and ``quantize_params``, which come with the int8 slice: until then they
raise instead of serving something else.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Params = Dict[str, Any]

# embed_dtype perf-flag values a serving backend names
EMBED_DTYPES = ("fp32", "bf16", "int8", "int8_w8a8")

# policies that additionally quantize activations at every projection
ACT_QUANT_DTYPES = frozenset({"int8_w8a8"})


def wants_act_quant(dtype: str | None) -> bool:
    """True when the policy quantizes activations too (W8A8)."""
    return dtype in ACT_QUANT_DTYPES


def _cast_floats(tree: Params, dtype: torch.dtype) -> Params:
    return {k: _cast_floats(v, dtype) if isinstance(v, dict)
            else (v.to(dtype) if v.is_floating_point() else v)
            for k, v in tree.items()}


def serve_params(params: Params, dtype: str) -> Tuple[Params, torch.dtype]:
    """Realise an ``embed_dtype`` policy on a float param tree.

    Returns ``(tree, compute_dtype)``: ``fp32`` gives the tree untouched and
    fp32 activations; ``bf16`` casts every float leaf once to bf16 and
    computes in bf16.

    ``fp32`` is the precision oracle, so realising it switches TF32 off for
    the process (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``): TF32 keeps about three decimal
    digits in every fp32 matmul on the card.  ``embed`` refuses an fp32
    forward on the card while TF32 is on.
    """
    if dtype not in EMBED_DTYPES:
        raise ValueError(f"embed dtype must be one of {'|'.join(EMBED_DTYPES)}"
                         f", got {dtype!r}")
    if dtype in ("int8", "int8_w8a8"):
        raise NotImplementedError(
            f"embed_dtype={dtype} needs the int8 slice of the port "
            f"(models/quantize.py in full and the quant_matmul kernels, "
            f"listed first in ROADMAP.md); this port serves fp32 and bf16")
    if dtype == "bf16":
        return _cast_floats(params, torch.bfloat16), torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return params, torch.float32
