"""Plain PyTorch version of the fused masked-pool + L2-normalise epilogue."""
from __future__ import annotations

import torch


def pool_norm_ref(h: torch.Tensor, mask: torch.Tensor,
                  pool: str = "mean") -> torch.Tensor:
    """h: (B, S, D) hidden states; mask: (B, S) 1 = real token.

    pool: "mean" (jina-style masked mean) or "cls" (bge-style first token).
    Returns (B, D) float32 L2-normalised embeddings; a fully masked row (a
    bucketed batch's padding row) pools to the zero vector.
    """
    hf = h.float()
    m = mask.float()
    if pool == "mean":
        pooled = (hf * m[..., None]).sum(1) / m.sum(1, keepdim=True).clamp_min(1.0)
    elif pool == "cls":
        pooled = hf[:, 0] * m[:, :1].clamp_max(1.0)
    else:
        raise ValueError(f"unknown pool mode {pool!r}")
    return pooled / torch.linalg.vector_norm(pooled, dim=-1,
                                             keepdim=True).clamp_min(1e-9)
