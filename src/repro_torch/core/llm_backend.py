"""LM generation backend: token generation served through WindVE.

The paper serves an embedding model; the same queue-manager technique
applies to any batched request kind.  This backend runs prefill + greedy
decode for the decoder LMs of ``repro_torch.models.lm`` on one device (the
card unless the caller asks for the CPU), so
``WindVE(tiers=[..., TierSpec(tier, depth, backend=LMGenerateBackend(...))])``
serves token generation with the same dispatch, estimator calibration and
BUSY semantics as embeddings.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.routing import Query
from repro_torch.core.windve import Backend, _leaves, resolve_device

PAD_ID = 1


class LMGenerateBackend(Backend):
    """Batched prompt -> greedy continuation on one device.

    Prompts are right-aligned in a window of ``max_prompt`` tokens padded
    with id 1 (a query without a payload gets a deterministic ramp of ids);
    one prefill then ``max_new_tokens - 1`` decode steps, the argmax at
    each.  The cache is fp32 and, as in the reference backend, holds the
    prompt, the new tokens and, for a vision frontend, ``num_patches``
    slots more (the prompt carries no patches there either).
    ``compute_dtype`` is the activation dtype (None:
    ``layers.COMPUTE_DTYPE``, bf16).  The only device-to-host copy of a
    batch is the final copy of its tokens.
    """

    def __init__(self, cfg, params, max_prompt: int = 64,
                 max_new_tokens: int = 16, device="cuda",
                 compute_dtype=None):
        self.cfg = cfg
        self.params = params
        self.max_prompt = max_prompt
        self.max_new = max_new_tokens
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.name = f"torch-lm-{self.device.type}/{cfg.name}"
        self.params_nbytes = sum(t.numel() * t.element_size()
                                 for t in _leaves(params))
        # slots a prompt's cache holds past its tokens: the new tokens
        # and, as in the reference backend, a vision frontend's patches
        self.extra_slots = max_new_tokens + (
            cfg.num_patches if cfg.frontend == "vision" else 0)

    def prompt_tokens(self, queries: Sequence[Query]) -> np.ndarray:
        """(B, max_prompt) int32: each prompt right-aligned, pad id 1.
        An empty prompt raises ``ValueError``, as in the reference backend:
        there is no token to continue from."""
        toks = np.full((len(queries), self.max_prompt), PAD_ID, np.int32)
        for i, q in enumerate(queries):
            ids = q.payload
            if ids is None:
                ids = (np.arange(q.length) % (self.cfg.vocab_size - 2)) + 2
            n = min(len(ids), self.max_prompt)
            if n == 0:
                raise ValueError(f"query {q.qid}: empty prompt")
            toks[i, -n:] = np.asarray(ids[:n], np.int32)
        return toks

    def generate(self, toks, forced: Optional[np.ndarray] = None):
        """Greedy generation from prompt tokens (B, S).  Returns (tokens
        (B, max_new) int32 on the device, logits of every step
        (max_new, B, V) when ``forced`` is given).  ``forced``
        (max_new - 1, B) feeds those tokens to the decode steps instead of
        the argmax (teacher forcing)."""
        import torch

        from repro_torch.models import lm

        cfg, params, cdt = self.cfg, self.params, self.compute_dtype
        toks = torch.as_tensor(toks, dtype=torch.int32).to(self.device)
        if forced is not None:
            forced = torch.as_tensor(forced, dtype=torch.int32).to(self.device)
        steps = []
        with torch.inference_mode():
            logits, cache = lm.prefill(
                params, cfg, toks, max_len=toks.shape[1] + self.extra_slots,
                cache_dtype=torch.float32, compute_dtype=cdt)
            out = [logits.argmax(-1).to(torch.int32)]
            steps.append(logits)
            for t in range(self.max_new - 1):
                feed = out[-1] if forced is None else forced[t]
                logits, cache = lm.decode_step(params, cfg, feed, cache,
                                               compute_dtype=cdt)
                out.append(logits.argmax(-1).to(torch.int32))
                steps.append(logits)
        gen = torch.stack(out, dim=1)
        return gen, (torch.stack(steps) if forced is not None else None)

    def embed_batch(self, queries: Sequence[Query]) -> List[np.ndarray]:
        """Returns the generated continuation token ids per query."""
        gen = self.generate(self.prompt_tokens(queries))[0].cpu().numpy()
        return [gen[i] for i in range(len(queries))]

