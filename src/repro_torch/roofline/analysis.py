"""Roofline terms of a step from its dry-run cost, the reference's
``roofline/analysis.py`` with the H100's constants.

Three terms, all in seconds (a step, a device):

    compute    = flops / PEAK_FLOPS_BF16
    memory     = bytes / HBM_BW
    collective = collective bytes / LINK_BW

The reference reads a compiled XLA program; the port reads the ``Cost`` of
a step traced on the meta device (``roofline.op_cost.analyse_step``), whose
kernels report their own work (``roofline.kernel_cost``).  The step runs on
one card, so its counts are that card's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.parallel.sharding import tree_map_with_path
from repro_torch.roofline.op_cost import COLLECTIVE_KINDS, Cost

# NVIDIA H100 SXM data sheet, for the card that nvidia-smi
# --query-gpu=name,power.limit --format=csv,noheader reads as
# "NVIDIA H100 80GB HBM3, 700.00 W" (a lower power limit runs slower)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores
PEAK_FLOPS_FP32 = 67e12         # FLOP/s, fp32 outside the tensor cores
PEAK_OPS_INT8 = 1979e12         # OP/s, dense int8 tensor cores
HBM_BW = 3.35e12                # B/s, HBM3
LINK_BW = 450e9                 # B/s each way, NVLink 4 (18 links)


def collective_bytes(cost: Cost) -> Dict[str, int]:
    """Bytes the counted step moves between mesh devices, by the
    reference's five collective kinds.  A step on one card, the only mesh
    the port executes (the dry run refuses the others), moves none: every
    entry is 0."""
    return {k: int(cost.coll.get(k, 0)) for k in COLLECTIVE_KINDS}


@dataclasses.dataclass
class Roofline:
    flops: float                 # a device's flops, kernels' included
    bytes_accessed: float        # a device's bytes, kernels' included
    coll_bytes: Dict[str, int]   # a device's collective result bytes
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float           # 6ND / 2ND "useful" flops, whole model
    useful_ratio: float          # model_flops / (flops * n_devices)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @property
    def bound_s(self) -> float:
        """The least time the step could take: its largest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)


def analyse(cost: Cost, n_devices: int, model_flops: float) -> Roofline:
    """The roofline terms of a step's ``cost`` on one of ``n_devices``."""
    coll = collective_bytes(cost)
    terms = {
        "compute": float(cost.flops) / PEAK_FLOPS_BF16,
        "memory": float(cost.bytes) / HBM_BW,
        "collective": float(sum(coll.values())) / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    useful = model_flops / max(float(cost.flops) * n_devices, 1.0)
    return Roofline(
        flops=float(cost.flops), bytes_accessed=float(cost.bytes),
        coll_bytes=coll, compute_s=terms["compute"],
        memory_s=terms["memory"], collective_s=terms["collective"],
        dominant=dominant, model_flops=model_flops, useful_ratio=useful)


def count_params(params_shape, active_moe_fraction: Optional[float] = None,
                 expert_key: str = "ffn") -> Dict[str, float]:
    """Total and active param counts of a nested-dict tree of (meta)
    tensors (``models.api.param_shapes``).  Stacked MoE expert weights are
    the leaves of 3 or more dims under ``expert_key``; the active count
    keeps ``active_moe_fraction`` of them."""
    sizes = []
    tree_map_with_path(lambda path, leaf: sizes.append(
        (leaf.numel(), expert_key in path and leaf.dim() >= 3)), params_shape)
    total = sum(n for n, _ in sizes)
    expert = sum(n for n, is_expert in sizes if is_expert)
    active = total
    if active_moe_fraction is not None and expert:
        active = total - expert + expert * active_moe_fraction
    return {"total": float(total), "active": float(active)}


def model_flops(cfg, shape, params_shape) -> float:
    """Useful-FLOPs yardstick: 6·N·D train, 2·N·D inference (N active)."""
    frac = (cfg.experts_per_token / cfg.num_experts) if cfg.is_moe else None
    n = count_params(params_shape, frac)["active"]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


__all__ = ["PEAK_FLOPS_BF16", "PEAK_FLOPS_FP32", "PEAK_OPS_INT8", "HBM_BW",
           "LINK_BW", "Roofline", "analyse", "collective_bytes",
           "count_params", "model_flops"]
