"""Serve token generation through WindVE, with online queue-depth
re-calibration: the paper's technique applied beyond embeddings.

The real tier runs ``LMGenerateBackend`` (prefill + greedy decode) on one
device, the card by default; a modeled accelerator pool stands beside it,
and ``adaptive.attach`` refits the depths from live batch latencies::

    PYTHONPATH=src python -m repro_torch.launch.serve_llm --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve_llm --smoke --device cpu

``--arch`` names a decoder the port serves: hymba-1.5b (the default),
stablelm-1.6b, starcoder2-7b, falcon-mamba-7b, internlm2-20b,
granite-moe-3b-a800m, qwen3-moe-30b-a3b, internvl2-2b or qwen2-72b.  Each
runs at its published width with random weights from a seeded generator;
``--smoke`` takes the reduced config, ``--layers N`` keeps the published
width and cuts the depth to N layers (qwen2-72b's 80 layers hold 145 GB of
bf16 weights; 24 of them, 47 GB with the embedding and head, fit one
card).  ``--weights bf16`` keeps the weights in bf16
(the default fp32 casts them to the bf16 compute at every use; the values
used are the same): internlm2-20b and qwen3-moe-30b-a3b fit one 80 GB card
only so.  ``--opt moe_row_dispatch=1`` dispatches an MoE block's tokens
per batch row.  Prompts of 64 tokens, batches of up to 16 on the real
tier.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import perf_flags
from repro_torch.configs import ARCH_MODULES, get_config
from repro_torch.core.adaptive import OnlineCalibrator, attach
from repro_torch.core.llm_backend import LMGenerateBackend
from repro_torch.core.routing import CPU, NPU, TierSpec
from repro_torch.core.simulator import DeviceModel
from repro_torch.core.windve import ModeledBackend, WindVE, resolve_device
from repro_torch.data.workload import make_queries
from repro_torch.models import api


MAX_PROMPT = 64          # prompts are right-aligned in this window
DEPTH = 16               # the real tier's queue depth, its largest batch
NPU_DEPTH = 6            # the modeled pool's starting depth
WEIGHTS = {"fp32": torch.float32, "bf16": torch.bfloat16}


def build_engine(arch: str = "hymba-1.5b", smoke: bool = False,
                 device="cuda", new_tokens: int = 16, slo: float = 30.0,
                 weights_dtype=torch.float32, layers: Optional[int] = None):
    """(engine, cfg, calibrator): the real generation tier (``CPU``, as in
    the reference's example and the port's embedding server) on
    ``device`` and the modeled pool (``NPU``), with the online calibrator
    attached.  Weights are random, of ``weights_dtype``, from a generator
    seeded with 0.  ``layers`` cuts the depth."""
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    if layers:
        cfg = cfg.replace(num_layers=layers)
    dev = resolve_device(device)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev, dtype=weights_dtype)
    real = LMGenerateBackend(cfg, params, max_prompt=MAX_PROMPT,
                             max_new_tokens=new_tokens, device=dev)
    modeled = ModeledBackend(DeviceModel("tpu-pool", beta=0.05, b=0.01, a=0.0),
                             embed_dim=new_tokens)
    engine = WindVE(tiers=[TierSpec(NPU, NPU_DEPTH, backend=modeled),
                           TierSpec(CPU, DEPTH, backend=real)])
    # adapt depths online from live latencies, fed through the engine's
    # batch-completion hook
    cal = OnlineCalibrator(slo_s=slo, min_points=2)
    attach(engine, cal, refit_every=4)
    return engine, cfg, cal


def main(argv: Optional[List[str]] = None) -> List[np.ndarray]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b",
                    choices=[a for a in ARCH_MODULES
                             if get_config(a).has_decoder])
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--weights", choices=sorted(WEIGHTS), default="fp32",
                    help="the resident weights' dtype")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0: the config's)")
    ap.add_argument("--opt", default="",
                    help="perf flags, k=v,... (e.g. moe_row_dispatch=1)")
    ap.add_argument("--queries", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slo", type=float, default=30.0)
    args = ap.parse_args(argv)
    perf_flags.set_flags(**perf_flags.parse_opt(args.opt))

    engine, cfg, cal = build_engine(args.arch, smoke=args.smoke,
                                    device=args.device,
                                    new_tokens=args.new_tokens, slo=args.slo,
                                    weights_dtype=WEIGHTS[args.weights],
                                    layers=args.layers)
    real = engine.backends[CPU]
    print(f"[serve-llm] {cfg.name}: generation backend {real.name}, "
          f"{real.params_nbytes} bytes of {args.weights} params")
    try:
        queries = make_queries(args.queries, cfg.vocab_size, MAX_PROMPT)
        t0 = time.monotonic()
        futs = [engine.submit(payload=q, length=MAX_PROMPT) for q in queries]
        outs = [f.result(timeout=600) for f in futs if f is not None]
        wall = time.monotonic() - t0
        s = engine.stats
        print(f"[serve-llm] {len(outs)} generations in {wall:.2f}s  "
              f"rejected(BUSY)={s.rejected}  per-device={s.per_device}")
        sample = next((o for o in outs if o.dtype.kind in "iu"), None)
        if sample is not None:
            print(f"[serve-llm] sample continuation token ids: "
                  f"{list(map(int, sample))}")
        print(f"[serve-llm] NPU depth after adaptation: "
              f"{engine.qm.queues[NPU].depth} (started {NPU_DEPTH}); "
              f"observations: {cal.n_observations(NPU)}")
    finally:
        engine.shutdown()
    return outs


if __name__ == "__main__":
    main()
