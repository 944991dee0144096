"""Serve a decoder LM (token generation) through WindVE on the PyTorch port,
with online queue-depth re-calibration: the paper's technique applied
beyond embeddings, plus the adaptive estimator.

A modeled accelerator pool (depth 6) takes queries first; the real tier
(depth 2) runs the port's ``LMGenerateBackend`` on ``--device``: the card
(the model at its published width) by default, or the host CPU (the
reduced config).  ``OnlineCalibrator`` re-fits depths from live batch
latencies every 4 observations.

    PYTHONPATH=src python examples/torch_serve_llm.py --device cpu
"""
import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.adaptive import OnlineCalibrator, attach
from repro_torch.core.llm_backend import LMGenerateBackend
from repro_torch.core.routing import CPU, NPU, TierSpec
from repro_torch.core.simulator import DeviceModel
from repro_torch.core.windve import ModeledBackend, WindVE, resolve_device
from repro_torch.data.workload import make_queries
from repro_torch.models import api


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--queries", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slo", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if dev.type != "cuda":
        cfg = cfg.smoke()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    print(f"[serve-llm] {cfg.name}: generation backend on {dev}")

    # the real tier generates tokens; the accelerator pool is modeled
    cpu_be = LMGenerateBackend(cfg, params, max_prompt=24,
                               max_new_tokens=args.new_tokens, device=dev)
    npu_be = ModeledBackend(DeviceModel("tpu-pool", beta=0.05, b=0.01, a=0.0),
                            embed_dim=args.new_tokens)
    engine = WindVE(tiers=[TierSpec(NPU, 6, backend=npu_be),
                           TierSpec(CPU, 2, backend=cpu_be)])

    # adapt depths online from live latencies, fed through the engine's
    # batch-completion hook
    cal = OnlineCalibrator(slo_s=args.slo, min_points=2)
    attach(engine, cal, refit_every=4)

    try:
        queries = make_queries(args.queries, cfg.vocab_size, length=16)
        t0 = time.monotonic()
        futs = [engine.submit(payload=q, length=16) for q in queries]
        outs = [f.result(timeout=300) for f in futs if f is not None]
        wall = time.monotonic() - t0

        s = engine.stats
        print(f"[serve-llm] {len(outs)} generations in {wall:.2f}s  "
              f"rejected(BUSY)={s.rejected}  per-device={s.per_device}")
        sample = next((o for o in outs if o.dtype.kind in "iu"), outs[0])
        print(f"[serve-llm] sample continuation token ids: "
              f"{list(map(int, sample))}")
        print(f"[serve-llm] NPU depth after adaptation: "
              f"{engine.qm.queues[NPU].depth} (started 6); "
              f"observations: {cal.n_observations(NPU)}")
    finally:
        engine.shutdown()
    return s, outs


if __name__ == "__main__":
    main()
