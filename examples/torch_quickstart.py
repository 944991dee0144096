"""Quickstart on the PyTorch port: WindVE in ~50 lines.

Builds a bge-style embedder, detects devices, calibrates queue depths with
the linear-regression estimator, and serves a burst of queries through the
collaborative engine -- Algorithm 1 + Eq. 12 end to end.  The real tier
runs ``TorchEmbedderBackend`` on ``--device``: the card (bge at its
published width) by default, or the host CPU (the reduced config).

    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.device_detector import DeviceInventory, detect
from repro_torch.core.estimator import estimate_depth
from repro_torch.core.routing import CPU, NPU, CascadePolicy, TierSpec
from repro_torch.core.simulator import PAPER_DEVICES, profile_fn_for
from repro_torch.core.windve import (ModeledBackend, TorchEmbedderBackend,
                                     WindVE, resolve_device)
from repro_torch.data.workload import make_queries
from repro_torch.models import embedder


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. model: the paper's bge-large-zh-v1.5 (reduced on the CPU)
    cfg = get_config("bge-large-zh-v1.5")
    if dev.type != "cuda":
        cfg = cfg.smoke()
    params = embedder.init_embedder(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    # 2. device detector (Algorithm 2): one modeled NPU + the real pool
    det = detect(DeviceInventory(npus=1, cpus=1))
    print(f"detector: main={det.device_main} aux={det.device_auxiliary}")

    # 3. queue depths via the linear-regression estimator (Eq. 12)
    npu_dev = PAPER_DEVICES["tesla-v100/bge"]
    c_npu, fit = estimate_depth(profile_fn_for(npu_dev), slo_s=1.0)
    print(f"estimator: alpha={fit.alpha:.4f} beta={fit.beta:.3f} "
          f"-> C_NPU={c_npu}")

    # 4. the engine: a TierSpec list + the paper's cascade policy
    #    (Algorithm 1 dispatch, per-tier worker threads)
    engine = WindVE(tiers=[
        TierSpec(NPU, c_npu,
                 backend=ModeledBackend(npu_dev, embed_dim=cfg.d_model)),
        TierSpec(CPU, 2,
                 backend=TorchEmbedderBackend(cfg, params, max_tokens=32,
                                              device=dev)),
    ], policy=CascadePolicy())

    # 5. a burst of queries
    queries = make_queries(c_npu + 4, cfg.vocab_size, length=24)
    futs = [engine.submit(payload=q, length=24) for q in queries]
    embs = [f.result(timeout=60) for f in futs if f is not None]
    stats = engine.stats
    print(f"accepted={stats.accepted} rejected={stats.rejected} "
          f"embedding dim={embs[0].shape[0]}")
    print(f"per-device: {stats.per_device}  p50={stats.p(50):.3f}s")
    engine.shutdown()
    return c_npu, stats, embs


if __name__ == "__main__":
    main()
