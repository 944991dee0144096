"""End-to-end serving driver on the PyTorch port (the paper's kind of
workload).

Runs the SAME burst twice -- without offloading (the FlagEmbedding-style
baseline) and with WindVE offloading -- and prints the concurrency and cost
deltas (the paper's Table 1 experiment, on the real threaded engine).  The
primary tier is a modeled NPU; the offload tier runs ``TorchEmbedderBackend``
on ``--device``: the card (bge at its published width) by default, or the
host CPU (the reduced config).

With ``--three-tier`` the offload run adds a second, slower pool: the
topology is just one more ``TierSpec`` in the list, no engine changes.

    PYTHONPATH=src python examples/torch_serve_offload.py --device cpu \
        --queries 56
"""
import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.cost_model import peak_saving, throughput_uplift
from repro_torch.core.routing import CPU, NPU, TierSpec
from repro_torch.core.simulator import DeviceModel
from repro_torch.core.windve import (ModeledBackend, TorchEmbedderBackend,
                                     WindVE, resolve_device)
from repro_torch.data.workload import make_queries
from repro_torch.models import embedder

LENGTH = 24              # tokens a query


def run_engine(heter: bool, n_queries: int, cfg, real, slo: float,
               three_tier: bool = False):
    """One burst of ``n_queries`` through a modeled NPU, plus (``heter``)
    the ``real`` embedder backend at depth 2.  Returns (stats, wall
    seconds, the engine's max concurrency, the queries' token arrays, each
    query's vector or None where it was refused)."""
    # a fast modeled NPU + the real embedder
    npu = ModeledBackend(DeviceModel("npu", beta=0.05, b=0.01, a=0.0),
                         embed_dim=cfg.d_model)
    tiers = [TierSpec(NPU, int((slo - 0.05) / 0.01), backend=npu)]
    if heter:
        tiers.append(TierSpec(CPU, 2, backend=real))
    if heter and three_tier:
        # a little-core pool: modeled 2x slower than the big-core embedder
        little = ModeledBackend(DeviceModel("cpu-little", beta=0.1, b=0.12,
                                            a=0.0), embed_dim=cfg.d_model)
        tiers.append(TierSpec("CPU-little", 2, backend=little))
    engine = WindVE(tiers=tiers)
    queries = make_queries(n_queries, cfg.vocab_size, length=LENGTH)
    t0 = time.monotonic()
    futs = [engine.submit(payload=q, length=LENGTH) for q in queries]
    outs = [None if f is None else f.result(timeout=60) for f in futs]
    wall = time.monotonic() - t0
    stats = engine.stats
    engine.shutdown()
    return stats, wall, engine.max_concurrency, queries, outs


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=56)
    ap.add_argument("--slo", type=float, default=0.5)
    ap.add_argument("--three-tier", action="store_true",
                    help="offload run uses NPU + big-core + little-core pool")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("bge-large-zh-v1.5")
    if dev.type != "cuda":
        cfg = cfg.smoke()
    params = embedder.init_embedder(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    real = TorchEmbedderBackend(cfg, params, max_tokens=32, device=dev)

    base, wall_b, c_base, _, _ = run_engine(False, args.queries, cfg, real,
                                            args.slo)
    wind, wall_w, c_wind, _, _ = run_engine(True, args.queries, cfg, real,
                                            args.slo,
                                            three_tier=args.three_tier)

    print(f"baseline (no offload): C={c_base} accepted={base.accepted} "
          f"rejected={base.rejected} wall={wall_b:.2f}s")
    print(f"WindVE   (offload):    C={c_wind} accepted={wind.accepted} "
          f"rejected={wind.rejected} wall={wall_w:.2f}s "
          f"per-device={wind.per_device}")
    extra = c_wind - c_base
    print(f"concurrency +{throughput_uplift(c_base, extra)*100:.1f}%  "
          f"peak-provisioned cost saving "
          f"{peak_saving(c_base, extra)*100:.1f}%")
    return base, wind, c_base, c_wind


if __name__ == "__main__":
    main()
