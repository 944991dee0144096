"""Queue-depth estimation walkthrough on the PyTorch port (paper §4.2.2 +
Fig. 4 + Table 3).

Profiles each calibrated device at a handful of concurrency points, fits
Eq. 12, derives the SLO-constrained queue depth, and compares against the
exhaustive stress test -- showing the estimator's profiling-cost advantage.
The devices are the paper's calibrated models, so no embedder runs.

    PYTHONPATH=src python examples/torch_estimate_depths.py --slo 2.0
"""
import argparse
from typing import List, Optional

from repro_torch.core.estimator import (estimate_depth, fine_tune_depth,
                                        stress_test_depth)
from repro_torch.core.simulator import PAPER_DEVICES, profile_fn_for


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slo", type=float, default=1.0)
    ap.add_argument("--model", choices=["bge", "jina"], default="bge")
    args = ap.parse_args(argv)

    print(f"SLO = {args.slo}s, model = {args.model}")
    print(f"{'device':20s} {'alpha':>8s} {'beta':>6s} {'reg':>5s} "
          f"{'stress':>7s} {'fine':>5s} {'profiles reg/stress':>20s}")
    for key, dev in PAPER_DEVICES.items():
        if not key.endswith("/" + args.model):
            continue
        calls = {"n": 0}

        def profile(c, _d=dev):
            calls["n"] += 1
            return profile_fn_for(_d, seed=9)(c)

        est, fit = estimate_depth(profile, args.slo)
        n_est = calls["n"]
        stress = stress_test_depth(profile, args.slo, step=8)
        n_stress = calls["n"] - n_est
        fine = fine_tune_depth(profile, args.slo, start=max(est, 1), radius=16)
        print(f"{key.split('/')[0]:20s} {fit.alpha:8.4f} {fit.beta:6.3f} "
              f"{est:5d} {stress:7d} {fine:5d} {n_est:>9d}/{n_stress}")


if __name__ == "__main__":
    main()
