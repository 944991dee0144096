#!/usr/bin/env python3
"""Time variants of a port kernel's CUDA source against each other on one
card, each held against the kernel's plain PyTorch version.

    python3 benchmarks/torch_kernel_variants.py --set w8a8 --parent DIR
    python3 benchmarks/torch_kernel_variants.py --set rmsnorm --parent DIR

A variant is a source file under ``src/repro_torch/csrc`` (this tree's, or
the parent tree's unpacked at ``--parent``) with literal substitutions
applied.  Each variant is built by ``nvcc`` into a library of its own under
``build/variants`` (ptxas output in ``variants_ptxas.log`` there) and bound
with the port's ctypes signatures.  At each shape of the main paths the
variants run in turns (in order, then in reverse), each time the median of
15 repetitions of 10 back-to-back launches behind a device-side sleep, as
``chip_smoke.py`` times kernels.  One JSON line a shape: each variant's two
times in ms and whether it matched the plain version (bit for bit for
w8a8_matmul; within rmsnorm's limits, 1e-4 / 2e-2 of the largest output in
fp32 / bf16).  Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
CSRC = os.path.join("src", "repro_torch", "csrc")
QM, RN = "quant_matmul.cu", "rmsnorm.cu"

# name -> (source file, substitutions, from the parent tree)
SETS = {
    "w8a8": {
        "parent": (QM, [], True),
        "tree": (QM, [], False),
        "64_row_tiles": (QM, [("big >= 2 * SMS ?", "false ?")], False),
        "128_row_tiles": (QM, [("big >= 2 * SMS ?", "true ?")], False),
        "3_stages": (QM, [("BK = 64, STAGES = 4", "BK = 64, STAGES = 3")],
                     False),
        "k_steps_of_128": (QM, [("BK = 64, STAGES = 4",
                                 "BK = 128, STAGES = 3")], False),
        # warps of 64 x 64: 4 a 128-row block, 2 a 64-row one
        "warps_64x64": (QM, [("constexpr int WM = 32, WN = 64;",
                              "constexpr int WM = 64, WN = 64;")], False),
    },
    "rmsnorm": {
        "parent": (RN, [], True),
        "tree": (RN, [], False),
        # the scale loaded after the sum of squares, as each chunk is scaled
        "late_scale": (RN, [
            ("        load_scale<C::V>(scale + c * C::V, sc[j]);\n", ""),
            ("      if (c < nc) scale_out<T, VEC>(held[j], sc[j], orow, c, "
             "inv);",
             "      if (c < nc) {\n"
             "        load_scale<C::V>(scale + c * C::V, sc[j]);\n"
             "        scale_out<T, VEC>(held[j], sc[j], orow, c, inv);\n"
             "      }")], False),
        "blocks_of_256": (RN, [("constexpr int BLOCK = 128;",
                                "constexpr int BLOCK = 256;")], False),
        "two_warps_a_row": (RN, [("  int tpr = 32;\n", "  int tpr = 64;\n")],
                            False),
    },
}


def build_variants(variants: dict, parent: str, out_dir: str) -> dict:
    from repro_torch.kernels import build

    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name, (src, subs, from_parent) in variants.items():
        base = parent if from_parent else ROOT
        text = open(os.path.join(base, CSRC, src)).read()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in {src}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
               cu, "-o", so]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    with open(os.path.join(out_dir, "variants_ptxas.log"), "w") as log:
        for name, so, proc in procs:
            text, _ = proc.communicate()
            log.write(f"== {name}\n{text}\n")
            if proc.returncode:
                raise SystemExit(f"nvcc failed on {name}:\n{text[-3000:]}")
            lib = ctypes.CDLL(os.path.abspath(so))
            for fn, argtypes in build.SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            regs = sorted({int(ln.split("Used ")[1].split()[0])
                           for ln in text.splitlines() if "Used " in ln})
            print(json.dumps({"variant": name, "registers": regs}),
                  flush=True)
            libs[name] = lib
    return libs


def time_ms(fn, reps: int = 15, inner: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def in_turns(libs: dict, launch, check) -> dict:
    """Each variant's two times (in order, then in reverse) and whether
    ``check`` held after its first launch."""
    import torch

    names = list(libs)
    res = {}
    for order in (names, names[::-1]):
        for name in order:
            def fn(lib=libs[name]):
                err = launch(lib)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            fn()
            torch.cuda.synchronize()
            res.setdefault(name, {"ok": check(), "ms": []})
            res[name]["ms"].append(time_ms(fn))
    return res


def w8a8_shapes(libs: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.quant_matmul import (quantize_activations,
                                                  w8a8_matmul_ref)

    rng = np.random.default_rng(4)
    stream = torch.cuda.current_stream().cuda_stream
    # bge-large-zh-v1.5's projections at 16 x 96 tokens, fp32 out (the
    # W8A8 policy's), and w_in with bf16 out
    for K, N, dt in ((1024, 1024, torch.float32), (1024, 4096, torch.float32),
                     (4096, 1024, torch.float32),
                     (1024, 4096, torch.bfloat16)):
        M = 1536
        x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).cuda()
        w8 = torch.from_numpy(rng.integers(-127, 128, (K, N))
                              .astype(np.int8)).cuda()
        s = torch.from_numpy((np.abs(rng.standard_normal(N)) * 0.01 + 1e-4)
                             .astype(np.float32)).cuda()
        x8, xs = quantize_activations(x)
        want = w8a8_matmul_ref(x8, w8, xs, s, out_dtype=dt)
        out = torch.empty((M, N), dtype=dt, device="cuda")
        code = 0 if dt == torch.float32 else 1
        res = in_turns(
            libs,
            lambda lib: lib.windve_w8a8_matmul(
                x8.data_ptr(), K, w8.data_ptr(), xs.data_ptr(), s.data_ptr(),
                out.data_ptr(), code, M, N, K, stream),
            lambda: bool(torch.equal(out, want)))
        print(json.dumps({"kernel": "w8a8_matmul", "M": M, "K": K, "N": N,
                          "out": str(dt), **res}), flush=True)


def rmsnorm_shapes(libs: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.rmsnorm import rmsnorm_ref

    rng = np.random.default_rng(5)
    stream = torch.cuda.current_stream().cuda_stream
    # hymba-1.5b's prefill (16 x 64 tokens) and decode rows
    for R, D in ((1024, 1600), (16, 1600)):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.standard_normal((R, D), np.float32) * 3
                                 ).cuda().to(dt)
            sc = torch.from_numpy(1 + 0.1 * rng.standard_normal(D)
                                  .astype(np.float32)).cuda()
            want = rmsnorm_ref(x, sc, 1e-5).float()
            tol = (1e-4 if dt == torch.float32 else 2e-2) \
                * want.abs().max().item()
            out = torch.empty_like(x)
            code = 0 if dt == torch.float32 else 1
            res = in_turns(
                libs,
                lambda lib: lib.windve_rmsnorm(
                    x.data_ptr(), D, sc.data_ptr(), out.data_ptr(), code, R,
                    D, 1e-5, stream),
                lambda: (out.float() - want).abs().max().item() <= tol)
            print(json.dumps({"kernel": "rmsnorm", "R": R, "D": D,
                              "dtype": str(dt), **res}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", choices=sorted(SETS), required=True)
    ap.add_argument("--parent", required=True,
                    help="the parent commit's tree, unpacked (git archive)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "variants"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    libs = build_variants(SETS[args.set], args.parent,
                          os.path.join(args.out, args.set))
    {"w8a8": w8a8_shapes, "rmsnorm": rmsnorm_shapes}[args.set](libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
