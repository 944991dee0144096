#!/usr/bin/env python3
"""Time variants of a port kernel's CUDA source against each other on one
card, each held against the kernel's plain PyTorch version.

    python3 benchmarks/torch_kernel_variants.py --set w8a8 --parent DIR
    python3 benchmarks/torch_kernel_variants.py --set rmsnorm --parent DIR
    python3 benchmarks/torch_kernel_variants.py --set attention_fp32 --parent DIR
    python3 benchmarks/torch_kernel_variants.py --set ssm_scan --parent DIR
    python3 benchmarks/torch_kernel_variants.py --set quantize_rows --parent DIR

A variant is a source file under ``src/repro_torch/csrc`` (this tree's, or
the parent tree's unpacked at ``--parent``) with literal substitutions
applied.  Each variant is built by ``nvcc``, with its tree's ``common.cu``,
into a library of its own under
``build/variants`` (ptxas output in ``variants_ptxas.log`` there) and bound
with the port's ctypes signatures.  At each shape of the main paths the
variants run in turns (in order, then in reverse), each time the median of
15 repetitions of 10 back-to-back launches behind a device-side sleep, as
``chip_smoke.py`` times kernels.  One JSON line a shape: each variant's two
times in ms and whether it matched the plain version (bit for bit for
w8a8_matmul; within rmsnorm's limits, 1e-4 / 2e-2 of the largest output in
fp32 / bf16; fp32 attention within 1e-4 with zero rows where kv_len is 0;
the scan's y and h within 1e-4 of their largest magnitudes; quantize_rows
bit for bit, with ``x.to(torch.int8)`` timed beside it as a yardstick for
the same bytes).  Needs a card; exits non-zero without one.
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
FA, SS = "flash_attention.cu", "ssm_scan.cu"

# name -> (source file, substitutions, from the parent tree)
SETS = {
    "w8a8": {
        "parent": (QM, [], True),
        "tree": (QM, [], False),
        "64_row_tiles": (QM, [("big >= 2 * sms ?", "false ?")], False),
        "128_row_tiles": (QM, [("big >= 2 * sms ?", "true ?")], False),
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
    # fp32 attention through the exact bf16 split (the parent's is the
    # CUDA-core kernel)
    "attention_fp32": {
        "parent": (FA, [], True),
        "tree": (FA, [], False),
        "keys_64": (FA, [("static constexpr int BK = 32, STAGES = 1, "
                          "TERMS = 3;",
                          "static constexpr int BK = 64, STAGES = 1, "
                          "TERMS = 3;")], False),
        # each k-step's products added straight into the running sums
        "one_accumulator": (FA, [("constexpr bool FRESH = SPLIT;",
                                  "constexpr bool FRESH = false;")], False),
        "3_blocks_an_sm": (FA, [(
            "TERMS * Q_PLANE;\n"
            "  static constexpr int MIN_BLOCKS = HD <= 64 ? 4 : 2;",
            "TERMS * Q_PLANE;\n"
            "  static constexpr int MIN_BLOCKS = HD <= 64 ? 3 : 2;")], False),
    },
    "ssm_scan": {
        "parent": (SS, [], True),
        "tree": (SS, [], False),
        "chunk_8": (SS, [("constexpr int CHUNK = 16; ",
                          "constexpr int CHUNK = 8; ")], False),
        # the accurate expf (range reduction on the FMA pipe) for ex2
        "expf": (SS, [("\n                        * LOG2E\n", "\n"),
                      ("ex2(dtv * a[j])", "expf(dtv * a[j])")], False),
    },
    # the tree: a row held in registers by 1 (K 1024) or 4 (K 4096) warps,
    # x / s as x * (1 / s) with one FMA correction, rounding by an add
    "quantize_rows": {
        "parent": (QM, [], True),
        "tree": (QM, [], False),
        # the divide and the rounding of the parent, in the tree's layout
        "fdiv": (QM, [("    if (s >= 0x1p-100f && s <= FLT_MAX)",
                       "    if (false)")], False),
        "rintf": (QM, [("  return __float_as_uint(__fadd_rn(d, ROUNDER));",
                        "  return static_cast<unsigned>(static_cast<int>("
                        "rintf(d)));")], False),
        # K 4096 by one warp a row that reads the row twice, the second
        # time from L1 or L2
        "warp_a_row_rereads": (QM, [("constexpr int MAX_WPR = 8;",
                                     "constexpr int MAX_WPR = 1;")], False),
        # 4 chunks a lane: K 4096 by two warps a row
        "4_chunks_a_lane": (QM, [("constexpr int CPL = 2;",
                                  "constexpr int CPL = 4;")], False),
        # 8 values a lane a chunk: 8-byte stores, one 16-byte load of bf16
        "8_values_a_chunk": (QM, [("constexpr int VALS = 16;",
                                   "constexpr int VALS = 8;")], False),
        # the grid capped at 16 warps an SM, below the occupancy's wave
        "16_warps_an_sm": (QM, [("(long long)sms * per_sm * per_block",
                                 "(long long)sms * std::min(per_sm, 16 * 32"
                                 " / threads) * per_block")], False),
        # 64 warps an SM whatever the occupancy: more than one wave where
        # the kernel's registers hold fewer
        "64_warps_an_sm": (QM, [("(long long)sms * per_sm * per_block",
                                 "(long long)sms * (64 * 32 / threads)"
                                 " * per_block")], False),
    },
}


# lanes a channel the tree's scan is also timed under, beside the router's
# own choice (ssm_scan.ops.scan_lanes)
SSM_LANES = (2, 8)
# the parent's entry points: the scan before it took its lanes, attention
# before its optional lse output
PARENT_SIGNATURES = {"windve_ssm_scan": [ctypes.c_void_p] * 7
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                     "windve_flash_attention": [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 7 + [ctypes.c_int64] * 12
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p]}


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
               "-I", os.path.join(base, CSRC), cu,
               os.path.join(base, CSRC, "common.cu"), "-o", so]
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
            sigs = dict(build.SIGNATURES)
            if variants[name][2]:
                sigs.update(PARENT_SIGNATURES)
            for fn, argtypes in sigs.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            regs = sorted({int(ln.split("Used ")[1].split()[0])
                           for ln in text.splitlines() if "Used " in ln})
            print(json.dumps({"variant": name, "registers": regs}),
                  flush=True)
            lib.from_parent = variants[name][2]
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
    ``check`` held after its first launch.  ``libs``: name -> what
    ``launch`` takes (a variant's library, or a runner)."""
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


def attention_fp32_shapes(libs: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import attention_ref

    stream = torch.cuda.current_stream().cuda_stream
    # bge-large-zh-v1.5 at B 16 x S 96 with ragged rows; hymba-1.5b's
    # prefill (causal, window 1024, 25 heads on 5) at 64 tokens and at the
    # 1100-token prompt; (B, S, heads, hd) projections seen as (B, heads,
    # S, hd), as models.layers passes them
    for B, H, KV, S, causal, win, kv_len in (
            (16, 16, 16, 96, False, 0, [96, 75, 0, 48] * 4),
            (16, 25, 5, 64, True, 1024, [64] * 16),
            (2, 25, 5, 1100, True, 1024, [1100] * 2)):
        hd = 64
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal((B, S, n, hd),
                                                        np.float32))
                   .cuda().transpose(1, 2) for n in (H, KV, KV))
        kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        kw = dict(causal=causal, window=win, kv_len=kvl)
        want = attention_ref(q, k, v, **kw)
        out = torch.empty((B, S, H, hd), device="cuda").transpose(1, 2)
        empty = kvl == 0
        res = in_turns(
            libs,
            lambda lib: lib.windve_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl.data_ptr(),
                out.data_ptr(), *(() if lib.from_parent else (None,)), 0, B,
                H, KV, S, S, hd, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                int(causal), win, stream),
            lambda: ((out - want).abs().max().item() <= 1e-4
                     and bool((out[empty] == 0).all())))
        print(json.dumps({"kernel": "flash_attention", "B": B, "H": H,
                          "KV": KV, "S": S, "dtype": "float32", **res}),
              flush=True)


def ssm_scan_shapes(libs: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.ssm_scan import scan_lanes, ssm_scan_ref

    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # hymba-1.5b's prefill scan (B 16 x S 64, d_inner 3200), a small
    # off-tile one and the 1100-token prompt at B 2
    for B, S, DI, dt in ((16, 64, 3200, torch.bfloat16),
                         (16, 64, 3200, torch.float32),
                         (2, 50, 200, torch.bfloat16),
                         (2, 1100, 3200, torch.bfloat16),
                         (2, 1100, 3200, torch.float32)):
        N = 16
        rng = np.random.default_rng(6)
        x = torch.from_numpy(rng.standard_normal((B, S, DI), np.float32)
                             ).cuda().to(dt)
        dtv = torch.from_numpy(np.log1p(np.exp(rng.standard_normal(
            (B, S, DI)))).astype(np.float32)).cuda()
        Bm, Cm = (torch.from_numpy(rng.standard_normal((B, S, N), np.float32)
                                   ).cuda() for _ in range(2))
        A = torch.from_numpy(-np.broadcast_to(
            np.arange(1, N + 1, dtype=np.float32), (DI, N)).copy()).cuda()
        y_ref, h_ref = ssm_scan_ref(x, dtv, Bm, Cm, A)
        y = torch.empty((B, S, DI), device="cuda")
        h = torch.empty((B, DI, N), device="cuda")
        code = 0 if dt == torch.float32 else 1
        args = (x.data_ptr(), dtv.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                A.data_ptr(), y.data_ptr(), h.data_ptr(), code, B, S, DI)

        def run(lib, lanes=None):
            if lanes is None:                # the parent's entry point
                return lambda: lib.windve_ssm_scan(*args, stream)
            return lambda: lib.windve_ssm_scan(*args, lanes, stream)

        lanes = scan_lanes(B, DI, sms)
        runs = {name: run(lib, None if name == "parent" else lanes)
                for name, lib in libs.items()}
        for n in SSM_LANES:
            runs[f"tree_lanes{n}"] = run(libs["tree"], n)

        def close():
            return all((a - b).abs().max().item()
                       <= 1e-4 * b.abs().max().item()
                       for a, b in ((y, y_ref), (h, h_ref)))

        res = in_turns(runs, lambda fn: fn(), close)
        print(json.dumps({"kernel": "ssm_scan", "B": B, "S": S, "DI": DI,
                          "x_dtype": str(dt), "lanes": lanes, **res}),
              flush=True)


def quantize_rows_shapes(libs: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.quant_matmul import quantize_activations

    rng = np.random.default_rng(7)
    stream = torch.cuda.current_stream().cuda_stream
    # bge-large-zh-v1.5's projection inputs at 16 x 96 tokens (K 1024 for
    # q/k/v, wo and w_in; K 4096 for w_out) in fp32 (the W8A8 policy's) and
    # bf16, and 8x the rows, where each warp quantizes several in turn
    for M, K, dt in ((1536, 1024, torch.float32), (1536, 4096, torch.float32),
                     (1536, 1024, torch.bfloat16),
                     (12288, 1024, torch.float32)):
        x = torch.from_numpy(rng.standard_normal((M, K), np.float32)
                             ).cuda().to(dt)
        x[1] = 0
        want8, want_s = quantize_activations(x)
        x8 = torch.empty((M, K), dtype=torch.int8, device="cuda")
        s = torch.empty((M,), device="cuda")
        code = 0 if dt == torch.float32 else 1
        args = (x.data_ptr(), K, x8.data_ptr(), s.data_ptr(), code, M, K,
                stream)
        runs = {name: (lambda lib=lib: lib.windve_quantize_rows(*args))
                for name, lib in libs.items()}

        def yardstick():                 # the same bytes, not the function
            x8.copy_(x)
            return 0

        runs["yardstick_copy_to_int8"] = yardstick
        res = in_turns(runs, lambda fn: fn(),
                       lambda: bool(torch.equal(x8, want8)
                                    and torch.equal(s, want_s)))
        res["yardstick_copy_to_int8"]["ok"] = None    # another function
        print(json.dumps({"kernel": "quantize_rows", "M": M, "K": K,
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
    {"w8a8": w8a8_shapes, "rmsnorm": rmsnorm_shapes,
     "attention_fp32": attention_fp32_shapes,
     "ssm_scan": ssm_scan_shapes,
     "quantize_rows": quantize_rows_shapes}[args.set](libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
