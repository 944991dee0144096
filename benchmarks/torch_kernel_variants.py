#!/usr/bin/env python3
"""Time variants of a port kernel's CUDA source against each other on one
card, each held against the kernel's plain PyTorch version.

    python3 benchmarks/torch_kernel_variants.py --set w8a8 --parent DIR
    python3 benchmarks/torch_kernel_variants.py --set rmsnorm --parent DIR
    python3 benchmarks/torch_kernel_variants.py --set attention_fp32 --parent DIR
    python3 benchmarks/torch_kernel_variants.py --set ssm_scan --parent DIR
    python3 benchmarks/torch_kernel_variants.py --set ssm_scan_bwd --parent DIR
    python3 benchmarks/torch_kernel_variants.py --set quantize_rows --parent DIR
    python3 benchmarks/torch_kernel_variants.py --set attention_bwd --parent DIR
    python3 benchmarks/torch_kernel_variants.py --set rmsnorm_bwd --parent DIR

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
fp32 / bf16; attention within 1e-4 (fp32) or 2e-2 (bf16) with zero rows
where kv_len is 0;
the scan's y and h within 1e-4 of their largest magnitudes; quantize_rows
bit for bit, with ``x.to(torch.int8)`` timed beside it as a yardstick for
the same bytes; the backward kernels' gradients within 1e-4 of their
largest magnitudes in fp32 and at cosine 0.999 in bf16; the scan's
backward gradients within 1e-4 of their largest magnitudes, dx of a bf16 x
within 2^-7).  Needs a card;
exits non-zero without one.
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
FAB = "flash_attention_bwd.cu"

# the parent scan backward's reduce-scatter over n and its dx / ddt rows,
# up to the barrier that follows them
SSB_NSUMS_ROWS = """\
    // Reduce-scatter over the channel's 16 lanes, halves first: lane n ends
    // with step n's sums.
#pragma unroll
    for (int m = N_STATE / 2; m >= 1; m /= 2) {
      const bool upper = n & m;
#pragma unroll
      for (int j = 0; j < m; ++j) {
        const float k1 = upper ? v1[m + j] : v1[j];
        const float s1 = upper ? v1[j] : v1[m + j];
        const float k2 = upper ? v2[m + j] : v2[j];
        const float s2 = upper ? v2[j] : v2[m + j];
        v1[j] = k1 + __shfl_xor_sync(0xffffffffu, s1, m);
        v2[j] = k2 + __shfl_xor_sync(0xffffffffu, s2, m);
      }
    }
    sm.sdx[n][c] = s.dt[n][c] * v1[0];
    sm.sddt[n][c] = fmaf(to_f(s.x[n][c]), v1[0], v2[0]);
    __syncthreads();
    // dx and ddt rows: a thread an element of the (CHUNK, BWD_CH) tile
    for (int i = threadIdx.x; i < CHUNK * BWD_CH; i += BWD_THREADS) {
      const int t = i / BWD_CH, cc = i % BWD_CH, tt = t0 + t, dd = d0 + cc;
      if (tt < S && dd < DI) {
        from_f(sm.sdx[t][cc], dx[(row + tt) * DI + dd]);
        ddt[(row + tt) * DI + dd] = sm.sddt[t][cc];
      }
    }
"""

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
        # the accurate expf (range reduction on the FMA pipe) for ex2
        "expf": (SS, [("\n                        * LOG2E\n", "\n"),
                      ("ex2(dtv * a[j])", "expf(dtv * a[j])")], False),
    },
    # the scan's backward.  "parent" is the design of a thread a (channel,
    # state), 512-thread blocks; the "ablate_" variants take one part out
    # of the parent's kernel, so they compute wrong gradients by design and
    # are timed only, to split its time.  Those of the parent are made from
    # that design's text: under a later parent they are skipped.
    "ssm_scan_bwd": {
        "parent": (SS, [], True),
        "tree": (SS, [], False),
        # without the dB / dC partial pass over the block's channels
        "ablate_partials": (SS, [(
            "    for (int i = threadIdx.x; i < 2 * CHUNK * N_STATE; "
            "i += BWD_THREADS) {",
            "    for (int i = threadIdx.x; i < 0; i += BWD_THREADS) {")],
                            True),
        # without the reduce-scatter over n and the dx / ddt rows
        "ablate_nsums_rows": (SS, [(
            SSB_NSUMS_ROWS, "    __syncthreads();\n")], True),
        # without the recompute's and the reverse step's stores of the
        # terms over d
        "ablate_red_stores": (SS, [
            ("      sm.red[1][t][c * N_STATE + n] = s.dy[t][c] * hh[t + 1];"
             "   // dC's\n", ""),
            ("      sm.red[0][t][c * N_STATE + n] = g * (dtv * to_f(s.x[t]"
             "[c]));  // dB's\n", "")], True),
        # with two of the chunk's three barriers removed: a race
        "ablate_two_barriers": (SS, [
            ("    __syncthreads();\n    // dx and ddt rows",
             "    // dx and ddt rows"),
            ("    __syncthreads();   // the stage buffer, red and the rows "
             "are reused\n", "")], True),
        # the tree: 4 lanes a channel, 32 channels a block (128 threads),
        # a chunk's h_{t-1} in registers, registers for 4 blocks an SM;
        # each variant changes one of these
        "min_blocks_3": (SS, [("constexpr int BWD_MIN_BLOCKS = 4;",
                               "constexpr int BWD_MIN_BLOCKS = 3;")], False),
        # h_{t-1} in 16-byte rows of shared memory (3 blocks an SM by it)
        "hold_in_smem": (SS, [
            ("  __align__(16) float4 h0[BWD_THREADS];\n",
             "  __align__(16) float4 h0[BWD_THREADS];\n"
             "  __align__(16) float4 hh[CHUNK][BWD_THREADS];\n"),
            ("    float hr[CHUNK][NL];\n", ""),
            ("#pragma unroll\n        for (int j = 0; j < NL; ++j) "
             "hr[t][j] = h[j];\n",
             "        sm.hh[t][tid] = make_float4(h[0], h[1], h[2], h[3]);\n"),
            ("        float s1 = 0.f, s2 = 0.f;\n",
             "        const float4 h4 = sm.hh[t][tid];\n"
             "        float s1 = 0.f, s2 = 0.f;\n"),
            ("const float q = ge * hr[t][j];",
             "const float q = ge * at(h4, j);")], False),
        "ch16": (SS, [("constexpr int BWD_CH = 32;",
                       "constexpr int BWD_CH = 16;"),
                      ("constexpr int BWD_MIN_BLOCKS = 4;",
                       "constexpr int BWD_MIN_BLOCKS = 8;")], False),
        "ch64": (SS, [("constexpr int BWD_CH = 32;",
                       "constexpr int BWD_CH = 64;"),
                      ("constexpr int BWD_MIN_BLOCKS = 4;",
                       "constexpr int BWD_MIN_BLOCKS = 2;")], False),
        # the tree without one of its parts, timed only: the sums over the
        # warp's channels, the sums over n, the reverse step's exps
        "ablate_tree_channel_sums": (SS, [
            ("__shfl_xor_sync(0xffffffffu, v[u * 4 + 2 + r], 16)",
             "v[u * 4 + 2 + r]"),
            ("__shfl_xor_sync(0xffffffffu, v[u * 4 + 1], 8)", "v[u * 4 + 1]"),
            ("  reduce_scatter<GROUP / 2, 4, 4>(w, lane);\n", "")], False),
        "ablate_tree_nsums": (SS, [(
            "      reduce_scatter<GROUP, 2, 1>(sn, lane);\n", "")], False),
        "ablate_tree_exp": (SS, [(
            "          const float ge = g * ex2(dtv * a2[j]);",
            "          const float ge = g * a2[j];")], False),
        # without the block partials' global writes, or without the second
        # kernel that sums them
        "ablate_tree_flush": (SS, [("    if (t0 + t >= S) continue;",
                                    "    if (t0 + t >= 0) continue;")],
                              False),
        "ablate_tree_sums": (SS, [(
            "  ssm_scan_bwd_sums<<<blocks, 256, 0, st>>>(",
            "  if (B < 0) ssm_scan_bwd_sums<<<blocks, 256, 0, st>>>(")],
                             False),
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
    # the attention backward on the tensor cores (the parent's runs on the
    # CUDA cores)
    "attention_bwd": {
        "parent": (FAB, [], True),
        "tree": (FAB, [], False),
        # dK/dV read K's and V's fragments from shared memory at every hd
        "dkdv_kv_from_smem": (FAB, [(
            "static constexpr bool HOLD_DKDV = !SPLIT && HD <= 64;",
            "static constexpr bool HOLD_DKDV = false;")], False),
        # launch bounds of 2 blocks an SM at hd <= 64 (more registers)
        "2_blocks_an_sm": (FAB, [(
            ": (HD <= 64 ? 3 : 2);", ": (HD <= 64 ? 2 : 2);")], False),
        # walked tiles of 32 rows (half the shared memory a stage), or 64,
        # for every dtype and head dim
        "walk_32": (FAB, [("static constexpr int BT = SPLIT && HD == 128 ? "
                           "32 : 64;", "static constexpr int BT = 32;")],
                    False),
        "walk_64": (FAB, [("static constexpr int BT = SPLIT && HD == 128 ? "
                           "32 : 64;", "static constexpr int BT = 64;")],
                    False),
    },
    # the RMSNorm backward in one pass a row (the parent's takes a block's
    # rows one at a time)
    "rmsnorm_bwd": {
        "parent": (RN, [], True),
        "tree": (RN, [], False),
        # dscale summed by one thread a column over all the partials
        "one_thread_a_column": (RN, [
            ("    for (int p = warp; p < P; p += 8) s += part[(long long)p * D "
             "+ c];",
             "    for (int p = 8 * warp; p < P && warp == 0; ++p) "
             "s += part[(long long)p * D + c];")], False),
        # up to 8 chunks a thread before a row takes more threads
        "8_chunks_a_thread": (RN, [(
            "while (tpr < BWD_THREADS && tpr * 4 < nc) tpr *= 2;",
            "while (tpr < BWD_THREADS && tpr * 8 < nc) tpr *= 2;")], False),
    },
}


# lanes a channel the tree's scan is also timed under, beside the router's
# own choice (ssm_scan.ops.scan_lanes)
SSM_LANES = (2, 8)


def variant_source(name: str, base: str, src: str, subs: list,
                   from_parent: bool) -> str | None:
    """``src`` of the tree at ``base`` with ``subs`` applied in order.  A
    substitution whose text is missing stops the run for a variant of this
    tree, and gives None for one of the parent's: that variant was written
    for an older parent."""
    text = open(os.path.join(base, CSRC, src)).read()
    for old, new in subs:
        if old not in text:
            if from_parent:
                return None
            raise SystemExit(f"{name}: {old!r} not in {src}")
        text = text.replace(old, new)
    return text


def build_variants(variants: dict, parent: str, out_dir: str) -> dict:
    from repro_torch.kernels import build

    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name, (src, subs, from_parent) in variants.items():
        base = parent if from_parent else ROOT
        text = variant_source(name, base, src, subs, from_parent)
        if text is None:
            print(json.dumps({"variant": name, "skipped":
                              f"its text is not in {base}'s {src}"}),
                  flush=True)
            continue
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


SASS_OPS = ("LDS", "STS", "SHFL", "BAR", "MUFU", "FFMA", "FMUL", "FADD",
            "FSEL", "SEL", "LDG", "STG", "LDGSTS")


def sass_counts(so: str, kernel: str) -> list:
    """Static SASS instruction counts (``cuobjdump -sass``) of every
    function in ``so`` whose name contains ``kernel``: in the whole
    function and in its outermost loop (the span of its longest backward
    branch), by opcode (LDS.U.128 counts as LDS)."""
    import re

    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    insn = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                      r"([^;]*);")
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = [] if kernel in name else None
            continue
        m = insn.search(line)
        if name is not None and funcs.get(name) is not None and m:
            funcs[name].append((int(m.group(1), 16), m.group(3),
                                m.group(4)))
    out = []
    for name, ins in funcs.items():
        if not ins:
            continue
        loop = None                          # the longest backward branch
        for addr, op, rest in ins:
            tgt = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if tgt is None or int(tgt.group(1), 16) >= addr:
                continue
            span = (int(tgt.group(1), 16), addr)
            if loop is None or span[1] - span[0] > loop[1] - loop[0]:
                loop = span

        def count(span):
            c = {op: 0 for op in SASS_OPS}
            c["all"] = 0
            for addr, op, _ in ins:
                if span[0] <= addr <= span[1]:
                    c["all"] += 1
                    base = op.split(".")[0]
                    if base in c:
                        c[base] += 1
            return c

        out.append({"function": name,
                    "whole": count((ins[0][0], ins[-1][0])),
                    "loop": count(loop) if loop else None,
                    "loop_bytes": list(loop) if loop else None})
    return out


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
    # S, hd), as models.layers passes them.  bf16 is timed beside fp32.
    for (B, H, KV, S, causal, win, kv_len), dt in (
            (shape, dt) for shape in (
                (16, 16, 16, 96, False, 0, [96, 75, 0, 48] * 4),
                (16, 25, 5, 64, True, 1024, [64] * 16),
                (2, 25, 5, 1100, True, 1024, [1100] * 2))
            for dt in (torch.float32, torch.bfloat16)):
        hd = 64
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal((B, S, n, hd),
                                                        np.float32))
                   .cuda().to(dt).transpose(1, 2) for n in (H, KV, KV))
        kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        kw = dict(causal=causal, window=win, kv_len=kvl)
        want = attention_ref(q, k, v, **kw).float()
        out = torch.empty((B, S, H, hd), dtype=dt,
                          device="cuda").transpose(1, 2)
        empty = kvl == 0
        tol = 1e-4 if dt == torch.float32 else 2e-2
        res = in_turns(
            libs,
            lambda lib: lib.windve_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl.data_ptr(),
                out.data_ptr(), None, 0 if dt == torch.float32 else 1, B,
                H, KV, S, S, hd, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                int(causal), win, stream),
            lambda: ((out.float() - want).abs().max().item() <= tol
                     and bool((out[empty] == 0).all())))
        print(json.dumps({"kernel": "flash_attention", "B": B, "H": H,
                          "KV": KV, "S": S, "dtype": str(dt), **res}),
              flush=True)


def ssm_scan_shapes(libs: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import build
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

        def run(lib, lanes):
            if hasattr(lib, "windve_ssm_scan_bwd"):     # no chunk states
                return lambda: lib.windve_ssm_scan(*args[:7], None,
                                                   *args[7:], lanes, stream)
            # a tree before the scan's backward takes no chunk-state pointer
            lib.windve_ssm_scan.argtypes = [
                a for i, a in enumerate(build.SIGNATURES["windve_ssm_scan"])
                if i != 7]
            return lambda: lib.windve_ssm_scan(*args, lanes, stream)

        lanes = scan_lanes(B, DI, sms)
        runs = {name: run(lib, lanes) for name, lib in libs.items()}
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


def ssm_scan_bwd_shapes(libs: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.ssm_scan import scan_lanes, ssm_scan_bwd_ref

    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # hymba-1.5b's training scan (B 8 x S 512, d_inner 3200) in both x
    # dtypes, falcon-mamba-7b's d_inner 8192, the 1100-token prompt, and
    # chip_smoke's two small shapes (S and DI off the chunks and blocks)
    for B, S, DI, dt in ((8, 512, 3200, torch.bfloat16),
                         (8, 512, 3200, torch.float32),
                         (4, 512, 8192, torch.bfloat16),
                         (2, 1100, 3200, torch.bfloat16),
                         (3, 33, 130, torch.bfloat16),
                         (1, 1, 7, torch.bfloat16)):
        N = 16
        rng = np.random.default_rng(6)

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).cuda()

        x = t(rng.standard_normal((B, S, DI))).to(dt)
        dtv = t(np.log1p(np.exp(rng.standard_normal((B, S, DI)))))
        Bm, Cm = (t(rng.standard_normal((B, S, N))) for _ in range(2))
        A = t(-np.broadcast_to(np.arange(1, N + 1), (DI, N)))
        dy = t(rng.standard_normal((B, S, DI)))
        code = 0 if dt == torch.float32 else 1
        # the chunk states, from the tree's forward
        y = torch.empty((B, S, DI), device="cuda")
        h = torch.empty((B, DI, N), device="cuda")
        hs = torch.empty((B, -(-S // 16), DI, N), device="cuda")
        err = libs["tree"].windve_ssm_scan(
            x.data_ptr(), dtv.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), y.data_ptr(), h.data_ptr(), hs.data_ptr(), code, B,
            S, DI, scan_lanes(B, DI, sms), stream)
        if err:
            raise RuntimeError(f"forward: CUDA error {err}")
        want = ssm_scan_bwd_ref(x, dtv, Bm, Cm, A, dy)
        dA_part = torch.empty((B, DI, N), device="cuda")
        # each variant its own outputs, NaN until it writes them, so that
        # one that leaves an output unwritten does not pass on another's
        outs, parts, last = {}, {}, []
        for name, lib in libs.items():
            outs[name] = [torch.full(w.shape, float("nan"), dtype=w.dtype,
                                     device="cuda") for w in want]
            blocks = -(-DI // lib.windve_ssm_scan_bwd_channels())
            parts[name] = torch.empty((2, blocks, B, S, N), device="cuda")

        def run(name):
            lib, part = libs[name], parts[name]

            def fn():
                last[:] = [name]
                return lib.windve_ssm_scan_bwd(
                    x.data_ptr(), dtv.data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), A.data_ptr(), dy.data_ptr(), None,
                    hs.data_ptr(), *(o.data_ptr() for o in outs[name]),
                    part.data_ptr(), dA_part.data_ptr(), code, B, S, DI,
                    stream)
            return fn

        def close():
            for i, (g, w) in enumerate(zip(outs[last[0]], want)):
                g, w = g.float(), w.float()
                lim = 2.0 ** -7 if i == 0 and dt == torch.bfloat16 else 1e-4
                if not bool(torch.isfinite(g).all()) \
                        or (g - w).abs().max() > lim * w.abs().max():
                    return False
            return True

        res = in_turns({name: run(name) for name in libs}, lambda fn: fn(),
                       close)
        for name in res:
            if name.startswith("ablate_"):
                res[name]["wrong_by_design"] = True
        print(json.dumps({"kernel": "ssm_scan_bwd", "B": B, "S": S,
                          "DI": DI, "x_dtype": str(dt), **res}), flush=True)


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


def attention_bwd_shapes(libs: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_ref)

    stream = torch.cuda.current_stream().cuda_stream
    # chip_smoke's five shapes: stablelm-1.6b's training attention, GQA at
    # hd 128, a 256 window, a ragged kv_len with a row of none, whisper's
    # cross attention; (B, S, heads, hd) projections seen as (B, heads, S,
    # hd), as models.layers passes them
    for tag, B, H, KV, Sq, Sk, hd, causal, win, kv_len, dt in (
            ("stablelm_train", 8, 32, 32, 512, 512, 64, True, 0, None,
             torch.bfloat16),
            ("stablelm_train", 8, 32, 32, 512, 512, 64, True, 0, None,
             torch.float32),
            ("gqa_H64_KV8_hd128", 2, 64, 8, 1024, 1024, 128, True, 0, None,
             torch.bfloat16),
            ("gqa_H64_KV8_hd128", 2, 64, 8, 1024, 1024, 128, True, 0, None,
             torch.float32),
            ("window_256", 4, 16, 4, 1024, 1024, 64, True, 256, None,
             torch.bfloat16),
            ("ragged_kv_len0", 4, 16, 16, 256, 256, 64, False, 0,
             [256, 131, 0, 7], torch.bfloat16),
            ("whisper_cross", 16, 6, 6, 64, 1500, 64, False, 0, None,
             torch.bfloat16)):
        rng = np.random.default_rng(0)
        q, do = (torch.from_numpy(rng.standard_normal((B, Sq, H, hd),
                                                      np.float32))
                 .cuda().to(dt).transpose(1, 2) for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal((B, Sk, KV, hd),
                                                     np.float32))
                .cuda().to(dt).transpose(1, 2) for _ in range(2))
        kvl = torch.tensor(kv_len or [Sk] * B, dtype=torch.int32,
                           device="cuda")
        kw = dict(causal=causal, window=win, kv_len=kvl)
        o, lse = attention_ref(q, k, v, return_lse=True, **kw)
        lse = lse.float().contiguous()
        want = attention_bwd_ref(q, k, v, o, do, lse, **kw)
        grads = [torch.empty((B, S, n, hd), dtype=dt, device="cuda")
                 .transpose(1, 2) for n, S in ((H, Sq), (KV, Sk), (KV, Sk))]
        delta = torch.empty((B, H, Sq), device="cuda")
        strides = (ctypes.c_int64 * 24)(*(
            st for t in (q, k, v, o, do, *grads) for st in t.stride()[:3]))
        code = 0 if dt == torch.float32 else 1

        def close():
            for g, w in zip(grads, want):
                g, w = g.float().flatten(), w.float().flatten()
                if dt == torch.float32:
                    if (g - w).abs().max() > 1e-4 * w.abs().max():
                        return False
                elif w.abs().max() > 0 and torch.nn.functional \
                        .cosine_similarity(g, w, dim=0) < 0.999:
                    return False
            return True

        res = in_turns(
            libs,
            lambda lib: lib.windve_flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), kvl.data_ptr(),
                *(g.data_ptr() for g in grads), delta.data_ptr(), code, B, H,
                KV, Sq, Sk, hd, strides, int(causal), win, stream),
            close)
        print(json.dumps({"kernel": "flash_attention_bwd", "shape": tag,
                          "dtype": str(dt), **res}), flush=True)


def rmsnorm_bwd_shapes(libs: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_ref

    rng = np.random.default_rng(6)
    stream = torch.cuda.current_stream().cuda_stream
    # stablelm-1.6b's training rows (B 8 x S 512) at its d 2048 and at
    # internlm2's d 6144
    for R, D in ((4096, 2048), (4096, 6144)):
        for dt in (torch.bfloat16, torch.float32):
            x, dy = (torch.from_numpy(rng.standard_normal((R, D), np.float32)
                                      * 2).cuda().to(dt) for _ in range(2))
            sc = torch.from_numpy(1 + 0.1 * rng.standard_normal(D)
                                  .astype(np.float32)).cuda()
            want = rmsnorm_bwd_ref(x, sc, dy, 1e-5)
            dx = torch.empty_like(x)
            dscale = torch.empty((D,), device="cuda")
            part = torch.empty((2 * 132 * 4, D), device="cuda")
            code = 0 if dt == torch.float32 else 1

            def close():
                for g, w in zip((dx, dscale), want):
                    g, w = g.float().flatten(), w.float().flatten()
                    if dt == torch.float32:
                        if (g - w).abs().max() > 1e-4 * w.abs().max():
                            return False
                    elif torch.nn.functional.cosine_similarity(
                            g, w, dim=0) < 0.999:
                        return False
                return True

            res = in_turns(
                libs,
                lambda lib: lib.windve_rmsnorm_bwd(
                    x.data_ptr(), D, sc.data_ptr(), dy.data_ptr(), D,
                    dx.data_ptr(), dscale.data_ptr(), part.data_ptr(), code,
                    R, D, 1e-5, stream),
                close)
            print(json.dumps({"kernel": "rmsnorm_bwd", "R": R, "D": D,
                              "dtype": str(dt), **res}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", choices=sorted(SETS), required=True)
    ap.add_argument("--parent", required=True,
                    help="the parent commit's tree, unpacked (git archive)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "variants"))
    ap.add_argument("--only", metavar="NAMES",
                    help="comma-separated variants of the set to build and "
                         "time (default: all)")
    ap.add_argument("--sass", metavar="KERNEL",
                    help="also print static SASS instruction counts of each "
                         "variant's functions whose name contains KERNEL")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    out_dir = os.path.join(args.out, args.set)
    variants = SETS[args.set]
    if args.only:
        variants = {k: variants[k] for k in args.only.split(",")}
    libs = build_variants(variants, args.parent, out_dir)
    if args.sass:
        for name in libs:
            for row in sass_counts(os.path.join(out_dir, f"{name}.so"),
                                   args.sass):
                print(json.dumps({"sass": name, **row}), flush=True)
    {"w8a8": w8a8_shapes, "rmsnorm": rmsnorm_shapes,
     "attention_fp32": attention_fp32_shapes,
     "ssm_scan": ssm_scan_shapes,
     "ssm_scan_bwd": ssm_scan_bwd_shapes,
     "quantize_rows": quantize_rows_shapes,
     "attention_bwd": attention_bwd_shapes,
     "rmsnorm_bwd": rmsnorm_bwd_shapes}[args.set](libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
