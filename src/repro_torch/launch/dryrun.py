"""Dry run: trace each (arch x shape) step on the meta device and write its
roofline record, the reference's ``launch/dryrun.py`` for the H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch hymba-1.5b] [--shape decode_32k] [--opt cache_f32=1] \\
        [--out build/dryrun.jsonl] [--mesh 16x16 | --multi-pod]

Every step is built by the port's own builders (``steps.train``,
``steps.serve``, ``steps.inputs``, ``steps.optim``) on params from
``models.api.param_shapes`` and run on meta tensors: shapes and dtypes
only, so nothing is allocated and no card is needed (it runs on the CPU
in seconds a step).  ``roofline.op_cost`` counts the aten ops the step
dispatches and the kernel calls its routers report, and
``roofline.analysis`` turns them into the H100's roofline terms.

The mesh counted is the one the port executes: one card (``"mesh":
"1"``).  The reference's production meshes (16x16, and 2x16x16 under
``--multi-pod``) split weights over ``model``, which the port does not
execute: asking for one raises ``NotImplementedError`` naming ROADMAP
Queue 1 item 6, and the CLI records that error for every combination.

A decode step is the one at position seq_len - 1: every slot of its
seq_len-deep cache holds a token.  The paper's two embedders run their
served forward (``models.embedder.embed``) as the prefill shape; they have
no train step and no decode step.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import perf_flags
from repro_torch.configs import (ARCH_MODULES, INPUT_SHAPES, get_config,
                                 get_shape, shape_supported)
from repro_torch.models import api, embedder
from repro_torch.roofline import analysis, op_cost
from repro_torch.steps import optim
from repro_torch.steps.inputs import cache_specs, input_specs
from repro_torch.steps.serve import build_decode_step, build_prefill_step
from repro_torch.steps.train import build_train_step

TP_ITEM = "ROADMAP.md Queue 1 item 6, tensor parallelism across cards"
MESHES = ("1", "16x16", "2x16x16")


def _check_mesh(mesh: str) -> None:
    if mesh not in MESHES:
        raise ValueError(f"mesh {mesh!r}: want one of {MESHES}")
    if mesh != "1":
        raise NotImplementedError(
            f"the {mesh} production mesh splits weights over the model axis; "
            f"the port executes one card only ({TP_ITEM})")


def build_step(cfg, shape):
    """(step, its meta arguments) of ``shape.kind`` for ``cfg``, as the
    dry run counts it: fp32 params and AdamW state for a train step, bf16
    params for a served one."""
    batch = input_specs(cfg, shape)
    if cfg.arch_type == "encoder":
        if shape.kind != "prefill":
            raise NotImplementedError(f"an encoder has no {shape.kind} step")
        params = api.param_shapes(cfg, torch.bfloat16)
        return (lambda p, b: embedder.embed(p, cfg, b["tokens"])), (params,
                                                                     batch)
    if shape.kind == "train":
        params = api.param_shapes(cfg, torch.float32)
        return build_train_step(cfg, shape), (params, optim.init(params),
                                              batch)
    params = api.param_shapes(cfg, torch.bfloat16)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape), (params, batch)
    cache = cache_specs(cfg, shape, cache_dtype=(
        torch.float32 if perf_flags.FLAGS.cache_f32 else torch.bfloat16))
    cache["pos"] = shape.seq_len - 1
    return build_decode_step(cfg, shape), (params, cache, batch)


def dry_run(arch: str, shape_name: str, *, mesh: str = "1",
            multi_pod: bool = False, verbose: bool = True,
            opt: str = "") -> Dict[str, Any]:
    """Trace one (arch x shape) step on the meta device, under the perf
    flags of ``opt`` (reset afterwards); return its record."""
    mesh = "2x16x16" if multi_pod else mesh
    _check_mesh(mesh)
    perf_flags.reset_flags()
    try:
        if opt:
            perf_flags.set_flags(**perf_flags.parse_opt(opt))
        return _record(arch, shape_name, mesh, verbose, opt)
    finally:
        perf_flags.reset_flags()


def _record(arch: str, shape_name: str, mesh: str, verbose: bool,
            opt: str) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh}
    if opt:
        rec["opt"] = opt
    ok, why = shape_supported(cfg, shape)
    if ok and cfg.arch_type == "encoder" and shape.kind == "train":
        ok, why = False, "encoder-only arch has no train step"
    if not ok:
        rec["skipped"] = why
        return rec

    t0 = time.time()
    step, args = build_step(cfg, shape)
    cost = op_cost.analyse_step(step, *args)
    rec["lower_s"] = round(time.time() - t0, 2)
    rec["memory"] = {
        "argument_size_in_bytes": op_cost.tree_bytes(args),
        "output_size_in_bytes": cost.output_bytes,
        "temp_size_in_bytes": cost.peak_temp_bytes}
    params_shape = args[0]
    mf = analysis.model_flops(cfg, shape, params_shape)
    roof = analysis.analyse(cost, 1, mf)
    rec["roofline"] = roof.as_dict()
    rec["kernel_calls"] = dict(sorted(cost.kernel_calls.items()))
    counts = analysis.count_params(
        params_shape,
        (cfg.experts_per_token / cfg.num_experts) if cfg.is_moe else None)
    rec["params_total"] = counts["total"]
    rec["params_active"] = counts["active"]
    if verbose:
        print(f"  trace={rec['lower_s']}s ops={cost.ops} "
              f"dominant={roof.dominant} "
              f"t_comp={roof.compute_s*1e3:.2f}ms "
              f"t_mem={roof.memory_s*1e3:.2f}ms "
              f"t_coll={roof.collective_s*1e3:.2f}ms "
              f"useful={roof.useful_ratio:.2f}", flush=True)
    return rec


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(
        description="dry run on the meta device (trace + roofline)")
    ap.add_argument("--arch", default=None,
                    help="arch id (default: every registered config)")
    ap.add_argument("--shape", default=None,
                    help="input shape (default: all four)")
    ap.add_argument("--mesh", default="1", choices=MESHES,
                    help="1 (one card, the port's) or a production mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 production mesh")
    ap.add_argument("--out", default="build/dryrun.jsonl",
                    help="JSON lines, appended (build/ is git-ignored)")
    ap.add_argument("--opt", default="",
                    help="perf flags, e.g. 'cache_f32=1,remat_policy=dots'")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_MODULES)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    mesh = "2x16x16" if args.multi_pod else args.mesh
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    for arch in archs:
        for shape in shapes:
            print(f"[dryrun] {arch} x {shape} x {mesh}", flush=True)
            try:
                rec = dry_run(arch, shape, mesh=mesh, opt=args.opt)
            except Exception:
                rec = {"arch": arch, "shape": shape, "mesh": mesh,
                       "error": traceback.format_exc(limit=20)}
                print(rec["error"], flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
