"""Training entry point: real steps of the reference's train step on one device
or over a mesh, the reference's ``launch/train.py`` in PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --steps 20 --batch 8 --seq 128 --ckpt build/ck.npz [--device cpu]

``--device`` defaults to ``cuda``: the step then runs the port's kernels
forward and backward.  The CPU is used only when asked for
(``--device cpu``, the plain versions).  Params are fp32, seeded from
``--seed`` with torch's random numbers; compute is bf16.  The data is the
zipfian ``data.workload.TokenStream``; ``--resume`` restores params,
optimizer state and the stream's position from a checkpoint
(``steps.checkpoint``).

``train(production_mesh=True)`` trains over the reference's 16 x 16
production mesh (256 cards; fewer raise, naming both counts), and
``train(mesh=...)`` over a port ``launch.mesh.Mesh``: the params are placed
by ``steps.train.train_shardings`` and each step runs on the mesh's
positions (``models.tp``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import api
from repro_torch.parallel import sharding
from repro_torch.steps import checkpoint, inputs, optim
from repro_torch.steps.train import build_train_step, train_shardings


def train(arch: str, steps: int, batch: int, seq: int, smoke: bool = True,
          ckpt: str | None = None, resume: str | None = None,
          lr: float = 3e-4, log_every: int = 10, seed: int = 0,
          device: str = "cuda", production_mesh: bool = False, mesh=None):
    """Run ``steps`` train steps; returns (params, opt_state, losses).

    ``device`` holds the whole tree (default the card; the CPU only when
    asked for).  ``production_mesh`` takes the 16 x 16 production mesh
    over the visible cards, ``mesh`` a given one: the params are drawn on
    its first position's device and placed over it."""
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    shape = ShapeConfig("cli", seq_len=seq, global_batch=batch, kind="train")
    if production_mesh:
        mesh = make_production_mesh()
    elif mesh is None:
        mesh = make_host_mesh([torch.device(device)])
    dev = mesh.device_list[0]

    gen = torch.Generator(dev).manual_seed(seed)
    params = api.init_params(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in optim.tree_leaves(params))
    if mesh.size > 1:
        params = sharding.shard_tree(
            params, train_shardings(cfg, shape, mesh, params)[0][0],
            free=True)
    opt_state = optim.init(params)
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"batch={batch} seq={seq} steps={steps} on {mesh}")

    stream = inputs.train_stream(cfg, shape, seed)

    start = 0
    if resume:
        (params, opt_state), meta = checkpoint.load(resume,
                                                    (params, opt_state))
        start = int(meta.get("step", 0))
        stream.restore(start)
        print(f"[train] resumed from {resume} at step {start}")

    step_fn = build_train_step(cfg, shape, mesh, optim.AdamWConfig(lr=lr))
    losses = []
    t0 = time.time()
    for i in range(start, start + steps):
        params, opt_state, metrics = step_fn(params, opt_state, next(stream))
        losses.append(float(metrics["loss"]))
        if (i + 1) % log_every == 0 or i == start:
            dt = (time.time() - t0) / max(1, len(losses))
            print(f"  step {i+1}: loss={losses[-1]:.4f} "
                  f"ce={float(metrics['ce']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"({dt*1e3:.0f} ms/step)")
    if ckpt:
        checkpoint.save(ckpt, (params, opt_state),
                        {"step": start + steps, "arch": cfg.name})
        print(f"[train] checkpoint -> {ckpt}")
    return params, opt_state, losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="use the full (not smoke) config")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions)")
    args = ap.parse_args()
    train(args.arch, args.steps, args.batch, args.seq, smoke=not args.full,
          ckpt=args.ckpt, resume=args.resume, lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
