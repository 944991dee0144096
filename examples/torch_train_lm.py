"""Train a small LM end to end with the PyTorch port (data stream ->
remat'd train step -> AdamW -> checkpoint), the twin of
``examples/train_lm.py``: the same step builder the full-width
stablelm-1.6b runs through on the card.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 100 \
        [--device cpu] [--ckpt build/lm.npz]

No checkpoint is written unless ``--ckpt`` names a file.
"""
import argparse

from repro_torch.launch.train import train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    _, _, losses = train(args.arch, args.steps, args.batch, args.seq,
                         smoke=True, ckpt=args.ckpt, lr=1e-3, log_every=10,
                         device=args.device)
    n = min(10, len(losses))
    print(f"first-{n} mean loss {sum(losses[:n])/n:.3f} -> "
          f"last-{n} mean loss {sum(losses[-n:])/n:.3f}")


if __name__ == "__main__":
    main()
