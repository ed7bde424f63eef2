"""End-to-end LM training on the PyTorch port (the port of
``examples/train_lm.py``, same arguments plus ``--device``).

Trains a reduced-config model from the assigned pool for a few hundred
steps on the synthetic step-keyed pipeline, with checkpointing — the same
code path as ``python -m repro_torch.launch.train``.  On the card unless
``--device cpu``.

    PYTHONPATH=src python examples/torch_train_lm.py --arch smollm-135m --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --steps 20 --device cpu
"""

import argparse

from repro_torch.launch.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full (not reduced) config")
    ap.add_argument("--checkpoint-dir", default="ckpt_example")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    metrics = train_loop(
        arch=args.arch,
        reduced=not args.full_size,
        steps=args.steps,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
        lr=1e-3,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=50,
        log_every=20,
        device=args.device,
    )
    n = min(10, len(metrics))
    first = sum(m["loss"] for m in metrics[:n]) / max(n, 1)
    last = sum(m["loss"] for m in metrics[-n:]) / max(n, 1)
    print(f"mean loss: first {n} steps {first:.4f} -> last {n} steps "
          f"{last:.4f}")


if __name__ == "__main__":
    main()
