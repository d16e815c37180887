"""End-to-end language-model training on the port (``repro_torch``).

Default: the reference example's small llama-family model (smollm's
family cut to 6 layers of d 384, vocab 2,048, float32: 10.2M parameters),
300 steps on the synthetic bigram stream; the loss must drop toward the stream's bigram entropy floor.
``--full`` trains the real ``smollm_360m`` config (the step is the same,
only the config changes).  It runs on the card; ``--device cpu`` runs it on
the host.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--full] [--device cpu]
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import get
from repro_torch.launch.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--layers", type=int, default=6, help="depth of the default model")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default a temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default the card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)

    cfg = get("smollm_360m")
    if not args.full:
        # the same family, trainable in minutes
        cfg = dataclasses.replace(
            cfg, n_layers=args.layers, d_model=384, n_heads=6, n_kv_heads=2, d_ff=1024,
            head_dim=64, vocab_size=2048, dtype="float32", attn_chunk=4096)
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, {args.steps} steps, "
          f"batch {args.batch_size} x {args.seq_len}")
    with tempfile.TemporaryDirectory() as tmp:
        metrics = train_loop(cfg, steps=args.steps, batch_size=args.batch_size,
                             seq_len=args.seq_len, ckpt_dir=args.ckpt_dir or tmp,
                             ckpt_every=100, lr=3e-3, log_every=20, device=args.device)
    n = min(10, len(metrics["losses"]) // 2)
    first = sum(metrics["losses"][:n]) / n
    last = sum(metrics["losses"][-n:]) / n
    print(f"loss: first{n}={first:.4f} last{n}={last:.4f} "
          f"bigram floor={metrics['bigram_floor']:.4f}")
    if not last < first - 0.5:
        raise SystemExit("loss did not drop")
    print("OK: loss dropped toward the bigram floor")


if __name__ == "__main__":
    main()
