"""Train a qwen3-family model for a few hundred steps on the synthetic
pipeline through the port's launcher (``repro_torch.launch.train``).

The default is the reduced config; ``--full-100m`` selects a ~100M
configuration (qwen3's geometry at 12 layers x 768, float32). Either way
the loss must fall.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 200 \\
          [--device cpu] [--ckpt path.msgpack]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.launch import train as train_launcher


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint path (default: none written)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    common = ["--steps", str(args.steps), "--ckpt", args.ckpt,
              "--device", args.device]
    if args.full_100m:
        cfg = get_config("qwen3-1.7b").replace(
            arch_id="qwen3-100m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
            dtype="float32")
        out = train_launcher.main(common + ["--batch", "4", "--seq", "512"],
                                  cfg_override=cfg)
    else:
        out = train_launcher.main(common + ["--arch", "qwen3-1.7b", "--smoke",
                                            "--batch", "8", "--seq", "128"])
    losses = out["losses"]
    assert sum(losses[-5:]) < sum(losses[:5]), "loss did not fall"
    return out


if __name__ == "__main__":
    main()
