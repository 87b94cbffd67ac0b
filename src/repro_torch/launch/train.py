"""Training launcher of the PyTorch port: AdamW steps on synthetic tokens
for any preset, on the card by default (``--device cuda``) or on the CPU
(``--device cpu``). The flags are those of the JAX trainer, plus
``--device``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --smoke --steps 50 --batch 8 --seq 128 --ckpt /tmp/ck.msgpack
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
      --smoke --steps 3 --device cpu

A step is ``loss.backward()`` on ``Model.loss`` (the config's attention,
``reference`` unless overridden) and then ``adamw_update``. The checkpoint
(``--ckpt``) is ``{"params": ...}`` in the msgpack layout both packages
read.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.models import build_model
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.weights import torch_dtype


def make_batch_for(cfg, tokens):
    """LM batch -> family batch. The stub frontends' embeddings (vlm,
    encdec) are drawn from a ``torch.Generator`` seeded 0 at every call,
    so every step sees the same ones, as the JAX trainer's
    ``PRNGKey(0)`` draws are; the two draws differ by design, like the
    seeded weights."""
    B, S = tokens.shape
    dev = tokens.device

    def stub(n):
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((B, n, cfg.d_model), generator=g, device=dev)
        return x.to(torch_dtype(cfg.dtype)) * 0.02

    if cfg.family == "vlm":
        pos = torch.arange(S, device=dev)[None, None].expand(B, 3, S)
        return {"embeds": stub(S), "positions": pos, "labels": tokens}
    if cfg.family == "encdec":
        return {"audio_embeds": stub(cfg.encoder.n_frames), "tokens": tokens}
    return {"tokens": tokens}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; pass cpu "
                         "to run without a card)")
    return ap


def main(argv=None, cfg_override=None) -> dict:
    """Train; returns {"losses", "tok_per_s", "params"} (the last the
    trained parameters, as saved under ``--ckpt``)."""
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on "
                         "the CPU")
    cfg = cfg_override or (get_smoke_config(args.arch) if args.smoke
                           else get_config(args.arch))
    if cfg.family == "ssm":
        args.seq = max(args.seq - args.seq % cfg.ssm.chunk, cfg.ssm.chunk)
    if cfg.family == "encdec":
        # the decoder's learned positions stop at max_seq_len
        args.seq = min(args.seq, cfg.max_seq_len)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw_init(params)
    n_params = sum(p.numel() for p in params.values())
    print(f"[train] {cfg.arch_id} ({'smoke' if args.smoke else 'full'}) "
          f"params={n_params/1e6:.1f}M seq={args.seq} batch={args.batch} "
          f"device={dev}", flush=True)

    pipe = iter(SyntheticTokenPipeline(cfg.vocab_size, args.seq, args.batch,
                                       seed=1))
    losses, tok_s = [], 0.0
    t0 = time.perf_counter()
    for i in range(args.steps):
        tokens = torch.from_numpy(next(pipe)["tokens"]).to(dev)
        batch = make_batch_for(cfg, tokens)
        for p in params.values():
            p.requires_grad_(True)
        loss = model.loss(params, batch)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        params, opt = adamw_update({k: p.detach() for k, p in params.items()},
                                   grads, opt, lr=args.lr)
        losses.append(float(loss.detach()))
        tok_s = (i + 1) * args.batch * args.seq / (time.perf_counter() - t0)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"  step {i:4d} loss={losses[-1]:.4f} ({tok_s:.0f} tok/s)",
                  flush=True)
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    if args.ckpt:
        from repro_torch.checkpoint import save_checkpoint
        save_checkpoint(args.ckpt, {"params": params})
        print(f"[train] checkpoint -> {args.ckpt}")
    return {"losses": losses, "tok_per_s": tok_s, "params": params}


if __name__ == "__main__":
    main()
