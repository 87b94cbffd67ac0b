"""Quickstart of the PyTorch port: the public API in ~70 lines.

1. Build qwen3-1.7b's reduced config and weights from a seeded
   ``torch.Generator``.
2. Serve two requests through the Arrow scheduler on a 2-instance cluster
   (on the hand-written kernels; on the CPU their plain versions), watching
   a request's state migrate between stateless instances.
3. Take a few AdamW steps on the synthetic token pipeline with the pieces
   of ``repro_torch.launch.train`` (on the reference attention: the kernels
   have no backward).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import SLO, Request
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.engine import ArrowEngineCluster
from repro_torch.engine.instance import resolve_device
from repro_torch.launch.train import make_batch_for
from repro_torch.models import build_model
from repro_torch.optim import adamw_init, adamw_update


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ------------------------------------------------------------ 1. model
    cfg = get_smoke_config("qwen3-1.7b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev.type).manual_seed(0), dev)
    print(f"arch={cfg.arch_id} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"device={dev}")

    # ------------------------------------------------------------ 2. serve
    cluster = ArrowEngineCluster(cfg.replace(attn_impl="hopper"),
                                 n_instances=2, n_prefill=1, n_slots=4,
                                 capacity=128, slo=SLO(ttft=5.0, tpot=2.0),
                                 params=params, device=dev)
    rng = np.random.default_rng(0)
    handles = [cluster.submit(Request(rid=i, arrival=0.0, input_len=24,
                                      output_len=4),
                              prompt=rng.integers(1, cfg.vocab_size, 24)
                              .astype(np.int32)) for i in range(2)]
    report = cluster.drain(timeout=60.0)
    for h in handles:
        print(f"  request {h.rid}: prefill@inst{h.req.prefill_instance} -> "
              f"decode@inst{h.req.decode_instance}  tokens={list(h.tokens)}"
              f"  ttft={h.req.ttft * 1e3:.0f}ms")
    print(f"  {report.summary()}")

    # ------------------------------------------------------------ 3. train
    pipe = iter(SyntheticTokenPipeline(cfg.vocab_size, 64, 4, seed=1))
    opt = adamw_init(params)
    for i in range(5):
        tokens = torch.from_numpy(next(pipe)["tokens"]).to(dev)
        for p in params.values():
            p.requires_grad_(True)
        loss = model.loss(params, make_batch_for(cfg, tokens))
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        params, opt = adamw_update({k: p.detach() for k, p in params.items()},
                                   grads, opt, lr=1e-3)
        print(f"  train step {i}: loss={float(loss.detach()):.4f}")
    print("done.")


if __name__ == "__main__":
    main()
