"""Self-speculative decoding of the PyTorch port: the port's leg of
``benchmarks/bench_speculative.py``. On a seeded greedy decode burst the
speculative engine (k = 4) must beat sequential decode by >= 1.3x tokens/s
while holding draft acceptance >= 0.6.

The burst is greedy (temperature 0), so acceptance is a pure function of
how well the truncated-layer draft (the first half of the layers) tracks
the full model on the qwen3-1.7b smoke config with weights from seed 7.
Each accepted draft removes one full model pass and one device-to-host
round trip. Both modes run in one process on the same weights and
prompts, on the hand-written kernels (``attn_impl="hopper"``; on the CPU
their plain versions), and each mode gets an untimed warm-up burst first.
The content check (speculative streams equal the sequential ones) comes
before the throughput claim.

A modeled-speedup line from the simulator's ``SpeculationModel`` (the
port's cost model, with the card's profile) rides along, as in the JAX
bench, so the analytic model and the measured engine stay comparable.

  PYTHONPATH=src python -m repro_torch.bench.bench_speculative
  PYTHONPATH=src python -m repro_torch.bench.bench_speculative --smoke \\
      --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.bench.common import Timer, device_info, emit, save_json, sync
from repro_torch.configs import get_smoke_config
from repro_torch.core import SLO, Request
from repro_torch.sim import CostModel, SpeculationModel

SPEEDUP_FLOOR = 1.3
ACCEPT_FLOOR = 0.6
K_DRAFT = 4


def run_burst(cfg, params, *, speculate: int, n: int, out_len: int,
              rid_base: int, device):
    """``n`` greedy requests of 24 prompt tokens and ``out_len`` outputs,
    all due at once; returns (output tokens/s, report, handles)."""
    from repro_torch.engine import ArrowEngineCluster

    dev = torch.device(device)
    cluster = ArrowEngineCluster(cfg, n_instances=2, n_prefill=1, n_slots=8,
                                 capacity=128, slo=SLO(5.0, 2.0),
                                 params=params, seed=0, speculate=speculate,
                                 device=dev)
    rng = np.random.default_rng(0xBEE)
    handles = []
    for i in range(n):
        prompt = rng.integers(1, cfg.vocab_size, size=24).astype(np.int32)
        handles.append(cluster.submit(
            Request(rid=rid_base + i, arrival=0.0, input_len=24,
                    output_len=out_len), prompt=prompt))
    with Timer() as t:
        report = cluster.drain()
        sync(dev)
    assert report.n_finished == n
    tokens = sum(len(h.tokens) for h in handles)
    return tokens / t.s, report, handles


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small burst; same floors asserted")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    n, out_len = (4, 24) if args.smoke else (8, 64)

    from repro_torch.engine.instance import resolve_device
    from repro_torch.weights import init_params
    dev = resolve_device(args.device)
    cfg = get_smoke_config("qwen3-1.7b").replace(attn_impl="hopper")
    params = init_params(cfg, torch.Generator(device=dev.type).manual_seed(7),
                         dev)

    # untimed warm-ups: both step paths run before any timed window
    run_burst(cfg, params, speculate=0, n=2, out_len=8, rid_base=90_000,
              device=dev)
    run_burst(cfg, params, speculate=K_DRAFT, n=2, out_len=8,
              rid_base=91_000, device=dev)

    base_tps, _, base_h = run_burst(cfg, params, speculate=0, n=n,
                                    out_len=out_len, rid_base=0, device=dev)
    spec_tps, rep, spec_h = run_burst(cfg, params, speculate=K_DRAFT, n=n,
                                      out_len=out_len, rid_base=0,
                                      device=dev)
    accept = rep.speculation["acceptance"]
    speedup = spec_tps / base_tps

    # content check before the throughput claim: speculation must not have
    # changed a single token of the burst
    for b, s in zip(base_h, spec_h):
        assert list(b.tokens) == list(s.tokens), \
            f"rid {b.rid}: speculative stream diverged"

    mdl = SpeculationModel(k=K_DRAFT, accept=accept)
    cm = CostModel(cfg)
    ctx = [24 + out_len // 2] * n
    modeled = (cm.iteration_time([], ctx) * mdl.expected_emitted
               / cm.spec_iteration_time(ctx, mdl))
    name, power = device_info(dev)
    emit("speculative.baseline", 1e6 / base_tps, f"tok_s={base_tps:.1f}")
    emit("speculative.k4", 1e6 / spec_tps,
         f"tok_s={spec_tps:.1f} accept={accept:.2f} speedup={speedup:.2f} "
         f"modeled={modeled:.2f} on {name} ({power})")
    save_json("speculative", {
        "baseline_tok_s": base_tps, "spec_tok_s": spec_tps,
        "speedup": speedup, "acceptance": accept,
        "modeled_speedup": modeled, "k": K_DRAFT,
        "speculation": rep.speculation, "device": name,
        "power_limit": power})
    assert accept >= ACCEPT_FLOOR, (
        f"draft acceptance {accept:.2f} below {ACCEPT_FLOOR} — the "
        f"truncated-layer draft no longer tracks the full model")
    assert speedup >= SPEEDUP_FLOOR, (
        f"speculative speedup {speedup:.2f}x below {SPEEDUP_FLOOR}x "
        f"(base {base_tps:.1f} tok/s, spec {spec_tps:.1f} tok/s)")


if __name__ == "__main__":
    main()
