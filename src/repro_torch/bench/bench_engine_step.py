"""Engine-step throughput of the PyTorch port: the fused step vs the legacy
(pre-fusion) per-rid path, the port's leg of
``benchmarks/bench_engine_step.py``.

Both modes replay the *same* burst of mixed prefill+decode work (same seed,
same prompts, same weights) through a real ``ArrowEngineCluster`` on the
hand-written kernels (``attn_impl="hopper"``; on the CPU their plain
versions):

  * legacy — the pre-fusion path: one decode over a full copy of the KV
    slabs, copied back, plus a token fetch per iteration; per prefill chunk
    a copy of the slot's cache and a host pos_map round trip; a
    per-request sampling sync at prefill completion; one chunk per pass.
  * fused  — the whole LocalScheduler plan (decode batch + every prefill
    chunk) written in place, with one device-to-host copy per instance
    pass.

Workload: the arch's smoke config, 2 instances x 8 slots x 128 positions,
chunk 32, prompts of 48-96 tokens and 8-24 new tokens, weights from seed 0.
Greedy streams must be identical across the two modes (checked first), and
fused tokens/s must be at least legacy's. Tokens/s counts prefill + decoded
tokens over the serving wall-clock, which ends in a device sync.

A full run appends a ``{pr, ...}`` entry, naming the device and the card's
power limit, to the ``trajectory`` of ``BENCH_torch_engine.json`` at the
repo root (``--out`` writes it elsewhere); ``--pr N`` labels the entry
(default: last recorded pr + 1; re-using a number replaces that entry).

  PYTHONPATH=src python -m repro_torch.bench.bench_engine_step
  PYTHONPATH=src python -m repro_torch.bench.bench_engine_step --smoke \\
      --device cpu
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

from repro_torch.bench.common import Timer, device_info, emit, sync
from repro_torch.configs import get_smoke_config
from repro_torch.core import SLO, Request

ROOT = pathlib.Path(__file__).resolve().parents[3]


def make_workload(cfg, n: int, seed: int = 0):
    """Mixed prefill+decode burst: prompts 48-96 tokens, 8-24 new tokens."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        prompt = rng.integers(1, cfg.vocab_size,
                              size=int(rng.integers(48, 97))).astype(np.int32)
        reqs.append((prompt, int(rng.integers(8, 25))))
    return reqs


def run_mode(cfg, params, reqs, mode: str, device):
    """One serving run in step mode ``mode``, after an untimed warm-up
    burst; returns (tokens/s, {rid: stream}, tokens)."""
    from repro_torch.engine import ArrowEngineCluster

    dev = torch.device(device)
    cluster = ArrowEngineCluster(cfg, n_instances=2, n_prefill=1, n_slots=8,
                                 capacity=128, slo=SLO(ttft=5.0, tpot=2.0),
                                 params=params, chunk_tokens=32,
                                 step_mode=mode, device=dev)
    # warm-up: pay kernel builds and first launches outside the window
    for i, (p, m) in enumerate(reqs[:2]):
        cluster.submit(Request(rid=10_000 + i, arrival=0.0,
                               input_len=len(p), output_len=m), prompt=p)
    cluster.drain(timeout=300.0)
    sync(dev)
    handles = [cluster.submit(Request(rid=i, arrival=0.0, input_len=len(p),
                                      output_len=m), prompt=p)
               for i, (p, m) in enumerate(reqs)]
    with Timer() as t:
        cluster.drain(timeout=600.0)
        sync(dev)
    streams = {h.rid: [tok for tok in h.tokens] for h in handles}
    tokens = sum(len(p) for p, _ in reqs) + sum(len(s) for s in streams.values())
    return tokens / max(t.s, 1e-9), streams, tokens


ENTRY_KEYS = ("pr", "tokens_total", "legacy_tokens_per_s",
              "fused_tokens_per_s", "speedup", "streams_identical",
              "device", "power_limit")


def check_trajectory(doc: dict) -> None:
    """Schema guard: every trajectory entry carries the full key set and
    the list is strictly monotone in ``pr``."""
    traj = doc.get("trajectory")
    assert isinstance(traj, list) and traj, \
        "BENCH_torch_engine.json: empty/missing trajectory"
    for e in traj:
        missing = [k for k in ENTRY_KEYS if k not in e]
        assert not missing, (f"BENCH_torch_engine.json: entry "
                             f"pr={e.get('pr')} missing {missing}")
    prs = [e["pr"] for e in traj]
    assert prs == sorted(prs) and len(set(prs)) == len(prs), \
        f"BENCH_torch_engine.json: trajectory prs not strictly monotone: {prs}"


def load_trajectory(path: pathlib.Path) -> dict:
    if not path.exists():
        return {"workload": None, "trajectory": []}
    doc = json.loads(path.read_text())
    check_trajectory(doc)
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    ap.add_argument("--pr", type=int, default=None,
                    help="trajectory label for this run; default = last "
                         "recorded pr + 1. Re-using a number replaces that "
                         "entry (re-measure after a noisy run)")
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "BENCH_torch_engine.json",
                    help="the trajectory file a full run appends to")
    ap.add_argument("--smoke", action="store_true",
                    help="small run: asserts stream identity and fused "
                         "tokens/s >= legacy's in the same run; skips the "
                         "JSON artifact")
    args = ap.parse_args(argv)

    from repro_torch.engine.instance import resolve_device
    from repro_torch.weights import init_params
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch).replace(attn_impl="hopper")
    params = init_params(cfg, torch.Generator(device=dev.type).manual_seed(0),
                         dev)
    n = 6 if args.smoke else args.requests
    reqs = make_workload(cfg, n)

    tps_legacy, streams_legacy, tokens = run_mode(cfg, params, reqs,
                                                  "legacy", dev)
    tps_fused, streams_fused, _ = run_mode(cfg, params, reqs, "fused", dev)

    assert streams_fused == streams_legacy, \
        "fused step changed greedy token streams vs the per-rid baseline"
    speedup = tps_fused / max(tps_legacy, 1e-9)
    name, power = device_info(dev)
    emit("engine_step_legacy_tokens_per_s", 1e6 / max(tps_legacy, 1e-9),
         f"{tps_legacy:.1f} tok/s")
    emit("engine_step_fused_tokens_per_s", 1e6 / max(tps_fused, 1e-9),
         f"{tps_fused:.1f} tok/s")
    emit("engine_step_fused_speedup", 0.0,
         f"{speedup:.2f}x on {name} ({power})")
    assert speedup >= 1.0, \
        f"fused step slower than the per-rid baseline ({speedup:.2f}x)"
    if args.smoke:
        print("engine-step smoke OK:", f"{speedup:.2f}x", file=sys.stderr)
        return

    doc = load_trajectory(args.out)
    doc["workload"] = {"arch": args.arch, "n_requests": n,
                       "prompt_tokens": "48-96", "new_tokens": "8-24",
                       "chunk_tokens": 32, "instances": 2, "n_slots": 8,
                       "capacity": 128, "seed": 0, "attn_impl": "hopper"}
    pr = args.pr if args.pr is not None else (
        max((e["pr"] for e in doc["trajectory"]), default=0) + 1)
    entry = {
        "pr": pr,
        "tokens_total": tokens,
        "legacy_tokens_per_s": tps_legacy,
        "fused_tokens_per_s": tps_fused,
        "speedup": speedup,
        "streams_identical": True,
        "device": name,
        "power_limit": power,
    }
    doc["trajectory"] = sorted(
        [e for e in doc["trajectory"] if e.get("pr") != pr] + [entry],
        key=lambda e: e["pr"])
    check_trajectory(doc)                 # never write a broken artifact
    args.out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"{args.out.name}[pr={pr}]: {tps_legacy:.1f} -> {tps_fused:.1f} "
          f"tok/s ({speedup:.2f}x on {name}, {power})", file=sys.stderr)


if __name__ == "__main__":
    main()
