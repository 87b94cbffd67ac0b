"""End-to-end serving driver of the PyTorch port: a burst of requests
streams through the unified ServingSystem API into a 3-instance Arrow
cluster with real compute. The burst makes the SLO-aware scheduler flip a
decode instance into the prefill pool (Algorithm 1 + 3); the pool timeline
shows the elastic pools, and tokens are observed as they land (per-request
``on_token`` callbacks), so TTFT is measured at the stream.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_arrow [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core import Request
from repro_torch.core.pools import Pool
from repro_torch.core.slo import SLO, SchedulerConfig
from repro_torch.engine import ArrowEngineCluster


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_smoke_config("gemma-2b").replace(attn_impl="hopper")
    # one process runs the 3 instances in turn, so wall-clock latency is ~3x
    # a real deployment's; the TTFT SLO below is tight against the
    # *predicted* per-instance compute, which is what Algorithm 1 schedules
    cluster = ArrowEngineCluster(
        cfg, n_instances=3, n_prefill=1, n_slots=8, capacity=192,
        slo=SLO(ttft=0.08, tpot=5.0), chunk_tokens=64,
        sched_cfg=SchedulerConfig(max_running_tokens=1536,
                                  monitor_interval=0.05),
        device=args.device)

    timeline = []
    orig_tick = cluster.policy.on_monitor_tick

    def tick(now):
        orig_tick(now)
        timeline.append((now, {p.value: cluster.pools.members(p)
                               for p in Pool if cluster.pools.members(p)}))

    cluster.policy.on_monitor_tick = tick
    first_seen = {}

    def on_token(handle, tok, t):
        if handle.rid not in first_seen:
            first_seen[handle.rid] = t - handle.req.arrival
            print(f"  t={t:5.2f}s rid {handle.rid:2d} first token {tok}")

    rng = np.random.default_rng(1)
    handles = []
    for i in range(18):
        # the first 12 arrive nearly together with long-ish prompts, in the
        # tight 'interactive' tier; the tail is 'standard'
        offset = 0.01 * i if i < 12 else 0.4 + 0.05 * i
        prompt = rng.integers(1, cfg.vocab_size,
                              size=int(rng.integers(48, 160))).astype(np.int32)
        req = Request(rid=i, arrival=offset, input_len=len(prompt),
                      output_len=int(rng.integers(2, 8)))
        handles.append(cluster.submit(
            req, prompt=prompt, tier="interactive" if i < 12 else "standard",
            on_token=on_token))
    report = cluster.drain(timeout=240.0)

    print(report.summary())
    print("attainment by tier: " + " ".join(
        f"{k}={v:.2f}" for k, v in report.attainment_by_tier().items()))
    print(f"pool flips: {report.flip_detail['total']} "
          f"(D->P {report.flip_detail['d2p']}, P->D "
          f"{report.flip_detail['p2d']})")
    migrated = sum(1 for h in handles if h.req.decode_instance
                   not in (None, h.req.prefill_instance))
    print(f"state transfers between instances: {migrated}")
    streamed = sorted(first_seen.values())
    p50 = (f"{streamed[len(streamed) // 2] * 1e3:.0f}ms" if streamed
           else "n/a")
    print(f"TTFT observed at the stream: p50={p50}")
    print("\npool timeline (sampled):")
    for t, pools in timeline[::max(len(timeline) // 12, 1)]:
        print(f"  t={t:5.2f}s  "
              + "  ".join(f"{k}:{v}" for k, v in pools.items()))


if __name__ == "__main__":
    main()
