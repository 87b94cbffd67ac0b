"""SSM and recurrent serving economics on the port's engine, the port's leg
of ``benchmarks/bench_ssm.py``.

Arrow's scheduling math assumes attention KV that grows O(L) with context:
migration cost, prefix-cache value and the pressure signals all scale with
tokens. A constant-state architecture (Mamba-2's SSD state) flips that: a
migration moves the same bytes whether the request holds 12 or 5000
context tokens. This bench serves the ``spike`` trace through the port's
``ArrowEngineCluster`` on the hand-written kernels (``attn_impl="hopper"``;
on the CPU their plain versions) and checks the claims end to end:

  * **state transfer is exact**: sampled streams are equal between a
    ``colocated`` run (no migration) and an ``arrow`` run whose every
    decode migrates prefill -> decode pool (asserted);
  * **O(1) migration**: every ``migration_log`` entry of the ssm arch
    carries the same bytes across differing context lengths (asserted),
    where the dense arch's bytes are proportional to context (asserted);
  * **replay**: re-running the migrating configuration with the same seed
    gives every sampled stream again (asserted);
  * **arrow_elastic**: the ssm arch serves the trace under the elastic
    policy (autoscaler bounds 1-3); a spawned instance builds no kernel.

Traffic: ``spike`` at rate scale 1.5 for 20 s (6 s with ``--smoke``),
sampled at temperature 0.7 / top-p 0.9, two instances of 8 slots x 160
positions, SLO(5 s, 2 s), weights from a ``torch.Generator`` seeded 0. On
the CPU the archs' smoke configs, on the card their full published
configs (``get_config``). The identity checks hold in float32 (the
default): in bf16 a row's bits follow its batch (the paged-decode split
plan and the GEMM algorithm depend on the batch size), so a migrated
stream can leave the colocated one at a near tie.

CSV contract: name,us_per_call,derived; a full run writes
``results/ssm.json`` beside this file.

  PYTHONPATH=src python -m repro_torch.bench.bench_ssm
  PYTHONPATH=src python -m repro_torch.bench.bench_ssm --smoke --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.bench.common import Timer, device_info, emit, save_json
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.autoscaler import AutoScalerConfig
from repro_torch.core.request import SamplingParams
from repro_torch.core.serving import replay_trace
from repro_torch.core.slo import SLO
from repro_torch.traces import load_trace

SSM_ARCH = "mamba2-370m"
DENSE_ARCH = "qwen3-1.7b"


def bench_config(arch: str, device, dtype=None):
    """The arch's smoke config on the CPU and its published one on the
    card, on the kernels, in ``dtype`` (default float32)."""
    dev = torch.device(device)
    cfg = get_smoke_config(arch) if dev.type == "cpu" else get_config(arch)
    return cfg.replace(attn_impl="hopper", dtype=dtype or "float32")


def serve(cfg, policy: str, *, rate: float, duration: float,
          autoscaler_cfg=None, device="cuda", params=None):
    """One engine run over the spike trace on two instances (one prefill,
    one decode), run seed 0: (report, migration_log, {rid: token
    tuple}). Sampled decoding (temperature 0.7) so the identity checks
    cover the replayable-sampling path, not only greedy argmax.
    ``params=None`` draws the weights from the run seed."""
    from repro_torch.engine import ArrowEngineCluster
    cluster = ArrowEngineCluster(
        cfg, n_instances=2, n_prefill=1, n_slots=8, capacity=160,
        slo=SLO(5.0, 2.0), policy=policy, seed=0,
        autoscaler_cfg=autoscaler_cfg, params=params, device=device)
    trace = load_trace("spike", rate_scale=rate, seed=0, duration=duration)
    for r in trace:
        r.sampling = SamplingParams(temperature=0.7, top_p=0.9, seed=None)
    replay_trace(cluster, trace)
    report = cluster.drain(timeout=600)
    streams = {h.req.rid: tuple(h.tokens)
               for h in cluster.handles.values()}
    return report, list(cluster.migration_log), streams


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=float, default=1.5)
    ap.add_argument("--duration", type=float, default=20.0,
                    help="trace duration in seconds (wall-clock: the engine "
                         "replays arrivals in real time)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    ap.add_argument("--dtype", default="float32",
                    help="float32 (default: the identity checks hold) or "
                         "bfloat16")
    ap.add_argument("--smoke", action="store_true", help="6 s trace")
    args = ap.parse_args(argv)
    if args.smoke:
        args.duration = min(args.duration, 6.0)
    from repro_torch.engine.instance import resolve_device
    dev = resolve_device(args.device)
    ssm = bench_config(SSM_ARCH, dev, args.dtype)
    dense = bench_config(DENSE_ARCH, dev, args.dtype)
    kw = dict(rate=args.rate, duration=args.duration, device=dev)
    name, power = device_info(dev)
    print(f"# {ssm.arch_id} and {dense.arch_id}, {args.dtype}, on {name}"
          + (f" ({power})" if power else ""))

    # ---- forced migration vs no migration: streams must be identical.
    # Under 'arrow' with a 1-prefill/1-decode split every request's decode
    # migrates (export_state/import_state); 'colocated' never migrates.
    with Timer() as t:
        _, log_m, streams_m = serve(ssm, "arrow", **kw)
    assert log_m, "arrow run produced no migrations: bench misconfigured"
    assert streams_m and all(len(s) > 0 for s in streams_m.values())
    _, log_c, streams_c = serve(ssm, "colocated", **kw)
    assert not log_c, "colocated run must not migrate"
    assert streams_m == streams_c, \
        "sampled streams diverged across forced migration"
    emit("ssm.spike.forced_migration", t.us,
         f"migrations={len(log_m)};identical=True;finished={len(streams_m)}")

    # ---- O(1) migration bytes in context length
    ssm_bytes = {m["bytes"] for m in log_m}
    ssm_ctx = {m["ctx_tokens"] for m in log_m}
    assert len(ssm_bytes) == 1, \
        f"ssm migration bytes must be constant, got {sorted(ssm_bytes)}"
    assert len(ssm_ctx) > 1, \
        "trace produced uniform context lengths; O(1) claim untested"
    emit("ssm.spike.migration_bytes", 0.0,
         f"bytes={next(iter(ssm_bytes))};"
         f"ctx_min={min(ssm_ctx)};ctx_max={max(ssm_ctx)};constant=True")

    # ---- replay: same trace + seed => identical sampled streams
    _, _, streams_r = serve(ssm, "arrow", **kw)
    assert streams_r == streams_m, "replay with same seed diverged"
    emit("ssm.spike.replay", 0.0, "identical=True")

    # ---- dense contrast: bytes grow proportionally with context
    _, log_d, _ = serve(dense, "arrow", **kw)
    assert log_d, "dense arrow run produced no migrations"
    per_tok = {m["bytes"] / m["ctx_tokens"] for m in log_d}
    assert max(per_tok) - min(per_tok) < 1e-9, \
        "dense migration bytes must be proportional to context tokens"
    emit("dense.spike.migration_bytes", 0.0,
         f"bytes_per_token={next(iter(per_tok)):.0f};"
         f"ctx_min={min(m['ctx_tokens'] for m in log_d)};"
         f"ctx_max={max(m['ctx_tokens'] for m in log_d)};linear=True")

    # ---- arrow_elastic on the spike trace
    with Timer() as t:
        rep_e, log_e, streams_e = serve(
            ssm, "arrow_elastic", **kw,
            autoscaler_cfg=AutoScalerConfig(min_instances=1,
                                            max_instances=3))
    emit("ssm.spike.arrow_elastic", t.us,
         f"attainment={rep_e.attainment:.3f};finished={len(streams_e)};"
         f"migrations={len(log_e)};"
         f"ups={rep_e.scaling.get('scale_ups', 0)};"
         f"downs={rep_e.scaling.get('scale_downs', 0)}")
    if not args.smoke:
        save_json("ssm", {
            "device": name, "power_limit": power, "dtype": args.dtype,
            "forced_migration": {"migrations": len(log_m),
                                 "finished": len(streams_m),
                                 "identical": True},
            "migration_bytes": {
                "ssm": {"bytes": next(iter(ssm_bytes)),
                        "ctx": sorted(ssm_ctx)},
                "dense": {"bytes_per_token": next(iter(per_tok)),
                          "ctx": sorted(m["ctx_tokens"] for m in log_d)}},
            "elastic": {"attainment": rep_e.attainment,
                        "migrations": len(log_e),
                        "scaling": rep_e.scaling}})


if __name__ == "__main__":
    main()
