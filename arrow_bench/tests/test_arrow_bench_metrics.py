"""Each metric's arithmetic on hand-made records: the censored TTFT, a
window that holds a stall, the token gaps, the rates, and the readers of
the profiled slice."""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from arrow_bench import peaks, work
from arrow_bench.bench import load_module
from arrow_bench.harness import Run
from arrow_bench.serve import Dispatch, Req
from arrow_bench.trace import Profile

BENCH = Path(__file__).resolve().parents[1]
DENSE = {"name": "d", "hidden_size": 64, "intermediate_size": 128,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "num_hidden_layers": 3, "vocab_size": 100}


def metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py", f"t_{name}")


def req(rid, due, times, out=None, prompt=10, done=True):
    r = Req(rid, due, np.ones(prompt, np.int32),
            out if out is not None else len(times), submitted=due)
    r.times = list(times)
    r.tokens = [1] * len(times)
    r.handle = SimpleNamespace(done=done, rejected=False)
    return r


def run_of(reqs, window=(10.0, 20.0), **kw):
    fam = load_module(BENCH / "families" / "dense.py", "t_dense")
    return Run(conf=kw.pop("conf", DENSE), mix={}, family=fam,
               window=window, slo=(1.0, 0.2), setup_s=12.5,
               requests=reqs, **kw)


def test_ttft_censored_by_the_window_and_a_stall():
    reqs = [req(0, 9.0, [9.5, 9.6]),              # due before the window
            req(1, 10.0, [10.5, 10.6]),           # 0.5 s
            req(2, 12.0, [12.1]),                 # 0.1 s
            req(3, 15.0, [], out=4, done=False),  # stalled: 5 s so far
            req(4, 19.0, [20.5], done=True)]      # landed after close: 1 s
    run = run_of(reqs)
    from arrow_bench import readers
    assert sorted(readers.ttfts(run)) == pytest.approx([0.1, 0.5, 1.0, 5.0])
    v = metric("ttft_p90_ms").read(run)
    assert v == pytest.approx(1e3 * np.percentile([0.1, 0.5, 1.0, 5.0], 90))


def test_token_gaps_rate_and_goodput():
    reqs = [req(0, 9.0, [9.5, 10.5, 10.7, 11.2]),     # gaps 1.0 .2 .5 in
            req(1, 12.0, [12.5, 12.6, 12.7]),          # good: ttft .5
            req(2, 13.0, [14.5, 14.6]),                # ttft 1.5: not good
            req(3, 16.0, [16.2, 19.0]),                # tpot 2.8: not good
            req(4, 18.0, [18.1, 18.2, 21.0], out=5, done=False)]
    run = run_of(reqs)
    from arrow_bench import readers
    gaps = sorted(readers.token_gaps(run))
    assert gaps == pytest.approx(sorted([1.0, 0.2, 0.5, 0.1, 0.1, 0.1,
                                         2.8, 0.1]))
    assert metric("itl_p95_ms").read(run) == pytest.approx(
        1e3 * np.percentile(gaps, 95))
    # tokens in [10, 20): 3 + 3 + 2 + 2 + 2
    assert metric("output_tok_s").read(run) == pytest.approx(12 / 10.0)
    # finished in the window within both SLOs: request 1 (request 0:
    # ttft .5, but a mean gap of .567 > .2)
    assert readers.good_in_window(run) == 1
    assert metric("setup_s").read(run) == 12.5


def test_migrated_bytes_and_pass_time():
    run = run_of([], migrations=[{"rid": 1, "ctx_tokens": 10, "bytes": 2e6},
                                 {"rid": 2, "ctx_tokens": 20, "bytes": 4e6}],
                 passes=[(9.0, 9.1, True), (10.0, 10.05, True),
                         (10.1, 10.102, False), (12.0, 12.15, True),
                         (19.0, 19.1, True), (20.0, 20.3, True)],
                 profile=Profile(start=18.0, end=20.0))
    assert metric("sched.migrated_mb_per_req").read(run) == pytest.approx(3)
    # worked passes in the window: 50, 150 and 100 ms
    assert metric("engine.pass_ms").read(run) == pytest.approx(100.0)
    assert metric("sched.migrated_mb_per_req").read(run_of([])) is None


def _slice_run():
    d1 = Dispatch(4, 256, [], [(0, 100, 128, False), (64, 30, 32, True)])
    d2 = Dispatch(4, 256, [50, 60], [])
    prof = Profile(start=18.0, end=20.0, events=[
        ("void flash_fwd_wgmma(CUtensorMap)", 18.1, 18.4),
        ("flash_fwd_merge", 18.4, 18.5),
        ("void paged_decode_split<__nv_bfloat16>(int)", 18.6, 18.8),
        ("paged_merge", 18.7, 19.0),          # overlaps the split
        ("gemm", 19.5, 19.6)])
    return run_of([], dispatches=[d1, d2], profile=prof,
                  spans=[(18.0, 18.05, "dispatch_step"),
                         (19.0, 19.5, "finalize_step"),
                         (19.1, 19.2, "migration")],
                  # engine time in the slice: 18.0-18.6 and 19.0-19.8
                  passes=[(17.5, 18.6, True), (18.6, 19.0, False),
                          (19.0, 19.8, True), (19.8, 20.5, False)])


def test_rooflines_mfu_and_idle_of_the_slice():
    run = _slice_run()
    H, Hk, D, L = 4, 2, 16, 3
    flash = L * sum(work.bound_s(*work.flash_chunk(w, o, H, Hk, D),
                                 peaks.BF16_FLOPS)
                    for o, w in ((0, 128), (64, 32)))
    assert metric("flash_attn_roofline").read(run) == pytest.approx(
        100 * flash / 0.4)
    paged = L * work.bound_s(*work.paged_decode([50, 60, 1, 1], H, Hk, D,
                                                256), peaks.BF16_FLOPS)
    assert metric("paged_attention_roofline").read(run) == pytest.approx(
        100 * paged / 0.5)
    fam = run.family
    flops = (fam.layer_flops(DENSE, 100, 100 * 101 // 2)
             + fam.layer_flops(DENSE, 30, 30 * 64 + 30 * 31 // 2)
             + fam.head_flops(DENSE)
             + fam.layer_flops(DENSE, 1, 50) + fam.layer_flops(DENSE, 1, 60)
             + 2 * fam.head_flops(DENSE))
    assert metric("model.step_mfu").read(run) == pytest.approx(
        100 * flops / (1.4 * peaks.BF16_FLOPS))
    # busy .1-.5, .6-1.0, 1.5-1.6 past 18; inside engine time: .4 + .1
    assert metric("device.idle_frac").read(run) == pytest.approx(
        1 - 0.5 / 1.4)
    idle = dict(run.profile.idle_by_host(run.spans))
    assert idle["dispatch_step"] == pytest.approx(0.1)    # 18.0-18.1
    assert idle["finalize_step"] == pytest.approx(0.5)    # 19.0-19.5
    assert idle["harness loop"] == pytest.approx(0.5)     # 18.5-18.6, 19.6-


def test_slice_readers_find_nothing_without_a_trace():
    run = run_of([])
    for name in ("flash_attn_roofline", "paged_attention_roofline",
                 "model.step_mfu", "device.idle_frac"):
        assert metric(name).read(run) is None
    # a slice with no call of the kernel: no reading, never 0
    run = _slice_run()
    run.profile.events = [e for e in run.profile.events
                          if "flash" not in e[0]]
    assert metric("flash_attn_roofline").read(run) is None
