"""Chip smoke test of the PyTorch port: builds the Hopper kernels, holds
each against its plain-torch version at the main path's shapes, runs
full-width qwen3-1.7b (28 layers, bf16, seeded random weights) through the
kernel path against the reference path, then serves 8 requests through
``ArrowEngineCluster`` (2 instances, Arrow policy, prefill -> decode KV
migration) on the kernels and checks that every kernel of the path ran.

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc. TF32 is switched off for float32 matmuls and
convolutions, so float32 comparisons are full precision. Exits non-zero on
any failure; the last line of standard output is the result JSON.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BF16_TOL = 2e-2          # kernel vs plain, bf16 inputs (tests/test_kernels.py)
LOGIT_TOL = 5e-2         # model logits, hopper vs reference, x max|ref|
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM at 700 W


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def time_ms(fn, arg_sets, iters: int):
    """Per-call times of ``fn(*args)`` over ``iters`` calls, cycling through
    ``arg_sets`` (copies of the inputs whose total exceeds the 50 MB L2, so
    each call reads its inputs from device memory). Returns (device_ms,
    call_ms): the device time of every kernel the calls launched, summed by
    torch.profiler, and the CUDA-event time between the first call and the
    last, which also holds any host overhead that left the device idle."""
    from torch.profiler import ProfilerActivity, profile
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    if device_us <= 0:
        raise AssertionError("torch.profiler saw no device time")
    return device_us / 1e3 / iters, call_ms


def copies(tensors, min_total=160 << 20, cap=64):
    per = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, min(cap, math.ceil(min_total / per)))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def within(got, want, tol=BF16_TOL) -> bool:
    """allclose with atol = rtol = ``tol``, as tests/test_kernels.py."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= tol + tol * w.abs()).all())


# ------------------------------------------------------------- kernels


def check_kernels(cfg):
    """Each kernel vs its plain version on the card, at the main path's
    shapes: flash_seq at the profiling pass's longest prompt (S=128),
    flash_chunk for a 256-token chunk at offset 512 of a 1024-slot cache,
    paged decode over 8 slots of 1024 with lengths from 1 to 1024."""
    import torch.nn.functional as F

    from repro_torch.kernels import (flash_chunk_op, flash_seq_op,
                                     paged_attention_op)
    from repro_torch.kernels.flash_prefill import flash_prefill_ref
    from repro_torch.kernels.paged_attention import paged_attention_ref

    dev = torch.device("cuda")
    H, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    def sdpa(q, k, v, mask=None, causal=False):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              is_causal=causal,
                                              enable_gqa=True)

    def to_bhsd(t):
        return t.transpose(1, 2).contiguous()

    rows = []

    # flash_seq: whole-prompt prefill, q_offset = 0
    S = 128
    q, k, v = rnd(1, S, H, D), rnd(1, S, Hk, D), rnd(1, S, Hk, D)
    got = flash_seq_op(q, k, v)
    want = flash_prefill_ref(to_bhsd(q), to_bhsd(k), to_bhsd(v)
                             ).transpose(1, 2)
    torch.cuda.synchronize()
    pairs = S * (S + 1) // 2
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
    sets = copies([q, k, v])
    lib_sets = [tuple(to_bhsd(t) for t in s) for s in sets]
    rows.append(dict(
        name="flash_prefill", wrapper=flash_seq_op,
        source="src/repro_torch/kernels/flash_prefill/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_prefill/flash_prefill.py:134",
        shape=f"q(1,{S},{H},{D}) kv(1,{S},{Hk},{D}) bf16 causal",
        max_abs_err=max_err(got, want), ok=within(got, want),
        ms=time_ms(lambda a, b, c: flash_seq_op(a, b, c), sets, 200),
        plain_ms=time_ms(lambda a, b, c: flash_prefill_ref(a, b, c),
                         lib_sets, 50),
        library_ms=time_ms(lambda a, b, c: sdpa(a, b, c, causal=True),
                           lib_sets, 200),
        bound=bound(nbytes, 4.0 * D * H * pairs)))

    # flash_chunk: a 256-token chunk at offset 512 against the whole cache
    C, Sq, off = 1024, 256, 512
    q, kc, vc = rnd(1, Sq, H, D), rnd(1, C, Hk, D), rnd(1, C, Hk, D)
    got = flash_chunk_op(q, kc, vc, off)
    want = flash_prefill_ref(to_bhsd(q), to_bhsd(kc), to_bhsd(vc),
                             q_offset=off).transpose(1, 2)
    torch.cuda.synchronize()
    T = off + Sq
    pairs = Sq * off + Sq * (Sq + 1) // 2
    nbytes = 2 * (2 * q.numel() + 2 * T * Hk * D)
    sets = copies([q, kc, vc])
    qpos = torch.arange(Sq, device=dev)[:, None] + off
    mask = torch.arange(T, device=dev)[None, :] <= qpos
    lib_sets = [(to_bhsd(a), to_bhsd(b[:, :T]), to_bhsd(c[:, :T]))
                for a, b, c in sets]
    plain_sets = [tuple(to_bhsd(t) for t in s) for s in sets]
    rows.append(dict(
        name="flash_prefill_dyn", wrapper=flash_chunk_op,
        source="src/repro_torch/kernels/flash_prefill/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_prefill/flash_prefill.py:193",
        shape=f"q(1,{Sq},{H},{D}) at offset {off}, kv(1,{C},{Hk},{D}) bf16",
        max_abs_err=max_err(got, want), ok=within(got, want),
        ms=time_ms(lambda a, b, c: flash_chunk_op(a, b, c, off), sets, 200),
        plain_ms=time_ms(lambda a, b, c: flash_prefill_ref(
            a, b, c, q_offset=off), plain_sets, 50),
        library_ms=time_ms(lambda a, b, c: sdpa(a, b, c, mask=mask),
                           lib_sets, 200),
        bound=bound(nbytes, 4.0 * D * H * pairs)))

    # paged decode: 8 slots x 1024 positions viewed as 8 pages of 128
    B, page = 8, 128
    MP = C // page
    lengths_l = [1, 100, 257, 400, 512, 700, 731, 1024]
    qd = rnd(B, H, D)
    kp, vp = rnd(B * MP, page, Hk, D), rnd(B * MP, page, Hk, D)
    pt = (torch.arange(B, device=dev)[:, None] * MP
          + torch.arange(MP, device=dev)[None, :]).to(torch.int32)
    ln = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    got = paged_attention_op(qd, kp, vp, pt, ln)
    want = paged_attention_ref(qd, kp, vp, pt, ln)
    # a general page table (pages shuffled) gives the same answer
    perm = torch.randperm(B * MP, generator=g, device=dev)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(B * MP, device=dev)
    got_perm = paged_attention_op(qd, kp[perm].contiguous(),
                                  vp[perm].contiguous(),
                                  inv[pt.long()].to(torch.int32), ln)
    torch.cuda.synchronize()
    live = sum(lengths_l)
    nbytes = 2 * (2 * qd.numel() + 2 * live * Hk * D) + 4 * (pt.numel() + B)
    sets = copies([qd, kp, vp])
    pos = torch.arange(C, device=dev)
    dmask = (pos[None, :] < ln[:, None].long())[:, None, None, :]
    lib_sets = [(a[:, :, None], b.view(B, C, Hk, D).transpose(1, 2)
                 .contiguous(), c.view(B, C, Hk, D).transpose(1, 2)
                 .contiguous()) for a, b, c in sets]
    rows.append(dict(
        name="paged_attention", wrapper=paged_attention_op,
        source=("src/repro_torch/kernels/paged_attention/csrc/"
                "paged_attention.cu"),
        replaces="src/repro/kernels/paged_attention/paged_attention.py:106",
        shape=f"q({B},{H},{D}) pages({B * MP},{page},{Hk},{D}) bf16, "
              f"lengths {lengths_l}",
        max_abs_err=max(max_err(got, want), max_err(got_perm, want)),
        ok=within(got, want) and within(got_perm, want),
        ms=time_ms(lambda a, b, c: paged_attention_op(a, b, c, pt, ln),
                   sets, 200),
        plain_ms=time_ms(lambda a, b, c: paged_attention_ref(
            a, b, c, pt, ln), sets, 50),
        library_ms=time_ms(lambda a, b, c: sdpa(a, b, c, mask=dmask),
                           lib_sets, 200),
        bound=bound(nbytes, 4.0 * D * H * live)))

    for r in rows:
        b_ms, b_by = r.pop("bound")
        call = {k: r[k][1] for k in ("ms", "plain_ms", "library_ms")}
        r.update({k: r[k][0] for k in call})
        r.update(bound_ms=b_ms, bound_by=b_by, route="cuda")
        log({"kernel_check": r["name"], "shape": r["shape"],
             "max_abs_err": r["max_abs_err"],
             "tol": f"atol=rtol={BF16_TOL}", "within_tol": r["ok"],
             "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": r["library_ms"], "library": "sdpa",
             "per_call_event_ms": call})
        if not r.pop("ok"):
            raise AssertionError(f"{r['name']}: kernel differs from its "
                                 f"plain version by {r['max_abs_err']}")
    return rows


def check_sampler():
    """The sampler's threefry keys are integer arithmetic: on the card they
    equal the CPU's bit for bit; the Gumbel noise agrees to float32
    rounding."""
    from repro_torch.engine import prng
    seeds = np.array([0, 7, 77, 2**31 - 1])
    keys = {}
    for d in ("cpu", "cuda"):
        k = prng.fold_in(prng.fold_in(prng.prng_key(seeds, device=d), 5), 9)
        keys[d] = (k.cpu(), prng.gumbel(k, 151936).cpu())
    if not torch.equal(keys["cpu"][0], keys["cuda"][0]):
        raise AssertionError("threefry keys differ between cuda and cpu")
    err = max_err(keys["cpu"][1], keys["cuda"][1])
    if not err <= 1e-5:
        raise AssertionError(f"gumbel noise differs by {err}")
    log({"sampler_check": "threefry keys equal, gumbel max_abs_err",
         "value": err})


# --------------------------------------------------------------- model


def check_model(cfg, params, dev="cuda"):
    """Full-width forward_seq / prefill_chunk / decode_step logits with the
    kernels vs the reference attention, on the same weights and tokens."""
    from repro_torch.models import dense

    dev = torch.device(dev)
    rng = np.random.default_rng(3)
    S, C, Sq = 512, 1024, 256
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(1, S))
                              .astype(np.int32)).to(dev)
    chunk = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(1, Sq))
                             .astype(np.int32)).to(dev)
    nxt = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(1, 1))
                           .astype(np.int32)).to(dev)
    out = {}
    for impl in ("reference", "hopper"):
        c = cfg.replace(attn_impl=impl)
        x = dense.embed_tokens(c, params, prompt)
        l_seq, cache = dense.forward_seq(c, params, x,
                                         torch.arange(S, device=dev),
                                         cache_capacity=C)
        l_chunk, cache = dense.prefill_chunk(
            c, params, cache, dense.embed_tokens(c, params, chunk), S)
        l_dec, _ = dense.decode_step(
            c, params, cache, dense.embed_tokens(c, params, nxt),
            torch.tensor([S + Sq], device=dev))
        out[impl] = (l_seq, l_chunk, l_dec)
    for name, ref, got in zip(("forward_seq", "prefill_chunk",
                               "decode_step"), out["reference"],
                              out["hopper"]):
        scale = float(ref.float().abs().max())
        err = max_err(got, ref)
        agree = float((got.float().argmax(-1) == ref.float().argmax(-1))
                      .float().mean())
        log({"model_check": name, "shape": list(got.shape),
             "max_abs_err": err, "max_abs_ref": scale,
             "tol": LOGIT_TOL * scale, "argmax_agreement": agree})
        if not (torch.isfinite(got).all() and err <= LOGIT_TOL * scale):
            raise AssertionError(f"{name}: hopper logits differ from the "
                                 f"reference by {err} (scale {scale})")


# --------------------------------------------------------------- serve


def submit_round(cluster, cfg, rng, base: int):
    """8 requests (prompts of 100-700 tokens, 32 outputs; odd ones sampled
    at temperature 0.8 / top-p 0.9), all due at once."""
    from repro_torch.core import Request, SamplingParams
    lens = rng.integers(100, 701, size=8)
    handles = []
    for i, n in enumerate(lens):
        prompt = rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
        sp = SamplingParams(temperature=0.8, top_p=0.9) if i % 2 else None
        handles.append(cluster.submit(
            Request(rid=base + i, arrival=0.0, input_len=int(n),
                    output_len=32, sampling=sp), prompt=prompt))
    return [int(n) for n in lens], handles


def check_streams(cfg, handles) -> None:
    for h in handles:
        toks = [t for t in h.tokens if t is not None]
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"rid {h.rid}: bad stream {toks}")


def serve(cfg, params, dev="cuda"):
    """The port's main path: ArrowEngineCluster on the kernels, 8 requests
    (4 greedy, 4 sampled), prefill on instance 0, decode after migration.
    Returns the cluster and the kernels' launch counts of this run."""
    from repro_torch.core import SLO
    from repro_torch.engine import ArrowEngineCluster
    from repro_torch.kernels import (WRAPPERS, launch_counts,
                                     reset_launch_counts)

    rng = np.random.default_rng(11)
    reset_launch_counts()
    t0 = time.perf_counter()
    cluster = ArrowEngineCluster(
        cfg.replace(attn_impl="hopper"), n_instances=2, n_prefill=1,
        n_slots=8, capacity=1024, chunk_tokens=256, policy="arrow",
        slo=SLO(ttft=5.0, tpot=0.5), params=params, seed=0, device=dev)
    t_init = time.perf_counter() - t0
    lens, handles = submit_round(cluster, cfg, rng, 0)
    t1 = time.perf_counter()
    report = cluster.drain(timeout=600.0)
    t_serve = time.perf_counter() - t1
    counts = launch_counts()
    log(f"[serve] {report.summary()}")
    log({"serve": {"finished": report.n_finished, "requests": len(handles),
                   "prompt_lens": lens,
                   "migrations": len(cluster.migration_log),
                   "migrated_bytes": sum(m["bytes"]
                                         for m in cluster.migration_log),
                   "init_s": t_init, "serve_s": t_serve,
                   "output_tok_per_s": 32 * len(handles) / t_serve,
                   "launches": counts}})
    if report.n_finished != len(handles):
        raise AssertionError(f"only {report.n_finished}/{len(handles)} "
                             "requests finished")
    check_streams(cfg, handles)
    if len(cluster.migration_log) < 1:
        raise AssertionError("no KV migration happened")
    idle = [w.__name__ for w in WRAPPERS if w.launches == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{idle}")
    return cluster, counts


def profile_round(cluster, cfg):
    """A second round of 8 requests on the same cluster under torch.profiler
    (device activity only): the device's busy time against the wall time
    of the round, and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    _, handles = submit_round(cluster, cfg, np.random.default_rng(12), 100)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cluster.drain(timeout=600.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check_streams(cfg, handles)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    ours = {tag: [sum(r[1] for r in rows if tag in r[0]),
                  sum(r[2] for r in rows if tag in r[0])]
            for tag in ("flash_fwd", "paged_decode")}
    log({"profile": {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
                     "idle_share": 1.0 - busy_ms / (wall * 1e3),
                     "kernels_ms_calls": ours,
                     "top": [[k[:80], ms, n] for k, ms, n in rows[:10]]}})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        "tf32 off for float32 matmuls and cudnn")

    t0 = time.perf_counter()
    libs = _build.build(verbose=True)
    for name in libs:
        _build.load(name)
    log({"build_s": time.perf_counter() - t0,
         "libs": {k: str(v.relative_to(ROOT)) if ROOT in v.parents
                  else str(v) for k, v in libs.items()}})

    cfg = get_config("qwen3-1.7b")          # full width, bf16, 28 layers
    rows = check_kernels(cfg)
    check_sampler()
    g = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, g, "cuda")
    log({"params": sum(p.numel() for p in params.values()),
         "param_bytes": sum(p.numel() * p.element_size()
                            for p in params.values())})
    check_model(cfg, params)
    cluster, counts = serve(cfg, params)
    profile_round(cluster, cfg)

    log({"kernels": [
        {"name": r["name"], "route": r["route"], "source": r["source"],
         "replaces": r["replaces"], "launches": counts[r["wrapper"].__name__],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for r in rows]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
