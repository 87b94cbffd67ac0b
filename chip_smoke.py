"""Chip smoke test of the PyTorch port: builds the Hopper kernels, holds
each against its plain-torch version at the main paths' shapes, then drives
three engine paths at full published width (bf16, seeded random weights),
one model at a time:

  dense  qwen3-1.7b (28 layers): flash_prefill, flash_prefill_dyn,
         paged_attention
  ssm    mamba2-370m (48 layers): ssd_scan
  hybrid recurrentgemma-9b (38 layers): rglru_scan

and on every path crc32, the checksum of each migration's state on the card
(it is also checked against zlib at qwen3-1.7b's 0.2, 0.52 and 1.87 GB
migration images, ragged lengths and a chain, before the engine paths).
For each it compares the kernel path's logits with the reference path's on
the same weights and tokens, then serves 8 requests through
``ArrowEngineCluster`` (2 instances, Arrow policy, prefill -> decode state
migration) on the kernels, with every launch count set to 0 just before and
read just after, and checks that every kernel of that path ran. The dense
path is then served again self-speculatively (k = 4, a 14-layer draft on
paged decode, the verify on flash_prefill_dyn at k+1 rows), read the same
way, with the number of its streams equal to the fused ones reported; and
once more in float32, sequential and speculative, whose streams must be
equal id for id.

Then the runtime phase drives Arrow's runtime mechanisms at full width
(seed-0 weights, on the kernels). For qwen3-1.7b in float32 and then bf16,
bench_chaos's engine leg with transfer drops, netslow and a crash that is
sure to fire (the crash and a retry asserted; in float32 every stream
equal to its sequential reference, in bf16 the equal ones counted); in
float32 also the corrupt-copy path (the export's checksum, taken on the
card, equal to zlib's over the pinned payload; a flipped byte refused
before a slot is taken, the pristine pinned payload landing; one launch
at export and one at each import), deflection at its state barrier and
multi-turn prefix reuse (placements, counters and hits equal
to the port's simulator's; streams equal with the mechanism on and off),
SLO-aware preemption at a blocked memory gate, and an arrow_elastic run
that spawns an instance mid-serve (its wall time printed). Then
bench_ssm's legs for mamba2-370m and qwen3-1.7b (half their layers) in bf16
and float32:
forced migration against colocated and a replay (asserted identical in
float32), Mamba-2's migration bytes constant over context and qwen3's
proportional to it. The phase's launch counts join the kernels line.

A last phase measures the constants of the simulator's cost model on the
card, in this process after the engine paths (a bf16 GEMM at
qwen3-1.7b's MLP shapes, a 1 GiB device copy, the migration payloads'
device-to-host-to-device round trips, the device time of a full-width
decode step), prints them beside the coded defaults and beside the round
trips measured before any engine ran, and fails if a measured rate
exceeds its coded peak by more than 5% or a constant leaves its band
around the default. It holds the model's prefill and decode times against
the engine's measured ones for the three paths (printed, no gate) and
runs the port's ``Simulator`` on a dense ``spike`` for those paths and
olmoe-1b-7b, twice per policy, asserting that the two runs report the
same and that Arrow flips a pool (and the elastic policy scales up).

    python3 chip_smoke.py

Then the model zoo's other families run through ``build_model`` at full
published width (bf16, seeded random weights): qwen2-vl-2b (M-RoPE; on the
kernels, counted, held to the reference attention and to teacher forcing,
and both attention kernels held at its G = 6 shapes), olmoe-1b-7b,
whisper-medium and dbrx-132b (2 of its 40 layers: its weights do not fit
one card), each through loss, a prefill and 8 decode steps; ``moe_ffn`` at
olmoe and dbrx width is held on the card to the CPU in float32. Last, the
trainer (``repro_torch.launch.train``) takes 20 full-width qwen3-1.7b
steps, whose loss must fall and whose checkpoint must read back bit for
bit, and 3 steps of olmoe-1b-7b at 2 layers with finite gradients.

Then the distribution layer (``repro_torch.distributed``): the step
builders on a 1x1 NCCL mesh (one card holds one rank) at qwen3-1.7b's full
width through ``distribute_params``: 3 train steps whose losses must
match the trainer's, and a prefill with 8 decode steps on both attention
routes held to ``build_model``'s own, the kernels counted under the
DTensor wrappers; then ``repro_torch.launch.dryrun`` in subprocesses off
the card (qwen3-1.7b x train_4k, prefill_32k, decode_32k; olmoe-1b-7b x
train_4k with expert parallelism), each record printed.

Last, the bench phase: ``repro_torch.bench.bench_kernels`` times the six
kernels on the card at the JAX bench's shapes and at the main paths'
(crc32 at the three migration images, beside zlib on the same bytes),
each held to its plain version (its launches join the kernels line, and
its times at the main paths' shapes, the cases the kernel checks began
with, are the line's), and
``repro_torch.bench.roofline`` reads the records the dry-runs just wrote:
decode_32k must not be compute-bound. Every phase logs its wall time as it
ends; a line of every phase's time and the total precedes the result line.

Needs one CUDA device (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc. TF32 is switched off for float32 matmuls and
convolutions, so float32 comparisons are full precision. Exits non-zero on
any failure; the last line of standard output is the result JSON.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.bench.common import (BF16_TOL, RGLRU_TOL,  # noqa: E402
                                      SSD_TOL, bound, copies, max_err,
                                      nbytes, time_ms, within)

LOGIT_TOL = 5e-2         # model logits, hopper vs reference, x max|ref|


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


# each kernel of the kernels line: its wrapper, its source, the TPU kernel
# it replaces
KERNELS = {
    "flash_prefill": (
        "flash_seq_op",
        "src/repro_torch/kernels/flash_prefill/csrc/flash_prefill.cu",
        "src/repro/kernels/flash_prefill/flash_prefill.py:134"),
    "flash_prefill_dyn": (
        "flash_chunk_op",
        "src/repro_torch/kernels/flash_prefill/csrc/flash_prefill.cu",
        "src/repro/kernels/flash_prefill/flash_prefill.py:193"),
    "paged_attention": (
        "paged_attention_op",
        "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/paged_attention.py:106"),
    "ssd_scan": (
        "ssd_scan_op",
        "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/ssd_scan.py:85"),
    "rglru_scan": (
        "rglru_scan_op",
        "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru_scan/rglru_scan.py:60"),
    "crc32": (
        "crc32_op",
        "src/repro_torch/kernels/crc32/csrc/crc32.cu",
        "none (src/repro/engine/instance.py checksums with zlib on the "
        "host)"),
}
# bench_kernels' crc32 row the kernels line reports: the code mix's mean
CRC_MAIN = "migration_code_mean"


def main_cases() -> dict:
    """bench_kernels' cases at the main paths' shapes, by kernel: the
    shapes the kernels line reports, timed in the bench phase."""
    from repro_torch.bench import bench_kernels
    return {c.name: c for c in bench_kernels.cases("main",
                                                   torch.device("cuda"))}


def report(name: str, shape: str, pairs, tol: float) -> dict:
    """Log a kernel's check over its (kernel, plain) output pairs and fail
    if one lies outside ``tol``; returns the kernels line's start of a
    row."""
    err = max(max_err(a, b) for a, b in pairs)
    ok = all(within(a, b, tol) for a, b in pairs)
    log({"kernel_check": name, "shape": shape, "max_abs_err": err,
         "tol": f"atol=rtol={tol}", "within_tol": ok})
    if not ok:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version by {err}")
    wrapper, source, replaces = KERNELS[name]
    return dict(name=name, wrapper=wrapper, route="cuda", source=source,
                replaces=replaces, shape=shape, max_abs_err=err)


# ------------------------------------------------------------- kernels


def check_kernels(cfg, cases: dict):
    """Each attention kernel vs its plain version on the card: at the main
    path's shapes (``cases``: flash_seq at the profiling pass's longest
    prompt, S=128; flash_chunk's 256 tokens at offset 512 of a 1024-slot
    cache; paged decode over 8 slots of 1024 with lengths from 1 to 1024)
    and at the serve phase's other chunks, the speculative verify's rows
    and a shuffled page table."""
    from repro_torch.bench.bench_kernels import check
    from repro_torch.kernels import flash_chunk_op, paged_attention_op
    from repro_torch.kernels.flash_prefill import flash_prefill_ref
    from repro_torch.kernels.flash_prefill.ops import plan, wgmma_attrs
    from repro_torch.kernels.paged_attention import paged_attention_ref
    from repro_torch.kernels.paged_attention.ops import \
        kernel_attrs as paged_attrs
    from repro_torch.kernels.paged_attention.ops import plan as paged_plan

    dev = torch.device("cuda")
    H, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    def to_bhsd(t):
        return t.transpose(1, 2).contiguous()

    rows = []
    case = cases["flash_prefill"]
    got, want, _, _ = check(case)
    S = case.inputs[0].shape[1]
    log({"flash_seq_check": case.label,
         "plan": plan(1, H, Hk, S, S, D, 0, None)._asdict()})
    rows.append(report(case.name, case.label, list(zip(got, want)),
                       BF16_TOL))

    # flash_chunk: the main case, the serve phase's other chunks against
    # the whole 1024-slot cache (256 tokens at offsets 0, 256, 768 and the
    # smallest 32-token bucket at 992), and the speculative verify's k+1 =
    # 2, 5, 9 rows at offsets that are no multiple of the 64-position kv
    # tile
    case = cases["flash_prefill_dyn"]
    got, want, _, _ = check(case)
    pairs = list(zip(got, want))
    C = case.inputs[1].shape[1]
    for Sq, off in ((256, 0), (256, 256), (256, 768), (32, 992),
                    *((sq, o) for sq in (2, 5, 9) for o in (37, 517, 1015))):
        q, kc, vc = rnd(1, Sq, H, D), rnd(1, C, Hk, D), rnd(1, C, Hk, D)
        pairs.append((flash_chunk_op(q, kc, vc, off),
                      flash_prefill_ref(to_bhsd(q), to_bhsd(kc), to_bhsd(vc),
                                        q_offset=off).transpose(1, 2)))
        torch.cuda.synchronize()
        log({"flash_chunk_check": f"q(1,{Sq},{H},{D}) at offset {off}",
             "max_abs_err": max_err(*pairs[-1]),
             "plan": plan(1, H, Hk, Sq, C, D, off, None)._asdict()})
    log({"flash_fwd_wgmma": f"head_dim {D}", **wgmma_attrs(D)})
    rows.append(report(case.name, f"{case.label}; + offsets 0, 256, 768, "
                       "a 32-token chunk at 992, and 2, 5 and 9 rows at "
                       "offsets 37, 517 and 1015", pairs, BF16_TOL))
    flash_verify_timing(H, Hk, D, C, rnd, to_bhsd)

    # paged decode: the main case (8 slots x 1024 positions viewed as 8
    # pages of 128), and a general page table (pages shuffled) over the
    # same lengths
    case = cases["paged_attention"]
    got, want, _, _ = check(case)
    pairs = list(zip(got, want))
    q, kp, vp = case.inputs
    B, page = q.shape[0], kp.shape[1]
    MP = C // page
    lengths_l = [1, 100, 257, 400, 512, 700, 731, 1024]
    ln = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    qd = rnd(B, H, D)
    kp, vp = rnd(B * MP, page, Hk, D), rnd(B * MP, page, Hk, D)
    pt = torch.randperm(B * MP, generator=g, device=dev).to(
        torch.int32).view(B, MP)
    pairs.append((paged_attention_op(qd, kp, vp, pt, ln),
                  paged_attention_ref(qd, kp, vp, pt, ln)))
    torch.cuda.synchronize()
    log({"paged_check": f"q({B},{H},{D}) pages of {page}, {MP} a row",
         "plan": paged_plan(B, H, Hk, D, page, MP)._asdict(),
         "paged_decode_split": paged_attrs(bf, H // Hk)})
    rows.append(report(case.name, f"{case.label}, lengths {lengths_l}; "
                       "+ a shuffled page table", pairs, BF16_TOL))
    return rows


def flash_verify_timing(H, Hk, D, C, rnd, to_bhsd):
    """Device time of flash_chunk at the speculative verify's shape (k+1 =
    5 rows at offset 517 of a 1024-slot cache), beside its plain version,
    SDPA and its bound; logged, not a row of the kernels line."""
    from repro_torch.bench.bench_kernels import sdpa
    from repro_torch.kernels import flash_chunk_op
    from repro_torch.kernels.flash_prefill import flash_prefill_ref
    from repro_torch.kernels.flash_prefill.ops import plan
    dev = torch.device("cuda")
    Sq, off = 5, 517
    q, kc, vc = rnd(1, Sq, H, D), rnd(1, C, Hk, D), rnd(1, C, Hk, D)
    T = off + Sq
    sets = copies([q, kc, vc])
    qpos = torch.arange(Sq, device=dev)[:, None] + off
    mask = torch.arange(T, device=dev)[None, :] <= qpos
    lib_sets = [(to_bhsd(a), to_bhsd(b[:, :T]), to_bhsd(c[:, :T]))
                for a, b, c in sets]
    plain_sets = [tuple(to_bhsd(t) for t in s) for s in sets]
    pairs = Sq * off + Sq * (Sq + 1) // 2
    b_ms, b_by = bound(2 * (2 * q.numel() + 2 * T * Hk * D),
                       4.0 * D * H * pairs)
    ms = time_ms(lambda a, b, c: flash_chunk_op(a, b, c, off), sets, 200)
    plain = time_ms(lambda a, b, c: flash_prefill_ref(a, b, c, q_offset=off),
                    plain_sets, 50)
    lib = time_ms(lambda a, b, c: sdpa(a, b, c, mask=mask), lib_sets, 200)
    log({"flash_verify_timing": f"q(1,{Sq},{H},{D}) at offset {off}, "
                                f"kv(1,{C},{Hk},{D}) bf16",
         "plan": plan(1, H, Hk, Sq, C, D, off, None)._asdict(),
         "kernel_ms": ms[0], "plain_ms": plain[0], "library_ms": lib[0],
         "bound_ms": b_ms, "bound_by": b_by,
         "per_call_event_ms": {"ms": ms[1], "plain_ms": plain[1],
                               "library_ms": lib[1]}})


def check_scan_kernels(cases: dict):
    """ssd_scan and rglru_scan vs their plain versions on the card: at the
    main paths' shapes (``cases``: one 256-token prefill chunk of
    full-width mamba2-370m, H=32, P=64, N=128, chunk 128, B and C at the
    group level the model passes, n_groups 1, and of recurrentgemma-9b,
    lru_width 4096, each from a random state), and at batch 8, B and C
    repeated per head, two groups, a two-half chunk resume through h0, and
    for rglru_scan a 160-token bucket (a length the TPU kernel's 128-token
    tiles refuse), a whole 1024-slot prompt and a single step."""
    from repro_torch.bench.bench_kernels import check
    from repro_torch.kernels import rglru_scan_op, ssd_scan_op
    from repro_torch.kernels.rglru_scan import rglru_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def ssd_inputs(B, S, H=32, P=64, N=128, G=1):
        """mamba2-370m's layout: B and C at group level (n_groups = 1)."""
        return (rnd(B, S, H, P), -rnd(B, S, H).abs() * 0.5,
                rnd(B, S, G, N, scale=0.3), rnd(B, S, G, N, scale=0.3),
                rnd(B, H, P, N))

    def rglru_inputs(B, S, W=4096):
        return -rnd(B, S, W).abs() * 0.3, rnd(B, S, W), rnd(B, W)

    case = cases["ssd_scan"]
    got, want, _, _ = check(case)
    x, la, Bm, Cm, h0 = case.inputs
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = S // 2
    y1, h1 = ssd_scan_op(x[:, :Q], la[:, :Q], Bm[:, :Q], Cm[:, :Q], Q, h0=h0)
    y2, h2 = ssd_scan_op(x[:, Q:], la[:, Q:], Bm[:, Q:], Cm[:, Q:], Q, h0=h1)
    b8 = ssd_inputs(8, 256)
    got8 = ssd_scan_op(*b8[:4], Q, h0=b8[4])
    want8 = ssd_scan_ref(*b8)
    # the per-head form of the JAX contract, and two groups
    per_head = ssd_scan_op(x, la, Bm.repeat_interleave(H // G, 2),
                           Cm.repeat_interleave(H // G, 2), Q, h0=h0)
    g2 = ssd_inputs(1, 256, G=2)
    got2 = ssd_scan_op(*g2[:4], Q, h0=g2[4])
    want2 = ssd_scan_ref(*g2)
    torch.cuda.synchronize()
    from repro_torch.kernels.ssd_scan.ops import kernel_attrs as ssd_attrs
    log({"ssd_scan_phases": f"chunk {Q}, d_state {N}", **ssd_attrs()})
    rows = [report(case.name, f"{case.label}; + batch 8, + per-head B/C, "
                   "+ 2 groups, + resume from two halves",
                   list(zip(got, want)) + list(zip(got8, want8))
                   + list(zip(per_head, want)) + list(zip(got2, want2))
                   + [(torch.cat([y1, y2], 1), got[0]), (h2, got[1])],
                   SSD_TOL)]

    from repro_torch.kernels.rglru_scan.ops import kernel_attrs as rg_attrs
    from repro_torch.kernels.rglru_scan.ops import plan as rg_plan
    case = cases["rglru_scan"]
    got, want, _, _ = check(case)
    pairs = list(zip(got, want))
    for B, S in ((1, 160), (8, 256), (1, 1024), (1, 1)):
        a = rglru_inputs(B, S)
        pairs += list(zip(rglru_scan_op(*a), rglru_scan_ref(*a)))
    torch.cuda.synchronize()
    pl = rg_plan(1, 256, 4096)
    log({"rglru_scan_plans": {f"({B},{S},4096)": rg_plan(B, S, 4096)._asdict()
                              for B, S in ((1, 256), (1, 160), (8, 256),
                                           (1, 1024), (1, 1))},
         "rglru_cluster": rg_attrs(pl),
         "rglru_cluster_4_rounds": rg_attrs(rg_plan(1, 1024, 4096))})
    rows.append(report(case.name, f"{case.label}, route {pl.route}, "
                       f"{pl.blocks} blocks in clusters of {pl.cluster}; + "
                       "(1,160,4096), (8,256,4096), (1,1024,4096), "
                       "(1,1,4096)", pairs, RGLRU_TOL))
    return rows


def check_crc_kernel() -> dict:
    """crc32 vs zlib on the card, each CRC compared as its four bytes:
    bench_kernels' migration images (k then v stacked, bf16, 0.2, 0.52 and
    1.87 GB) against the plain version and zlib, twelve ragged lengths
    chained from a nonzero CRC, an unaligned start, and a chain of three
    tensors of bf16, float32 and uint8."""
    import zlib
    from repro_torch.bench.bench_kernels import cases, check, crc_bytes
    from repro_torch.engine.instance import state_checksum
    from repro_torch.kernels import crc32_op
    from repro_torch.kernels.crc32.ops import kernel_attrs
    from repro_torch.kernels.crc32.ref import BLOCK_BYTES, TILE, UNIT
    dev = torch.device("cuda")
    pairs, label = [], None
    for case in cases("migration", dev):
        got, want, _, _ = check(case)
        pairs += list(zip(got, want))
        pairs.append((got[0], case.host(*(t.cpu() for t in case.inputs))))
        if case.label.startswith(CRC_MAIN):
            label = case.label
        del case
    rng = np.random.default_rng(4)
    for n in (0, 1, 3, 15, 16, 17, UNIT + 1, TILE - 1, BLOCK_BYTES,
              BLOCK_BYTES + 1, 3 * BLOCK_BYTES + 7717,
              1031 * BLOCK_BYTES - 16):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        pairs.append((
            crc_bytes(crc32_op(torch.from_numpy(data).to(dev), 0xCAFEF00D)),
            crc_bytes(zlib.crc32(data.tobytes(), 0xCAFEF00D))))
    data = torch.from_numpy(rng.integers(0, 256, 1 << 20, dtype=np.uint8))
    pairs.append((crc_bytes(crc32_op(data.to(dev)[3:])),
                  crc_bytes(zlib.crc32(data[3:].numpy()))))
    ts = [torch.randn(300001).to(torch.bfloat16), torch.randn(300002),
          torch.randint(0, 256, (300003,), dtype=torch.uint8)]
    chained = 0
    for t in ts:
        chained = zlib.crc32(t.view(torch.uint8).numpy(), chained)
    pairs.append((crc_bytes(state_checksum([t.to(dev) for t in ts])),
                  crc_bytes(chained)))
    log({"crc32_blocks": kernel_attrs()["crc32_blocks"]})
    return report("crc32", f"{label}; + 0.2 and 1.87 GB, + 12 ragged "
                  "lengths chained, + an unaligned start, + a 3-tensor "
                  "chain", pairs, 0.0)


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
    compare_logits(cfg, ("forward_seq", "prefill_chunk", "decode_step"), out)


def compare_logits(cfg, names, out) -> None:
    """Hopper vs reference logits: max |diff| within LOGIT_TOL of max |ref|
    (bf16 activations through every layer, rounded at other points on the
    two paths), with the argmax agreement reported beside it."""
    for name, ref, got in zip(names, out["reference"], out["hopper"]):
        scale = float(ref.float().abs().max())
        err = max_err(got, ref)
        agree = float((got.float().argmax(-1) == ref.float().argmax(-1))
                      .float().mean())
        log({"model_check": name, "arch": cfg.arch_id,
             "shape": list(got.shape), "max_abs_err": err,
             "max_abs_ref": scale, "tol": LOGIT_TOL * scale,
             "argmax_agreement": agree})
        if not (torch.isfinite(got).all() and err <= LOGIT_TOL * scale):
            raise AssertionError(f"{cfg.arch_id} {name}: hopper logits "
                                 f"differ from the reference by {err} "
                                 f"(scale {scale})")


def check_recurrent_model(cfg, params, dev="cuda"):
    """Full-width prefill_chunk logits of a constant-state family (ssm,
    hybrid) with its scan kernel vs the reference scan, on the same weights
    and tokens: a whole 256-token chunk from a zero state, a second chunk
    of 200 real tokens padded to 256 (state resumed through h0), then a
    decode step from the carried state."""
    from repro_torch.models import hybrid, ssm
    model = ssm if cfg.family == "ssm" else hybrid
    dev = torch.device(dev)
    rng = np.random.default_rng(4)
    Sq, n2, C = 256, 200, 1024

    def toks(n):
        return torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(1, n))
                                .astype(np.int32)).to(dev)

    chunks, nxt = (toks(Sq), toks(Sq)), toks(1)
    out = {}
    for impl in ("reference", "hopper"):
        c = cfg.replace(attn_impl=impl)
        cache = model.init_cache(c, 1, C, device=dev)
        l1, cache = model.prefill_chunk(
            c, params, cache, model.embed_tokens(c, params, chunks[0]), 0,
            valid_len=Sq)
        l2, cache = model.prefill_chunk(
            c, params, cache, model.embed_tokens(c, params, chunks[1]), Sq,
            valid_len=n2)
        l3, _ = model.decode_step(
            c, params, cache, model.embed_tokens(c, params, nxt),
            torch.tensor([Sq + n2], device=dev))
        out[impl] = (l1, l2[:, :n2], l3)
    compare_logits(cfg, ("prefill_chunk", "prefill_chunk_resume",
                         "decode_step"), out)


# --------------------------------------------------------------- serve


def submit_round(cluster, cfg, rng, base: int, out_len: int = 32):
    """8 requests (prompts of 100-700 tokens, ``out_len`` outputs; odd ones
    sampled at temperature 0.8 / top-p 0.9), all due at once."""
    from repro_torch.core import Request, SamplingParams
    lens = rng.integers(100, 701, size=8)
    handles = []
    for i, n in enumerate(lens):
        prompt = rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
        sp = SamplingParams(temperature=0.8, top_p=0.9) if i % 2 else None
        handles.append(cluster.submit(
            Request(rid=base + i, arrival=0.0, input_len=int(n),
                    output_len=out_len, sampling=sp), prompt=prompt))
    return [int(n) for n in lens], handles


def check_streams(cfg, handles, out_len: int = 32) -> None:
    for h in handles:
        toks = [t for t in h.tokens if t is not None]
        if len(toks) != out_len or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
            raise AssertionError(f"rid {h.rid}: bad stream {toks}")


def serve(cfg, params, expect, dev="cuda", label="fused", **kw):
    """One engine path: ArrowEngineCluster on the kernels, 8 requests
    (4 greedy, 4 sampled), prefill on instance 0, decode after migration;
    ``kw`` picks the decode mode (``speculate``, ``draft_layers``). Every launch count is set to 0 just before and read
    just after; each wrapper of ``expect`` (the path's kernels) must have
    launched. Returns the cluster, the launch counts of this run and the
    8 token streams."""
    from repro_torch.core import SLO
    from repro_torch.engine import ArrowEngineCluster
    from repro_torch.kernels import launch_counts, reset_launch_counts

    rng = np.random.default_rng(11)
    reset_launch_counts()
    t0 = time.perf_counter()
    cluster = ArrowEngineCluster(
        cfg.replace(attn_impl="hopper"), n_instances=2, n_prefill=1,
        n_slots=8, capacity=1024, chunk_tokens=256, policy="arrow",
        slo=SLO(ttft=5.0, tpot=0.5), params=params, seed=0, device=dev,
        **kw)
    t_init = time.perf_counter() - t0
    lens, handles = submit_round(cluster, cfg, rng, 0)
    t1 = time.perf_counter()
    report = cluster.drain(timeout=600.0)
    t_serve = time.perf_counter() - t1
    counts = launch_counts()
    mig = [m["bytes"] for m in cluster.migration_log]
    log(f"[serve {cfg.arch_id} {cfg.dtype} {label}] {report.summary()}")
    log({"serve": {"arch": cfg.arch_id, "dtype": cfg.dtype, "mode": label,
                   "finished": report.n_finished,
                   "requests": len(handles), "prompt_lens": lens,
                   "ttft_p50_s": report.percentile("ttft", 0.5),
                   "ttft_p90_s": report.percentile("ttft", 0.9),
                   "tpot_p90_s": report.percentile("tpot", 0.9),
                   "migrations": len(mig), "migrated_bytes": sum(mig),
                   "migrated_bytes_per_request": sorted(set(mig)),
                   "init_s": t_init, "serve_s": t_serve,
                   "output_tok_per_s": 32 * len(handles) / t_serve,
                   "speculation": report.speculation,
                   "launches": counts}})
    if report.n_finished != len(handles):
        raise AssertionError(f"only {report.n_finished}/{len(handles)} "
                             "requests finished")
    check_streams(cfg, handles)
    if not mig:
        raise AssertionError("no state migration happened")
    if cfg.family != "dense" and len(set(mig)) != 1:
        raise AssertionError(f"{cfg.family} migration payloads differ in "
                             f"size across context lengths: {sorted(mig)}")
    idle = [w.__name__ for w in expect if counts[w.__name__] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the {cfg.arch_id} "
                             f"{label} path: {idle}")
    return cluster, counts, [[t for t in h.tokens] for h in handles]


def step_modes(cfg, params, expect, fused, dev="cuda"):
    """The dense path's self-speculative step (k = 4, half the layers as
    the draft) at the fused phase's shape. It must launch the path's
    kernels; how many of its 8 streams equal the sequential ones
    (``fused``) is reported, with the first differing position of each
    other one, not asserted: in bf16 the verify's (k+1)-row GEMMs and
    flash round differently from decode's 1-row GEMMs and paged kernel, so
    a near-tied argmax can flip. Returns the mode's launch counts and
    streams by label."""
    cluster, counts, streams = serve(cfg, params, expect, dev, "speculative",
                                     speculate=4,
                                     draft_layers=cfg.n_layers // 2)
    differ = [i for i, (a, b) in enumerate(zip(streams, fused)) if a != b]
    log({"step_mode": "speculative", "dtype": cfg.dtype,
         "streams_equal_fused": f"{len(fused) - len(differ)}/{len(fused)}",
         "differ": {i: next(j for j, (x, y) in enumerate(
             zip(streams[i], fused[i])) if x != y) for i in differ}})
    del cluster
    gc.collect()
    torch.cuda.empty_cache()
    return {"speculative": (counts, streams)}


def check_stream_identity(cfg, expect, dev="cuda"):
    """qwen3-1.7b at full width in float32 (weights from seed 0, TF32 off,
    the kernels' float32 routes): the same 8 requests served sequentially
    and speculatively (k = 4) give the same streams id for id."""
    from repro_torch.weights import init_params
    cfg = cfg.replace(dtype="float32")
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, g, dev)
    log({"arch": cfg.arch_id, "dtype": cfg.dtype,
         "param_bytes": nbytes(*params.values())})
    cluster, _, fused = serve(cfg, params, expect, dev, "fused")
    del cluster
    modes = step_modes(cfg, params, expect, fused, dev)
    bad = {label: [i for i, (a, b) in enumerate(zip(s, fused)) if a != b]
           for label, (_, s) in modes.items()}
    log({"stream_identity_f32": {label: not rows
                                 for label, rows in bad.items()}})
    if any(bad.values()):
        raise AssertionError(f"float32 streams differ from the fused "
                             f"sequential ones: {bad}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# outputs a request of the profiled round: the profiler's collection after
# the round takes 7-8x the round's wall time, and grows with its decode steps
PROFILE_OUT = 16


def profile_round(cluster, cfg, tags):
    """A second round of 8 requests (``PROFILE_OUT`` outputs each) on the
    same cluster under torch.profiler (device activity only): the device's
    busy time against the wall time of the round, and device time by
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    _, handles = submit_round(cluster, cfg, np.random.default_rng(12), 100,
                              PROFILE_OUT)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cluster.drain(timeout=600.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check_streams(cfg, handles, PROFILE_OUT)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    ours = {tag: [sum(r[1] for r in rows if tag in r[0]),
                  sum(r[2] for r in rows if tag in r[0])]
            for tag in tags}
    log({"profile": {"arch": cfg.arch_id, "wall_ms": wall * 1e3,
                     "device_busy_ms": busy_ms,
                     "idle_share": 1.0 - busy_ms / (wall * 1e3),
                     "kernels_ms_calls": ours,
                     "top": [[k[:80], ms, n] for k, ms, n in rows[:10]]}})


# ------------------------------------------------------------- runtime


RUNTIME_PLAN = ("droptransfer@0.05:p=0.7,duration=1;"
                "netslow@0.2:factor=3,duration=1;crash@0.1:target=1")
SSM_LEG = dict(rate=1.5, duration=4.0)   # bench_ssm's traffic, a 4 s trace
# a request's mamba2-370m state a layer at full width (50,995,200 B at
# its 48 layers)
MAMBA2_BF16_BYTES_PER_LAYER = 1_062_400
# bench_ssm's legs at half the published depth (full width): a leg's time
# is the host's, which grows with the layers a pass runs
SSM_LEG_LAYERS = {"mamba2-370m": 24, "qwen3-1.7b": 14}


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def summary(label: str, report) -> None:
    log(f"[runtime {label}] {report.summary()}")


def record_placements(cluster):
    """Wrap the policy's place_prefill to log (rid, instance, deflected)."""
    orig = cluster.policy.place_prefill
    rec = []

    def place(req, now, prefix_hits=None):
        iid, hit, deflected = orig(req, now, prefix_hits=prefix_hits)
        rec.append((req.rid, iid, deflected))
        return iid, hit, deflected

    cluster.policy.place_prefill = place
    return rec


def check_corrupt_wire(cfg, params) -> dict:
    """The corrupt-copy path on the card: an exported payload sits in
    pinned host memory and its checksum, taken on the card at export, is
    zlib's over the pinned bytes; a clone with one flipped byte fails the
    checksum the importer takes on the card after uploading it (refused
    before a slot is taken), and the pristine payload then lands: the
    kernel launched once at export (k and v stacked) and once at each
    import (the wire uploaded as one image), two launches an attempt."""
    from repro_torch.engine import EngineInstance
    from repro_torch.engine.instance import CorruptPayload, state_checksum
    from repro_torch.kernels import crc32_op
    a = EngineInstance(0, cfg, params, n_slots=2, capacity=128, device="cuda")
    b = EngineInstance(1, cfg, params, n_slots=2, capacity=128, device="cuda")
    prompt = np.arange(1, 25, dtype=np.int32)
    a.run_prefill(7, prompt)
    a.local.start_local_decode(7, len(prompt), 4)
    a.run_decode_iteration([7])
    before = crc32_op.launches
    payload, L, last, gen, good = a.export_state(7)
    wire = [p.clone() for p in payload]
    wire[0].view(torch.uint8).view(-1)[0] ^= 0xFF
    refused = False
    try:
        b.import_state(7, wire, L, last, list(gen), checksum=good)
    except CorruptPayload:
        refused = 7 not in b.kv.slot_of
    ok = b.import_state(7, payload, L, last, list(gen), checksum=good)
    out = {"pinned": all(p.is_pinned() for p in payload),
           "card_crc_is_zlibs": good == state_checksum(payload),
           "kernel_at_export_and_imports":
               crc32_op.launches - before == 3,
           "corrupt_crc_differs": state_checksum(wire) != good,
           "refused_before_alloc": refused, "pristine_landed": bool(ok)}
    log({"corrupt_wire": out})
    if not all(out.values()):
        raise AssertionError(f"corrupt-copy path: {out}")
    return out


def runtime_chaos(cfg, params) -> dict:
    """bench_chaos's engine leg at full width: drops, netslow and a crash of
    decode instance 1 at 0.1 s (a request due at 0.5 s keeps the cluster
    serving past it on a fast card), under HealthConfig(xfer_backoff_s=
    0.01). The crash must fire and a transfer must be retried; in float32
    every stream must equal its sequential reference, in bf16 the number
    of equal streams is reported."""
    from repro_torch.bench import bench_chaos
    counts, report, _ = bench_chaos.run_engine_leg(
        cfg, params, "cuda", plan=RUNTIME_PLAN, late=(0.5, 4))
    summary(f"chaos {cfg.dtype}", report)
    n = counts["n_requests"]
    counts["streams_equal"] = f"{n - counts['mismatched_streams']}/{n}"
    log({"runtime_chaos": {"dtype": cfg.dtype, **counts}})
    if counts["crashes"] != 1 or counts["xfer_retries"] < 1:
        raise AssertionError(f"chaos plan did not land: {counts}")
    if cfg.dtype == "float32" and counts["mismatched_streams"]:
        raise AssertionError(f"float32 streams left the reference: {counts}")
    return counts


def runtime_deflection(cfg, params) -> None:
    """tests/test_scheduler.py's barrier: 1000 s of Eq.(2) backlog charged
    to the prefill instance before a burst of 6; the engine's deflected
    placements and counters must equal the port simulator's, and the
    streams must be the same with deflection on and off (float32)."""
    from repro_torch.core import (SLO, AutoScalerConfig, DeflectionConfig,
                                  Request)
    from repro_torch.engine import ArrowEngineCluster
    from repro_torch.sim import Simulator
    rng = np.random.default_rng(3)
    prompts = {i: rng.integers(1, cfg.vocab_size, size=24).astype(np.int32)
               for i in range(6)}
    pinned = AutoScalerConfig(min_instances=2, max_instances=2)

    def run(system, with_prompts):
        system.policy.prefill_ready_at[0] = 1000.0
        rec = record_placements(system)
        hs = [system.submit(Request(rid=i, arrival=0.0, input_len=24,
                                    output_len=6),
                            **({"prompt": prompts[i]} if with_prompts
                               else {})) for i in range(6)]
        rep = (system.drain(timeout=300.0) if with_prompts
               else system.drain())
        return rec, rep, [list(h.tokens) for h in hs]

    rec_sim, rep_sim, _ = run(Simulator(
        cfg, n_instances=2, n_prefill=1, policy="arrow_deflect",
        slo=SLO(30.0, 10.0), autoscaler_cfg=pinned,
        deflection=DeflectionConfig(ratio=0.25)), False)
    out = {}
    for ratio in (0.25, 0.0):
        eng = ArrowEngineCluster(
            cfg, n_instances=2, n_prefill=1, n_slots=4, capacity=128,
            slo=SLO(30.0, 10.0), params=params, policy="arrow_deflect",
            autoscaler_cfg=pinned, deflection=DeflectionConfig(ratio=ratio),
            device="cuda")
        out[ratio] = run(eng, True)
        summary(f"deflection ratio={ratio}", out[ratio][1])
        del eng
    rec_on, rep_on, streams_on = out[0.25]
    keys = ("requests_deflected", "tokens_deflected", "chunks_executed",
            "chunk_tokens_executed")
    res = {"placements_sim": rec_sim, "placements_engine": rec_on,
           "counters_sim": {k: rep_sim.deflection[k] for k in keys},
           "counters_engine": {k: rep_on.deflection.get(k) for k in keys},
           "streams_equal_on_off": streams_on == out[0.0][2]}
    log({"runtime_deflection": res})
    if not any(d for _, _, d in rec_sim) or rec_sim != rec_on \
            or res["counters_sim"] != res["counters_engine"] \
            or not res["streams_equal_on_off"] \
            or any(d for _, _, d in out[0.0][0]):
        raise AssertionError(f"deflection parity failed: {res}")


def runtime_prefix(cfg, params) -> None:
    """tests/test_prefix.py's tiny_multiturn (two sessions, 3 + 2 turns):
    the engine's prefix hits must equal the port simulator's (3), and the
    streams must be the same with the cache on and off (float32)."""
    from repro_torch.core import SLO, Request
    from repro_torch.core.serving import replay_trace
    from repro_torch.engine import ArrowEngineCluster
    from repro_torch.sim import Simulator
    trace = [Request(0, 0.00, 40, 3, session_id=0),
             Request(1, 0.05, 36, 2, session_id=1),
             Request(2, 0.10, 81, 3, session_id=0, parent_rid=0,
                     history_len=43),
             Request(3, 0.15, 68, 2, session_id=1, parent_rid=1,
                     history_len=38),
             Request(4, 0.20, 104, 2, session_id=0, parent_rid=2,
                     history_len=84)]
    sim = Simulator(cfg, n_instances=2, n_prefill=1, slo=SLO(5.0, 2.0),
                    prefix_cache=True)
    replay_trace(sim, trace)
    hits_sim = sim.drain().prefix["hits"]
    streams, hits = {}, None
    for on in (False, True):
        eng = ArrowEngineCluster(cfg, n_instances=2, n_prefill=1, n_slots=4,
                                 capacity=128, slo=SLO(5.0, 2.0),
                                 params=params, prefix_cache=on,
                                 device="cuda")
        hs = replay_trace(eng, trace)
        rep = eng.drain(timeout=300.0)
        summary(f"prefix cache={on}", rep)
        streams[on] = [[int(t) for t in h.tokens] for h in hs]
        if on:
            hits = rep.prefix["hits"]
        del eng
    res = {"hits_sim": hits_sim, "hits_engine": hits,
           "streams_equal_on_off": streams[True] == streams[False]}
    log({"runtime_prefix": res})
    if not (hits == hits_sim == 3 and res["streams_equal_on_off"]):
        raise AssertionError(f"prefix parity failed: {res}")


def runtime_preemption(cfg, params) -> None:
    """tests/test_health.py's blocked memory gate: rid 2's evacuation finds
    instance 1 one token short, the long resident (rid 1) is preempted and
    re-prefilled; every stream equals its sequential reference (float32)."""
    from repro_torch.bench.bench_chaos import reference_streams
    from repro_torch.core import SLO, HealthConfig, Request
    from repro_torch.engine import ArrowEngineCluster
    eng = ArrowEngineCluster(cfg, n_instances=3, n_prefill=1, n_slots=4,
                             capacity=128, slo=SLO(5.0, 2.0), params=params,
                             health=HealthConfig(preemption=True),
                             device="cuda")
    rng = np.random.default_rng(11)
    prompts = {i: rng.integers(1, cfg.vocab_size, size=24).astype(np.int32)
               for i in range(3)}
    lens = {0: 8, 1: 32, 2: 8}

    def submit(i):
        return eng.submit(Request(rid=i, arrival=0.0, input_len=24,
                                  output_len=lens[i]), prompt=prompts[i])

    def until(cond, what):
        for _ in range(100000):
            if cond():
                return
            if not eng.step():
                raise AssertionError(f"drained before {what}")

    hs = [submit(0), submit(1)]
    until(lambda: all(h.req.state.name == "DECODING"
                      and h.req.decode_instance == 1
                      and 2 <= len(h.tokens) < h.req.output_len
                      for h in hs), "the two-resident barrier")
    eng.collect_stats(eng.clock.now())
    hs.append(submit(2))
    until(lambda: hs[2].req.state.name == "DECODING"
          and hs[2].req.decode_instance == 2 and len(hs[2].tokens) >= 2,
          "rid 2 decoding on instance 2")
    loc1 = eng.local_of(1)
    real = loc1.kv_capacity
    loc1.kv_capacity = loc1.kv_used + \
        eng.local_of(2).decode_running[2].context_len - 1
    eng.begin_retire(2, eng.clock.now())
    loc1.kv_capacity = real
    rep = eng.drain(timeout=300.0)
    summary("preemption", rep)
    ref = reference_streams(cfg, params, prompts, lens, "cuda")
    res = {"victims": sorted(h.rid for h in hs if h.req.recoveries),
           "preemptions": rep.health.get("preemptions"),
           "streams_equal": sum(ref[h.rid] == [int(t) for t in h.tokens]
                                for h in hs)}
    log({"runtime_preemption": res})
    if res != {"victims": [1], "preemptions": 1, "streams_equal": 3}:
        raise AssertionError(f"preemption failed: {res}")


def runtime_elastic(cfg, params) -> None:
    """arrow_elastic at the engine's full shape (8 slots x 1024): a burst
    of 8 prompts of 900-999 tokens; once one of them decodes on instance 1
    its running tokens (~960 of 8,192) put the autoscaler's decode
    pressure over its threshold (set to 0.1, as the card prefills faster
    than it decodes one request here), so an instance is spawned (its
    slabs allocated) mid-serve; 4 more requests arrive at 2 s. Asserts a
    scale-up and every stream equal to its sequential reference (float32);
    reports the spawn's wall time, where each request ran, and the TTFT
    predictor fitted from the card's profile."""
    from repro_torch.bench.bench_chaos import reference_streams
    from repro_torch.core import SLO, AutoScalerConfig, Request
    from repro_torch.engine import ArrowEngineCluster
    eng = ArrowEngineCluster(
        cfg, n_instances=2, n_prefill=1, n_slots=8, capacity=1024,
        chunk_tokens=256, slo=SLO(5.0, 0.5), params=params,
        policy="arrow_elastic", device="cuda",
        autoscaler_cfg=AutoScalerConfig(min_instances=2, max_instances=3,
                                        decode_up=0.1, up_patience=1))
    spawn_s = []
    create = eng._create_instance

    def timed_create(iid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = create(iid)
        torch.cuda.synchronize()
        spawn_s.append(time.perf_counter() - t0)
        return out

    eng._create_instance = timed_create
    rng = np.random.default_rng(13)
    prompts = {i: rng.integers(1, cfg.vocab_size, size=int(n)).astype(
        np.int32) for i, n in enumerate(rng.integers(900, 1000, size=12))}
    hs = [eng.submit(Request(rid=i, arrival=0.0 if i < 8 else 2.0,
                             input_len=len(p), output_len=16), prompt=p)
          for i, p in prompts.items()]
    rep = eng.drain(timeout=300.0)
    summary("elastic", rep)
    ref = reference_streams(cfg, params, prompts, {i: 16 for i in prompts},
                            "cuda", capacity=1024)
    res = {"scale_ups": rep.scaling.get("scale_ups"),
           "scale_downs": rep.scaling.get("scale_downs"),
           "events": [(e.kind, e.instance, e.pool.value, e.t, e.reason)
                      for e in eng.autoscaler.events],
           "predictor": [float(c) for c in eng.predictor.coeffs],
           "predicted_prefill_s": {n: eng.predictor.predict(n)
                                   for n in (128, 512, 1000)},
           "spawn_s": spawn_s, "instances": sorted(eng.instances),
           "placements": [(h.req.prefill_instance, h.req.decode_instance)
                          for h in hs],
           "finished": rep.n_finished,
           "streams_equal": sum(ref[h.rid] == [int(t) for t in h.tokens]
                                for h in hs)}
    log({"runtime_elastic": res})
    if not (res["scale_ups"] and res["scale_ups"] >= 1 and spawn_s
            and res["finished"] == 12):
        raise AssertionError(f"elastic run did not scale up: {res}")
    if cfg.dtype == "float32" and res["streams_equal"] != 12:
        raise AssertionError(f"float32 streams left the reference: {res}")


def runtime_ssm_legs(arch: str, dtype: str) -> None:
    """bench_ssm's legs at the arch's full width and ``SSM_LEG_LAYERS``:
    forced migration (``arrow``) against ``colocated`` and, in float32, a
    replay; both asserted identical in float32 (in bf16 the number of
    streams equal to the colocated ones is reported). Mamba-2's migration
    bytes must be constant over context, qwen3's proportional (in bf16
    exactly 1,062,400 B a layer a request and 4,096 B a layer a
    token)."""
    from repro_torch.bench import bench_ssm
    from repro_torch.configs import get_config
    from repro_torch.weights import init_params, torch_dtype
    cfg = get_config(arch).replace(attn_impl="hopper", dtype=dtype,
                                   n_layers=SSM_LEG_LAYERS[arch])
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    runs = {}
    # the replay's identity is asserted in float32 only, so bf16 skips it
    policies = ("arrow",) if cfg.family != "ssm" else \
        ("arrow", "colocated") + (("arrow",) if dtype == "float32" else ())
    for i, policy in enumerate(policies):
        t0 = time.perf_counter()
        rep, mlog, streams = bench_ssm.serve(cfg, policy, device="cuda",
                                             params=params, **SSM_LEG)
        summary(f"ssm-leg {arch} {dtype} {policy}", rep)
        runs[i] = (mlog, streams, time.perf_counter() - t0)
    mlog, streams, _ = runs[0]
    size = {m["bytes"] for m in mlog}
    per_tok = {m["bytes"] / m["ctx_tokens"] for m in mlog}
    res = {"arch": arch, "dtype": dtype, "layers": cfg.n_layers,
           "migrations": len(mlog),
           "ctx": sorted({m["ctx_tokens"] for m in mlog}),
           "bytes": sorted(size), "bytes_per_token": sorted(per_tok),
           "serve_s": [r[2] for r in runs.values()]}
    if cfg.family == "ssm":
        n = len(streams)
        res["colocated_equal"] = sum(streams[r] == runs[1][1].get(r)
                                     for r in streams)
        if 2 in runs:
            res["replay_equal"] = sum(streams[r] == runs[2][1].get(r)
                                      for r in streams)
        res["streams"] = n
        if runs[1][0]:
            raise AssertionError("colocated run migrated")
    log({"runtime_ssm_leg": res})
    if not mlog or len(res["ctx"]) < 2:
        raise AssertionError(f"ssm leg migrated too little: {res}")
    if cfg.family == "ssm":
        if len(size) != 1 or (dtype == "bfloat16"
                              and size != {MAMBA2_BF16_BYTES_PER_LAYER
                                           * cfg.n_layers}):
            raise AssertionError(f"mamba2 migration bytes: {res}")
        if dtype == "float32" and (res["colocated_equal"] != n
                                   or res["replay_equal"] != n):
            raise AssertionError(f"float32 ssm streams differ: {res}")
    else:
        # K and V, every layer's kv heads, per context token
        want = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim_ * \
            torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
        if per_tok != {float(want)}:
            raise AssertionError(f"qwen3 migration bytes (want {want} a "
                                 f"token): {res}")
    del params
    free_card()


def runtime_phase(smi: str) -> dict:
    """Arrow's runtime mechanisms on the card at full published width
    (random weights from seed 0, on the kernels): for qwen3-1.7b in
    float32 (TF32 off) then bf16 the chaos engine leg; in float32 the
    corrupt-copy path, deflection at its barrier, prefix reuse,
    preemption and an elastic scale-up; then bench_ssm's legs for
    mamba2-370m and qwen3-1.7b (``SSM_LEG_LAYERS``) in bf16 and float32.
    Every launch count is
    set to 0 before and read after; each kernel of the two paths must have
    run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import (crc32_op, flash_chunk_op, flash_seq_op,
                                     launch_counts, paged_attention_op,
                                     reset_launch_counts, ssd_scan_op)
    from repro_torch.weights import init_params
    reset_launch_counts()
    chaos = {}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config("qwen3-1.7b").replace(attn_impl="hopper",
                                               dtype=dtype)
        params = init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        chaos[dtype] = runtime_chaos(cfg, params)
        if dtype == "float32":
            check_corrupt_wire(cfg, params)
            runtime_deflection(cfg, params)
            runtime_prefix(cfg, params)
            runtime_preemption(cfg, params)
            runtime_elastic(cfg, params)
        del params
        free_card()
    for dtype in ("bfloat16", "float32"):
        for arch in ("mamba2-370m", "qwen3-1.7b"):
            runtime_ssm_legs(arch, dtype)
    counts = launch_counts()
    log({"runtime_phase": {"card": smi,
                           "launches": counts,
                           "chaos_streams_equal": {
                               k: v["streams_equal"]
                               for k, v in chaos.items()}}})
    idle = [w.__name__ for w in (flash_seq_op, flash_chunk_op,
                                 paged_attention_op, ssd_scan_op, crc32_op)
            if counts[w.__name__] == 0]
    if idle:
        raise AssertionError(f"kernels never launched in the runtime "
                             f"phase: {idle}")
    return counts


# ----------------------------------------------------------------- sim


PROFILE_LENGTHS = (16, 32, 64, 128, 256, 1024)
# measured / coded bounds for the InstanceProfile defaults, which are the
# medians of this phase's measurements on the H100 (PERF.md section 5):
# the runs' spread around them (flop_eff, mem_eff within 2%; overhead
# 0.91-1.26; link_bw 1.00-1.04 and link_latency 0.67-1.16, pinned), widened
DEFAULT_BANDS = {"flop_eff": (0.9, 1.1), "mem_eff": (0.9, 1.1),
                 "overhead": (2 / 3, 1.5), "hbm_bytes": (1.0, 1.0),
                 "link_bw": (2 / 3, 1.5), "link_latency": (0.5, 2.0)}
# spike's rate scale per simulated preset (10 s of trace): the least of
# x48, x96, x192, x256 at which the default profile's 4-card instances
# flip a pool under arrow and scale up under arrow_elastic
SIM_RATES = {"qwen3-1.7b": 96.0, "mamba2-370m": 256.0,
             "recurrentgemma-9b": 48.0, "olmoe-1b-7b": 96.0}


def engine_samples(cluster, cfg, params, fused):
    """What the cost model is held against, from the engine on the card at
    full width: profile_prefill samples (the engine's own TTFT profiling
    pass, longer prompts added), the fused phase's TPOT with its decode
    contexts (prompt + half the 32 outputs), the per-pass floor (the median
    token interval of a lone 16-token request on the idle cluster, host
    included) and, for the dense path, the device time of one decode step
    at the fused phase's batch (torch.profiler)."""
    from repro_torch.core import Request
    prompts = sorted(h.req.input_len for h in fused.handles)
    out = {"prefill": cluster.instances[0].profile_prefill(PROFILE_LENGTHS),
           "ctx": [n + 16 for n in prompts],
           "tpot_p50_s": fused.percentile("tpot", 0.5),
           "tpot_p90_s": fused.percentile("tpot", 0.9)}
    prompt = np.random.default_rng(13).integers(
        1, cfg.vocab_size, size=16).astype(np.int32)
    h = cluster.submit(Request(rid=999, arrival=0.0, input_len=16,
                               output_len=33), prompt=prompt)
    cluster.drain(timeout=600.0)
    out["pass_floor_s"] = float(np.median(np.diff(h.req.token_times)))
    if cfg.family == "dense":
        out["decode_step_ms"] = decode_step_ms(cfg, params, out["ctx"])
    log({"engine_samples": cfg.arch_id, **out})
    return out


def decode_step_ms(cfg, params, ctx):
    """(device ms, call ms) of ``dense.decode_step`` on the kernels at batch
    len(ctx) over a 1024-slot cache, each row at its context length."""
    from repro_torch.models import dense
    from repro_torch.weights import torch_dtype
    dev = torch.device("cuda")
    c = cfg.replace(attn_impl="hopper")
    B, C = len(ctx), 1024
    shape = (cfg.n_layers, B, C, cfg.n_kv_heads, cfg.head_dim_)
    cache = {"k": torch.zeros(shape, dtype=torch_dtype(cfg.dtype),
                              device=dev),
             "pos_map": torch.full((B, C), -1, dtype=torch.int32,
                                   device=dev)}
    cache["v"] = torch.zeros_like(cache["k"])
    x = dense.embed_tokens(c, params, torch.ones((B, 1), dtype=torch.int32,
                                                 device=dev))
    pos = torch.tensor(ctx, device=dev)
    ms = time_ms(lambda: dense.decode_step(c, params, cache, x, pos), [()],
                 20)
    del cache
    torch.cuda.empty_cache()
    return ms


def graph_ms(fn, n: int, calls: int, reps: int = 5) -> float:
    """Median over ``reps`` replays of the CUDA-event time per call of
    ``fn(i)``, with ``calls`` calls cycling i through ``n`` input copies
    captured in one CUDA graph (after a warm-up on a side stream), so the
    host's launch time (~25 us a call there) leaves no gap between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i % n)
    times = []
    for r in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        if r:
            times.append(start.elapsed_time(end) / calls)
    del graph
    return float(np.median(times))


def copy_ms(dst, src, iters: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` windows of the CUDA-event time per eager
    ``dst.copy_(src)`` over ``iters`` copies, after a warm-up window."""
    times = []
    for r in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            dst.copy_(src)
        end.record()
        torch.cuda.synchronize()
        if r:
            times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def round_trip_s(slots, L: int, reps: int = 5) -> dict:
    """One migration of an ``L``-token context between two slots of
    ``slots``: ``extract_state`` (device to host, into pinned host buffers
    from PyTorch's caching host allocator, which hands freed blocks out
    again) then ``place_state`` (host to device), as export_state /
    import_state move it, synchronised. Medians over ``reps`` trips after
    a warm-up trip of the round trip's seconds, of each half's, and of the
    same device-to-host copy into pageable host buffers that stay resident
    across trips (``d2h_resident_s``): what the copy cost before the
    staging was pinned, on a host whose pages were already touched."""
    slots.alloc(0)
    slots.alloc(1)
    slots.len_of[0] = L
    payload, _ = slots.extract_state(0)
    rows = [t.to("cuda") for t in payload]
    resident = [torch.zeros_like(t) for t in payload]
    trips = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload, n = slots.extract_state(0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        slots.place_state(1, payload, n)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for h, d in zip(resident, rows):
            h.copy_(d)
        torch.cuda.synchronize()
        trips.append((t2 - t0, t1 - t0, t2 - t1, time.perf_counter() - t2))
    slots.release(0)
    slots.release(1)
    med = np.median(np.array(trips[1:]), axis=0)
    return {"bytes": sum(t.numel() * t.element_size() for t in payload),
            "s": float(med[0]), "d2h_s": float(med[1]),
            "h2d_s": float(med[2]), "d2h_resident_s": float(med[3])}


def measure_link() -> dict:
    """The migration link's constants: the payloads' round trips through
    pinned host memory (qwen3 at 1, 117, 579 and 1024 tokens, mamba2 and
    recurrentgemma at one context each); latency is the smallest payload's
    round trip, the rate the least-squares slope of the others' times
    above it."""
    from repro_torch.configs import get_config
    from repro_torch.engine.state_slots import make_state_slots
    dev = torch.device("cuda")
    trips = []
    for arch, lengths in (("qwen3-1.7b", (1, 117, 579, 1024)),
                          ("mamba2-370m", (600,)),
                          ("recurrentgemma-9b", (600,))):
        slots = make_state_slots(get_config(arch), 2, 1024, dev)
        for L in lengths:
            trips.append({"arch": arch, "tokens": L,
                          **round_trip_s(slots, L)})
        del slots
        torch.cuda.empty_cache()
    latency = trips[0]["s"]
    link_bw = sum(r["bytes"] ** 2 for r in trips[1:]) / sum(
        r["bytes"] * (r["s"] - latency) for r in trips[1:])
    return {"round_trips": trips, "link_latency": latency,
            "link_bw": link_bw}


def measure_card():
    """The cost model's per-card constants, measured: a bf16 GEMM at
    qwen3-1.7b's MLP shapes (2048 -> 6144) at M = 256 (a prefill chunk)
    and M = 8 (a decode batch), cycling through eight weight copies (201
    MB, four times the L2) so each call reads its weights from device
    memory, timed in CUDA graphs; and a 1 GiB device-to-device copy."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    K, N = 2048, 6144
    ws = [torch.randn(K, N, generator=g, device=dev).to(torch.bfloat16)
          for _ in range(8)]
    gemm = {}
    for M in (256, 8):
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        ms = graph_ms(lambda i: torch.matmul(x, ws[i], out=y), len(ws), 200)
        gemm[M] = {"ms": ms, "flops_per_s": 2.0 * M * K * N / ms * 1e3,
                   "bytes_per_s": 2.0 * (M * K + K * N + M * N) / ms * 1e3}
    del ws
    src = torch.empty(2**29, dtype=torch.bfloat16, device=dev).normal_(
        generator=g)
    dst = torch.empty_like(src)
    # eager, as the engine issues its copies (a 0.7 ms copy leaves the
    # host no gap to show; a CUDA graph's memcpy node runs on the copy
    # engine, 0.88 ms)
    ms = copy_ms(dst, src)
    copy = {"bytes": 2 * src.numel() * 2, "ms": ms,
            "bytes_per_s": 2 * src.numel() * 2 / ms * 1e3}
    del src, dst
    return {"gemm": gemm, "copy": copy,
            "hbm_bytes": torch.cuda.get_device_properties(0).total_memory}


def measure_profile(obs, smi: str, link_fresh: dict) -> dict:
    """The cost model's constants measured on the card, in the engine's
    process after its paths have served, logged beside the coded defaults
    and beside ``link_fresh`` (the link measured before any engine ran);
    fails if a measured rate exceeds its coded peak by more than 5%, or a
    constant leaves its ``DEFAULT_BANDS`` band. Overhead (a) is the dense
    decode step's device time beyond the model's rate terms at the
    measured efficiencies."""
    from repro_torch.configs import get_config
    from repro_torch.sim import CostModel, InstanceProfile

    m = {**measure_card(), **measure_link()}
    coded = InstanceProfile()
    flop_eff = m["gemm"][256]["flops_per_s"] / coded.peak_flops
    mem_eff = m["copy"]["bytes_per_s"] / coded.hbm_bw
    cfg = get_config("qwen3-1.7b")
    o = obs["qwen3-1.7b"]
    rates = InstanceProfile(chips=1, flop_eff=flop_eff, mem_eff=mem_eff,
                            overhead=0.0)
    roof_s = CostModel(cfg, rates).iteration_time([], o["ctx"])
    overhead = o["decode_step_ms"][0] / 1e3 - roof_s
    measured = {"flop_eff": flop_eff, "mem_eff": mem_eff,
                "overhead": max(overhead, 0.0),
                "hbm_bytes": m["hbm_bytes"], "link_bw": m["link_bw"],
                "link_latency": m["link_latency"]}
    log({"cost_model_constants": {
        "card": smi, "measured": measured,
        "coded": {k: getattr(coded, k) for k in measured},
        "peaks": {"peak_flops": coded.peak_flops, "hbm_bw": coded.hbm_bw},
        "gemm": m["gemm"], "copy": m["copy"],
        "round_trips": m["round_trips"],
        "link_before_engine": link_fresh,
        "decode_step": {"ctx": o["ctx"], "device_ms": o["decode_step_ms"][0],
                        "call_ms": o["decode_step_ms"][1],
                        "roofline_ms": roof_s * 1e3,
                        "overhead_a_ms": overhead * 1e3},
        "pass_floor_b_ms": {a: v["pass_floor_s"] * 1e3
                            for a, v in obs.items()}}})
    over = {name: rate / peak for name, rate, peak in (
        ("gemm_m256_flops", m["gemm"][256]["flops_per_s"], coded.peak_flops),
        ("gemm_m8_bytes", m["gemm"][8]["bytes_per_s"], coded.hbm_bw),
        ("copy_bytes", m["copy"]["bytes_per_s"], coded.hbm_bw))
        if rate > 1.05 * peak}
    if over:
        raise AssertionError(f"measured rates exceed the coded peaks by "
                             f"more than 5% (rate / peak): {over}")
    off = {k: measured[k] / getattr(coded, k)
           for k, (lo, hi) in DEFAULT_BANDS.items()
           if not lo <= measured[k] / getattr(coded, k) <= hi}
    if off:
        raise AssertionError(f"measured constants outside their bands "
                             f"around the coded defaults (measured / "
                             f"coded): {off}")
    return measured


def sim_phase(obs, smi: str, link_fresh: dict):
    """The cost model's constants measured on the card against the coded
    defaults; the model's prefill and decode times against the engine's;
    then the port's Simulator, twice per preset and policy."""
    from repro_torch.configs import get_config
    from repro_torch.core import SLO, replay_trace
    from repro_torch.sim import CostModel, InstanceProfile, Simulator
    from repro_torch.traces import TRACE_PRESETS, load_trace

    measure_profile(obs, smi, link_fresh)
    for arch, o in obs.items():
        cm = CostModel(get_config(arch), InstanceProfile(chips=1))
        log({"model_vs_engine": arch, "profile": "InstanceProfile(chips=1)",
             "prefill": [{"tokens": L, "predicted_s": cm.prefill_time(L),
                          "measured_s": t,
                          "ratio": t / cm.prefill_time(L)}
                         for L, t in o["prefill"]],
             "decode": {"batch": len(o["ctx"]),
                        "predicted_s": cm.iteration_time([], o["ctx"]),
                        "tpot_p50_s": o["tpot_p50_s"],
                        "tpot_p90_s": o["tpot_p90_s"],
                        "ratio_p50": o["tpot_p50_s"]
                        / cm.iteration_time([], o["ctx"])},
             "pass_floor_s": o["pass_floor_s"]})

    p = TRACE_PRESETS["spike"]
    for arch in (*obs, "olmoe-1b-7b"):
        for policy in ("arrow", "arrow_elastic"):
            runs = []
            for _ in range(2):
                t0 = time.perf_counter()
                sim = Simulator(get_config(arch), n_instances=4, n_prefill=2,
                                policy=policy,
                                slo=SLO(p.slo_ttft, p.slo_tpot))
                replay_trace(sim, load_trace("spike",
                                             rate_scale=SIM_RATES[arch],
                                             seed=0, duration=10.0))
                rep = sim.drain()
                runs.append((rep.summary(), sim.migration_log, rep.flips,
                             rep.scaling.get("scale_ups", 0),
                             time.perf_counter() - t0))
                log(f"[sim {arch} spike x{SIM_RATES[arch]} {policy}] "
                    f"{rep.summary()}")
            log({"sim": arch, "policy": policy, "rate_scale": SIM_RATES[arch],
                 "wall_s": [r[-1] for r in runs],
                 "migrations": len(runs[0][1]), "flips": runs[0][2],
                 "scale_ups": runs[0][3]})
            if runs[0][:-1] != runs[1][:-1]:
                raise AssertionError(f"sim {arch} {policy}: two runs of the "
                                     f"same trace differ")
            if runs[0][2] == 0 or (policy == "arrow_elastic"
                                   and runs[0][3] == 0):
                raise AssertionError(f"sim {arch} {policy}: no flip or no "
                                     f"scale-up at x{SIM_RATES[arch]}")


# ------------------------------------------------------------ zoo, train


# the model zoo's other families at full published width; dbrx-132b at 2
# of its 40 layers (264 GB of bf16 weights do not fit one 80 GB card)
ZOO = (("qwen2-vl-2b", None), ("olmoe-1b-7b", None),
       ("whisper-medium", None), ("dbrx-132b", 2))
ZOO_B, ZOO_STEPS = 2, 8


def zoo_inputs(cfg, params, S: int, dev):
    """Tokens (B, S + 8), the prefill batch of the first S (the stub
    frontends' embeddings as the trainer draws them; the VLM's from the
    token table, so that its prefill and decode see the same inputs), and
    the 8 decode batches of the rest."""
    from repro_torch.launch.train import make_batch_for
    from repro_torch.models import dense
    rng = np.random.default_rng(21)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(ZOO_B, S + ZOO_STEPS)).astype(np.int32)
    ).to(dev)
    batch = make_batch_for(cfg, tokens[:, :S])
    if cfg.family == "vlm":
        batch["embeds"] = dense.embed_tokens(cfg, params, tokens[:, :S])
    dec = []
    for i in range(ZOO_STEPS):
        pos = torch.full((ZOO_B,), S + i, dtype=torch.int32, device=dev)
        d = {"token": tokens[:, S + i:S + i + 1], "pos": pos}
        if cfg.family == "vlm":
            d["positions"] = pos[:, None, None].expand(ZOO_B, 3, 1)
        dec.append(d)
    return tokens, batch, dec


def synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def zoo_run(model, params, batch, dec, C: int):
    """loss, prefill (capacity C) and the decode steps, each timed (host
    clock around synchronised calls). Returns (loss, prefill logits,
    decode logits (B, steps, V), prefill ms, decode ms per step)."""
    loss = model.loss(params, batch)
    logits, pre_ms = synced_ms(lambda: model.prefill(params, batch, C))
    logits, cache = logits
    outs, step_ms = [], []
    for d in dec:
        (lg, cache), ms = synced_ms(lambda: model.decode(params, cache, d))
        outs.append(lg)
        step_ms.append(ms)
    del cache
    return loss, logits, torch.cat(outs, dim=1), pre_ms, step_ms


def check_zoo_outputs(cfg, loss, outs) -> None:
    """Every output finite; the first loss that of random logits: for
    logits ~ N(0, s2) over V classes the expected cross-entropy is about
    ln V + s2 / 2 (s2 grows with d_model: 1.23 at dbrx-132b's 6144, since
    the unembedding's 0.02-scale columns meet a unit-RMS hidden state), so
    the loss must lie within 1 of ln V + var(prefill logits) / 2."""
    for name, t in outs.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"{cfg.arch_id} {name}: non-finite output")
    lnv = math.log(cfg.padded_vocab)
    expect = lnv + 0.5 * float(outs["prefill"].float().var())
    log({"zoo_loss": cfg.arch_id, "loss": float(loss), "ln_V": lnv,
         "expected": expect})
    if not (math.isfinite(float(loss)) and abs(float(loss) - expect) <= 1.0):
        raise AssertionError(f"{cfg.arch_id}: first loss {float(loss)} is "
                             f"not within 1 of {expect}")


def vlm_path(cfg, params, batch, dec, tokens, C: int):
    """qwen2-vl-2b on the kernels (counted: every launch count set to 0
    just before, read just after) and on the reference attention: logits
    held together (compare_logits, LOGIT_TOL), and teacher forcing: the
    decode steps' logits against a full prefill over all S + 8 tokens at
    the same positions. Returns the kernel run's outputs and counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model, dense
    S = batch["embeds"].shape[1]
    hop = build_model(cfg.replace(attn_impl="hopper"))
    reset_launch_counts()
    run = zoo_run(hop, params, batch, dec, C)
    n = S + ZOO_STEPS
    full, _ = hop.prefill(params, {
        "embeds": dense.embed_tokens(cfg, params, tokens),
        "positions": torch.arange(n, device=tokens.device)[None, None]
        .expand(ZOO_B, 3, n)}, None)
    counts = launch_counts()
    ref = zoo_run(build_model(cfg), params, batch, dec, C)
    compare_logits(cfg, ("forward_seq", "decode_step"),
                   {"hopper": run[1:3], "reference": ref[1:3]})
    compare_logits(cfg, ("teacher_forcing",),
                   {"hopper": (run[2],), "reference": (full[:, S:],)})
    log({"zoo_launches": cfg.arch_id, **counts})
    for w in ("flash_seq_op", "paged_attention_op"):
        if counts[w] == 0:
            raise AssertionError(f"{w} never launched on the "
                                 f"{cfg.arch_id} path")
    return run, counts


def check_vlm_kernels(cfg, S: int, C: int, lengths) -> None:
    """Both attention kernels at qwen2-vl-2b's shapes (G = 6) against their
    plain versions, bf16, BF16_TOL: flash over the zoo's prefill, paged
    decode over its cache at its last decode lengths. Logged beside the
    kernels line's qwen3-1.7b rows (not launches of the main path)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_seq_op, paged_attention_op
    from repro_torch.kernels.flash_prefill import flash_prefill_ref
    from repro_torch.kernels.paged_attention import paged_attention_ref
    from repro_torch.kernels.paged_attention.ops import plan as paged_plan
    dev = torch.device("cuda")
    H, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def bhsd(t):
        return t.transpose(1, 2).contiguous()

    def sdpa(q, k, v, mask=None, causal=False):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              is_causal=causal,
                                              enable_gqa=True)

    B = ZOO_B
    q, k, v = rnd(B, S, H, D), rnd(B, S, Hk, D), rnd(B, S, Hk, D)
    got = flash_seq_op(q, k, v)
    want = flash_prefill_ref(bhsd(q), bhsd(k), bhsd(v)).transpose(1, 2)
    sets = copies([q, k, v])
    lib = [tuple(bhsd(t) for t in s) for s in sets]
    pairs = B * S * (S + 1) // 2
    rows = [dict(name="flash_prefill", shape=f"q({B},{S},{H},{D}) "
                 f"kv({B},{S},{Hk},{D}) bf16 causal",
                 max_abs_err=max_err(got, want), ok=within(got, want),
                 ms=time_ms(lambda a, b, c: flash_seq_op(a, b, c), sets, 50),
                 plain_ms=time_ms(lambda a, b, c: flash_prefill_ref(a, b, c),
                                  lib, 10),
                 library_ms=time_ms(lambda a, b, c: sdpa(a, b, c,
                                                         causal=True),
                                    lib, 50),
                 bound=bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                             4.0 * D * H * pairs))]
    page = 128
    MP = C // page
    qd, kp, vp = rnd(B, H, D), rnd(B * MP, page, Hk, D), \
        rnd(B * MP, page, Hk, D)
    pt = (torch.arange(B, device=dev)[:, None] * MP
          + torch.arange(MP, device=dev)[None, :]).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = paged_attention_op(qd, kp, vp, pt, ln)
    want = paged_attention_ref(qd, kp, vp, pt, ln)
    sets = copies([qd, kp, vp])
    dmask = (torch.arange(C, device=dev)[None, :]
             < ln[:, None].long())[:, None, None, :]
    lib = [(a[:, :, None], b.view(B, C, Hk, D).transpose(1, 2).contiguous(),
            c.view(B, C, Hk, D).transpose(1, 2).contiguous())
           for a, b, c in sets]
    live = sum(lengths)
    rows.append(dict(
        name="paged_attention", shape=f"q({B},{H},{D}) pages({B * MP},"
        f"{page},{Hk},{D}) bf16, lengths {list(lengths)}",
        plan=paged_plan(B, H, Hk, D, page, MP)._asdict(),
        max_abs_err=max_err(got, want), ok=within(got, want),
        ms=time_ms(lambda a, b, c: paged_attention_op(a, b, c, pt, ln),
                   sets, 200),
        plain_ms=time_ms(lambda a, b, c: paged_attention_ref(
            a, b, c, pt, ln), sets, 50),
        library_ms=time_ms(lambda a, b, c: sdpa(a, b, c, mask=dmask), lib,
                           200),
        bound=bound(2 * (2 * qd.numel() + 2 * live * Hk * D)
                    + 4 * (pt.numel() + B), 4.0 * D * H * live)))
    for r in rows:
        b_ms, b_by = r.pop("bound")
        log({"kernel_check_g6": r.pop("name"), **{
            k: (v[0] if isinstance(v, tuple) else v) for k, v in r.items()},
            "call_ms": r["ms"][1], "bound_ms": b_ms, "bound_by": b_by,
            "tol": f"atol=rtol={BF16_TOL}", "library": "sdpa"})
        if not r["ok"]:
            raise AssertionError(f"{r['shape']}: kernel differs from its "
                                 f"plain version by {r['max_abs_err']}")


def check_moe_ffn(arch: str) -> None:
    """One layer's moe_ffn at full width in float32 (TF32 off), B 2, S 256,
    on the card against the same function on the CPU: the share of tokens
    whose K experts agree >= 0.999, outputs on those tokens within 1e-4 of
    max |ref|, aux within 1e-5."""
    from repro_torch.models import moe
    from repro_torch.weights import param_shapes
    cfg = get_cfg(arch).replace(dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(3)
    p = {path[len("layers/moe/"):]: torch.randn(shape[1:], generator=g,
                                                 device="cuda") * 0.02
         for path, shape, _ in param_shapes(cfg)
         if path.startswith("layers/moe/")}
    x = torch.randn((2, 256, cfg.d_model), generator=g, device="cuda")
    with torch.no_grad():
        (y, aux), ms = synced_ms(lambda: moe.moe_ffn(cfg, p, x))
        top_e = moe.route(cfg, p, x)[2].reshape(-1, cfg.moe.top_k)
        p_cpu = {k: v.cpu() for k, v in p.items()}
        y_ref, aux_ref = moe.moe_ffn(cfg, p_cpu, x.cpu())
        top_ref = moe.route(cfg, p_cpu, x.cpu())[2].reshape(-1,
                                                            cfg.moe.top_k)
    same = (top_e.cpu() == top_ref).all(dim=-1)
    share = float(same.float().mean())
    scale = float(y_ref.abs().max())
    err = float((y.cpu() - y_ref).reshape(-1, cfg.d_model)[same].abs().max())
    aux_err = abs(float(aux) - float(aux_ref))
    log({"moe_ffn_check": arch, "shape": [2, 256, cfg.d_model],
         "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
         "capacity": moe.capacity(cfg, 512), "same_experts_share": share,
         "max_abs_err": err, "max_abs_ref": scale, "tol": 1e-4 * scale,
         "aux": float(aux), "aux_err": aux_err, "card_ms_first_call": ms})
    if share < 0.999 or err > 1e-4 * scale or aux_err > 1e-5:
        raise AssertionError(f"{arch} moe_ffn on the card differs from the "
                             f"CPU: share {share}, err {err}, aux {aux_err}")
    del p, p_cpu
    gc.collect()
    torch.cuda.empty_cache()


def get_cfg(arch: str, layers=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else cfg.replace(n_layers=layers)


def zoo_phase(smi: str) -> dict:
    """build_model for the zoo's other families at full width (bf16 random
    weights, seed 0): loss, prefill (B 2, S 512; whisper S 224 of its 448)
    and 8 decode steps each, outputs finite and the first loss that of a
    random model; qwen2-vl-2b on the kernels, held to the reference and to
    teacher forcing, with both kernels held at its shapes; moe_ffn on the
    card held to the CPU at olmoe and dbrx width. No teacher-forcing check
    for MoE: at capacity_factor 1.25 a prefill may drop (token, expert)
    pairs that a one-token decode step keeps, so the two differ by design.
    Returns the qwen2-vl-2b path's launch counts."""
    from repro_torch.models import build_model
    from repro_torch.weights import init_params
    dev = torch.device("cuda")
    counts = {}
    for arch, layers in ZOO:
        cfg = get_cfg(arch, layers)
        S = 224 if cfg.family == "encdec" else 512
        C = 256 if cfg.family == "encdec" else 1024
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        info = {"arch": arch, "layers": cfg.n_layers,
                "params": sum(p.numel() for p in params.values()),
                "param_bytes": nbytes(*params.values()), "B": ZOO_B, "S": S,
                "capacity": C, "card": smi}
        if layers is not None:
            info["cut"] = (f"depth only: {layers} of "
                           f"{get_cfg(arch).n_layers} layers (full width)")
        with torch.no_grad():
            tokens, batch, dec = zoo_inputs(cfg, params, S, dev)
            if cfg.family == "vlm":
                run, counts = vlm_path(cfg, params, batch, dec, tokens, C)
            else:
                run = zoo_run(build_model(cfg), params, batch, dec, C)
        loss, logits, dec_logits, pre_ms, step_ms = run
        check_zoo_outputs(cfg, loss, {"prefill": logits,
                                      "decode": dec_logits})
        log({"zoo": {**info, "loss": float(loss), "prefill_ms": pre_ms,
                     "decode_step_ms": step_ms,
                     "decode_step_ms_median": float(np.median(step_ms[1:]))}})
        del params, run, logits, dec_logits, batch, dec
        gc.collect()
        torch.cuda.empty_cache()
        if cfg.family == "vlm":
            check_vlm_kernels(cfg, S, C, [S + ZOO_STEPS - 1, S + ZOO_STEPS])
    for arch in ("olmoe-1b-7b", "dbrx-132b"):
        check_moe_ffn(arch)
    return counts


def profile_train_step(cfg, params) -> None:
    """One more step of the trainer's loop (batch 8 x 128: loss, backward,
    AdamW from fresh moments) under torch.profiler: its wall time, the
    device's busy time and the kernels that take it, by name."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init, adamw_update
    model = build_model(cfg)
    dev = next(iter(params.values())).device
    tokens = torch.randint(1, cfg.vocab_size, (8, 128), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(6))
    opt = adamw_init(params)
    for p in params.values():
        p.requires_grad_(True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = model.loss(params, {"tokens": tokens})
        loss.backward()
        adamw_update({k: p.detach() for k, p in params.items()},
                     {k: p.grad for k, p in params.items()}, opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log({"train_step_profile": {"arch": cfg.arch_id, "wall_ms": wall * 1e3,
                                "device_busy_ms": busy,
                                "idle_share": 1.0 - busy / (wall * 1e3),
                                "top": [[k[:80], ms, n]
                                        for k, ms, n in rows[:12]]}})


def train_phase(smi: str) -> None:
    """repro_torch.launch.train at full width: qwen3-1.7b, 20 steps of
    batch 8 x 128 tokens (bf16, reference attention), every loss finite
    and the mean of the last 5 below the first 5's (the trainer's own
    "improved"); its checkpoint read back by the port's loader bit for
    bit. Then 3 steps of olmoe-1b-7b at 2 of its 16 layers (full width):
    finite losses, and one more backward whose gradients through the MoE
    scatter and gather must all be finite."""
    import tempfile

    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.weights import load_jax_checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "qwen3.msgpack")
        t0 = time.perf_counter()
        out = train.main(["--arch", "qwen3-1.7b", "--steps", "20", "--batch",
                          "8", "--seq", "128", "--log-every", "5",
                          "--device", "cuda", "--ckpt", ck])
        wall = time.perf_counter() - t0
        losses = out["losses"]
        cfg = get_cfg("qwen3-1.7b")
        back = load_jax_checkpoint(ck, cfg, "cpu")
    same = all(torch.equal(back[k].view(torch.int16),
                           v.cpu().view(torch.int16))
               for k, v in out["params"].items())
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log({"train": {"arch": "qwen3-1.7b", "steps": 20, "batch": 8, "seq": 128,
                   "losses": losses, "first5": first, "last5": last,
                   "tok_per_s": out["tok_per_s"], "wall_s": wall,
                   "checkpoint_bit_exact": same, "card": smi}})
    if not (all(math.isfinite(x) for x in losses) and last < first):
        raise AssertionError(f"qwen3-1.7b training: losses {losses}")
    if not same:
        raise AssertionError("the trainer's checkpoint did not read back "
                             "bit for bit")
    del back
    profile_train_step(cfg, out["params"])
    del out
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_cfg("olmoe-1b-7b", 2)
    out = train.main(["--arch", "olmoe-1b-7b", "--steps", "3", "--batch", "8",
                      "--seq", "128", "--log-every", "1", "--device", "cuda"],
                     cfg_override=cfg)
    params = out["params"]
    for p in params.values():
        p.requires_grad_(True)
    tokens = torch.randint(1, cfg.vocab_size, (8, 128), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(5))
    build_model(cfg).loss(params, {"tokens": tokens}).backward()
    bad = [k for k, p in params.items() if p.grad is None
           or not torch.isfinite(p.grad.float()).all()]
    log({"train": {"arch": "olmoe-1b-7b", "layers": 2, "losses": out["losses"],
                   "tok_per_s": out["tok_per_s"], "grads_finite": not bad,
                   "card": smi}})
    if bad or not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"olmoe-1b-7b training: losses "
                             f"{out['losses']}, bad gradients {bad}")
    del out, params
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------ distributed


DIST_TRAIN = (3, 8, 128)        # steps, batch, seq
DIST_B, DIST_S, DIST_C, DIST_STEPS = 2, 512, 1024, 8
DRYRUNS = (("qwen3-1.7b", "train_4k", ""), ("qwen3-1.7b", "prefill_32k", ""),
           ("qwen3-1.7b", "decode_32k", ""), ("olmoe-1b-7b", "train_4k",
                                               "moe_ep"))


def timed(fn):
    """(out, wall ms, device ms) of one synchronised call: the host clock
    around it, and the device time of every kernel it launched
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    return out, wall, busy


def dist_train(cfg, mesh, smi: str) -> None:
    """make_train_step on the 1x1 mesh: DIST_TRAIN steps from the trainer's
    seed-0 weights and its synthetic batches (seed 1), whose losses must
    match launch/train.py's on the same steps within 1e-3 relative."""
    from repro_torch.configs import InputShape
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.distributed import sharding as shd, steps as dsteps
    from repro_torch.launch import train
    from repro_torch.optim import adamw_init
    from repro_torch.weights import init_params
    n, B, S = DIST_TRAIN
    dev = torch.device("cuda")
    ref = train.main(["--arch", cfg.arch_id, "--steps", str(n), "--batch",
                      str(B), "--seq", str(S), "--log-every", "1",
                      "--device", "cuda"])["losses"]
    gc.collect()
    torch.cuda.empty_cache()
    _, step = dsteps.make_train_step(cfg, InputShape("train_card", S, B,
                                                     "train"))
    params = shd.distribute_params(init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev), mesh)
    opt = adamw_init(params)
    pipe = iter(SyntheticTokenPipeline(cfg.vocab_size, S, B, seed=1))
    losses, times = [], []
    for _ in range(n):
        batch = dsteps.shard_batch(
            {"tokens": torch.from_numpy(next(pipe)["tokens"]).to(dev)}, mesh)
        (params, opt, loss), wall, busy = timed(
            lambda: step(params, opt, batch))
        losses.append(float(loss.full_tensor()))
        times.append({"wall_ms": wall, "device_ms": busy})
    diff = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    log({"dist_train": {"arch": cfg.arch_id, "mesh": "1x1", "steps": n,
                        "batch": B, "seq": S, "losses": losses,
                        "trainer_losses": ref, "max_rel_diff": diff,
                        "steps_ms": times, "card": smi}})
    if not diff <= 1e-3:
        raise AssertionError(f"make_train_step losses {losses} differ from "
                             f"the trainer's {ref}")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()


def dist_serve(cfg, mesh, smi: str) -> dict:
    """make_prefill_step (B 2 x 512, capacity 1024) and DIST_STEPS
    make_decode_step steps on the 1x1 mesh, once on the reference attention
    and once on the kernels, each held to build_model's own prefill and
    decode on the same weights (LOGIT_TOL x max|ref|); every launch count
    set to 0 before each step and read after it: the kernels must have run
    under the DTensor wrappers. Returns the kernels' launches."""
    from repro_torch.configs import InputShape
    from repro_torch.distributed import sharding as shd, steps as dsteps
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.weights import init_params
    dev = torch.device("cuda")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(23)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(DIST_B, DIST_S + DIST_STEPS)).astype(
            np.int32)).to(dev)
    dec = [{"token": tokens[:, DIST_S + i:DIST_S + i + 1],
            "pos": torch.full((DIST_B,), DIST_S + i, dtype=torch.int32,
                              device=dev)} for i in range(DIST_STEPS)]
    model = build_model(cfg)
    with torch.no_grad():
        (ref, cache), wall, busy = timed(lambda: model.prefill(
            params, {"tokens": tokens[:, :DIST_S]}, DIST_C))
        ref = [ref[:, -1]]
        plain = {"prefill": {"wall_ms": wall, "device_ms": busy},
                 "decode": []}
        for d in dec:
            (lg, cache), wall, busy = timed(
                lambda: model.decode(params, cache, d))
            ref.append(lg[:, 0])
            plain["decode"].append({"wall_ms": wall, "device_ms": busy})
    del cache
    dp = shd.distribute_params(params, mesh)
    del params
    shape = InputShape("prefill_card", DIST_C, DIST_B, "prefill")
    counts = {"flash_seq_op": 0, "paged_attention_op": 0}
    for impl in ("reference", "hopper"):
        c = cfg.replace(attn_impl=impl)
        _, prefill = dsteps.make_prefill_step(c, shape)
        _, decode = dsteps.make_decode_step(c, shape)
        batch = dsteps.shard_batch({"tokens": tokens[:, :DIST_S]}, mesh)
        reset_launch_counts()
        (last, cache), wall, busy = timed(lambda: prefill(dp, batch))
        launches = {"prefill": launch_counts()}
        outs = [last.full_tensor()]
        times = {"prefill": {"wall_ms": wall, "device_ms": busy},
                 "decode": []}
        decode_counts = {}
        for d in dec:
            b = dsteps.shard_batch(d, mesh)
            reset_launch_counts()
            (lg, cache), wall, busy = timed(lambda: decode(dp, cache, b))
            for k, v in launch_counts().items():
                decode_counts[k] = decode_counts.get(k, 0) + v
            outs.append(lg.full_tensor()[:, 0])
            times["decode"].append({"wall_ms": wall, "device_ms": busy})
        launches["decode"] = decode_counts
        del cache
        errs = [max_err(o, r) / float(r.float().abs().max())
                for o, r in zip(outs, ref)]
        log({"dist_serve": {"arch": cfg.arch_id, "mesh": "1x1",
                            "attn_impl": impl, "B": DIST_B, "S": DIST_S,
                            "capacity": DIST_C, "decode_steps": DIST_STEPS,
                            "max_err_over_max_ref": max(errs),
                            "prefill_err": errs[0], "launches": launches,
                            "steps_ms": times,
                            "build_model_ms": plain, "card": smi}})
        if not max(errs) <= LOGIT_TOL:
            raise AssertionError(f"distributed {impl} logits differ from "
                                 f"build_model's: {errs}")
        if impl == "hopper":
            idle = [k for k, n in (("flash_seq_op",
                                    launches["prefill"]["flash_seq_op"]),
                                   ("paged_attention_op",
                                    decode_counts["paged_attention_op"]))
                    if n == 0]
            if idle:
                raise AssertionError(f"kernels never launched under the "
                                     f"DTensor steps: {idle}")
            counts["flash_seq_op"] += launches["prefill"]["flash_seq_op"]
            counts["paged_attention_op"] += \
                decode_counts["paged_attention_op"]
    del dp
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def dist_dryruns(smi: str) -> None:
    """python -m repro_torch.launch.dryrun for each of DRYRUNS on the 16x16
    fake mesh, in subprocesses run side by side off the card (the fake
    process group cannot share this process with the NCCL one); every
    record printed, and any that is not ok fails the phase."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    procs = []
    for arch, shape, opt in DRYRUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--single-pod"]
        if opt:
            cmd += ["--opt", opt]
        procs.append((cmd, time.perf_counter(), subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    bad = []
    for cmd, t0, proc in procs:
        out, err = proc.communicate(timeout=600)
        wall = time.perf_counter() - t0
        paths_ = [ln.split(" ", 1)[1] for ln in out.splitlines()
                  if ln.startswith("[dryrun-record] ")]
        if proc.returncode or len(paths_) != 1:
            bad.append((cmd, proc.returncode, err[-1500:]))
            continue
        rec = json.loads(Path(paths_[0]).read_text())
        log({"dryrun": {k: rec.get(k) for k in (
            "arch", "shape", "mesh", "opts", "status", "flops",
            "bytes_accessed", "collective_bytes", "memory", "trace_s",
            "error")}, "process_wall_s": wall, "card": smi,
            "counted": "per device (rank 0 of the fake 16x16 mesh), off "
                       "the card"})
        if rec["status"] != "ok":
            bad.append((cmd, rec["status"], rec.get("error")))
    if bad:
        raise AssertionError(f"dry-runs failed: {bad}")


def dist_phase(smi: str) -> dict:
    """The distribution layer: the step builders on a 1x1 local mesh (NCCL,
    one rank: the card cannot hold two) at qwen3-1.7b's full width (bf16,
    seed-0 weights) through distribute_params, then the dry-run launcher
    on the fake production mesh. Multi-rank numerics are the CPU tests'
    (gloo). Returns the kernels' launches."""
    from repro_torch.launch.mesh import destroy, make_local_mesh
    t0 = time.perf_counter()
    cfg = get_cfg("qwen3-1.7b")
    mesh = make_local_mesh()
    try:
        dist_train(cfg, mesh, smi)
        counts = dist_serve(cfg, mesh, smi)
    finally:
        destroy()
    t1 = time.perf_counter()
    dist_dryruns(smi)
    log({"dist_phase_s": {"card": t1 - t0,
                          "dryruns": time.perf_counter() - t1}})
    return counts


def paths():
    """(arch, the kernels its engine path must launch, the profiler tags of
    those kernels) for each path, in the order they run."""
    from repro_torch.kernels import (crc32_op, flash_chunk_op, flash_seq_op,
                                     paged_attention_op, rglru_scan_op,
                                     ssd_scan_op)
    return (("qwen3-1.7b", (flash_seq_op, flash_chunk_op, paged_attention_op,
                            crc32_op),
             ("flash_fwd", "paged_decode", "paged_merge")),
            ("mamba2-370m", (ssd_scan_op, crc32_op), ("ssd_cb", "ssd_chunk",
                                                      "ssd_state")),
            ("recurrentgemma-9b", (rglru_scan_op, crc32_op),
             ("rglru_cluster", "rglru_channel")))


def bench_phase(smi: str) -> dict:
    """repro_torch.bench.bench_kernels on the card (the six kernels at the
    JAX bench's shapes, the main paths' and the migrations', each against
    its plain
    version: one outside its tolerance fails), then repro_torch.bench's
    roofline over the records the distributed phase's dry-runs wrote:
    decode must not be compute-bound. Returns the kernels' launches and
    bench_kernels' rows at the main paths' shapes, by kernel."""
    from repro_torch.bench import bench_kernels, roofline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    rows = bench_kernels.main(["--device", "cuda"])
    counts = launch_counts()
    log({"bench_kernels": rows, "card": smi, "launches": counts})
    idle = [k for k, v in counts.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched by bench_kernels: "
                             f"{idle}")
    roof = roofline.main([])
    log({"roofline": roof, "note": "per device of the fake 16x16 mesh; "
         "memory terms from unfused bytes"})
    decode = [r for r in roof if r.get("shape") == "decode_32k"]
    if not decode or any(r["dominant"] == "compute" for r in decode):
        raise AssertionError(f"decode_32k missing or compute-bound: "
                             f"{decode}")
    return counts, {r["name"]: r for r in rows
                    if r["shape"].startswith(("main_", CRC_MAIN))}


def kernel_row(check: dict, timed: dict, counts: dict) -> dict:
    """A kernel's entry of the kernels line: its kernel check's error, its
    launches, and bench_kernels' device times and bound at the main
    path's shape (its error there too)."""
    return {"name": check["name"], "route": check["route"],
            "source": check["source"], "replaces": check["replaces"],
            "launches": counts[check["wrapper"]],
            "max_abs_err": max(check["max_abs_err"], timed["max_abs_err"]),
            "ms": timed["device_us"] / 1e3,
            "plain_ms": timed["ref_us"] / 1e3,
            "bound_ms": timed["bound_us"] / 1e3,
            "bound_by": timed["bound_by"],
            "library_ms": None if timed["library_us"] is None
            else timed["library_us"] / 1e3}


@contextlib.contextmanager
def part(times: dict, name: str):
    """Put the wall time of the block into ``times[name]``."""
    t0 = time.perf_counter()
    yield
    times[name] = time.perf_counter() - t0


@contextlib.contextmanager
def phase(times: dict, name: str):
    """``part``, and log the phase's wall time as it ends."""
    with part(times, name):
        yield
    log({"phase": name, "wall_s": times[name]})


def main() -> int:
    t_start = time.perf_counter()
    phases = {}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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

    with phase(phases, "build"):
        libs = _build.build(verbose=True)
        for name in libs:
            _build.load(name)
        log({"libs": {k: str(v.relative_to(ROOT)) if ROOT in v.parents
                      else str(v) for k, v in libs.items()}})
    with phase(phases, "link_before_engine"):
        link_fresh = measure_link()
        log({"link_before_engine": link_fresh})
    with phase(phases, "kernel_checks"):
        cases = main_cases()
        rows = check_kernels(get_config("qwen3-1.7b"), cases) \
            + check_scan_kernels(cases) + [check_crc_kernel()]
        del cases
    with phase(phases, "sampler"):
        check_sampler()
    counts, obs = {}, {}
    for arch, expect, tags in paths():
        cfg = get_config(arch)              # full width, bf16
        modes = "fused, speculative" if cfg.family == "dense" else "fused"
        with phase(phases, f"engine {arch} ({modes})"):
            g = torch.Generator(device="cuda").manual_seed(0)
            params = init_params(cfg, g, "cuda")
            log({"arch": arch, "layers": cfg.n_layers,
                 "params": sum(p.numel() for p in params.values()),
                 "param_bytes": nbytes(*params.values())})
            parts = {}
            with part(parts, "model_check"):
                if cfg.family == "dense":
                    check_model(cfg, params)
                else:
                    check_recurrent_model(cfg, params)
            with part(parts, "serve"):
                cluster, c, streams = serve(cfg, params, expect)
            for w in expect:                # crc32 runs on every path
                counts[w.__name__] = counts.get(w.__name__, 0) \
                    + c[w.__name__]
            fused = cluster.report()
            with part(parts, "profile_round"):
                profile_round(cluster, cfg, tags)
            with part(parts, "engine_samples"):
                obs[arch] = engine_samples(cluster, cfg, params, fused)
            del cluster
            if cfg.family == "dense":
                # the kernels line counts every bf16 serve phase of the path
                with part(parts, "step_modes"):
                    modes_run = step_modes(cfg, params, expect, streams)
                for mc, _ in modes_run.values():
                    for w in expect:
                        counts[w.__name__] += mc[w.__name__]
            log({"engine_parts_s": {"arch": arch, **parts}})
            del params                      # free before the next model
            gc.collect()
            torch.cuda.empty_cache()
        if cfg.family == "dense":
            with phase(phases,
                       f"stream_identity {arch} (float32, two modes)"):
                check_stream_identity(cfg, expect)

    with phase(phases, "runtime"):
        runtime_counts = runtime_phase(smi)
    for w in counts:
        counts[w] += runtime_counts[w]
    with phase(phases, "sim"):
        sim_phase(obs, smi, link_fresh)
    with phase(phases, "zoo"):
        zoo_counts = zoo_phase(smi)
    for w in ("flash_seq_op", "paged_attention_op"):
        counts[w] += zoo_counts[w]
    with phase(phases, "train"):
        train_phase(smi)
    with phase(phases, "dist"):
        dist_counts = dist_phase(smi)
    for w in ("flash_seq_op", "paged_attention_op"):
        counts[w] += dist_counts[w]
    with phase(phases, "bench"):
        bench_counts, timed = bench_phase(smi)
    for w in counts:
        counts[w] += bench_counts[w]
    log({"kernels": [kernel_row(r, timed[r["name"]], counts) for r in rows]})
    log({"phases_wall_s": phases, "total_s": time.perf_counter() - t_start,
         "card": smi})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
