"""Times earlier revisions of the port's hand-written kernels beside the
current ones on the card, in turns (old, new, new, old), at chip_smoke.py's
check shapes:

- flash prefill: both flash check shapes of qwen3-1.7b, bf16, with SDPA on
  the same inputs as the yardstick, host time per call broken down, and an
  optional sweep of the kv split count (``--splits``);
- paged decode: q (8,16,128) over pages (64,128,8,128) bf16 with lengths
  1..1024 and a shuffled page table, with SDPA, and an optional sweep of
  the pages a split (``--pps``);
- SSD scan: one 256-token chunk of mamba2-370m (x (1,256,32,64), N=128,
  chunk 128, h0). The old kernel gets B and C repeated per head, as its
  caller did, the new one the group-level tensors;
- RG-LRU scan: one 256-token chunk of recurrentgemma-9b (log_a/gated
  (1,256,4096), h0) and the whole 1024-slot prompt (1,1024,4096), with
  the max error of each kernel against the plain version, the new
  kernel's attributes, ``torch.add`` over the same bytes as a yardstick of
  streaming, and optional variants with the current entry point
  (``--rglru-alt``), each in turns with the current kernel.

Each old source comes from git and is built by nvcc with the port's flags
into a temporary directory:

    git show <commit>:src/repro_torch/kernels/flash_prefill/csrc/flash_prefill.cu > old_flash.cu
    git show <commit>:src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu > old_paged.cu
    git show <commit>:src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu > old_ssd.cu
    git show <commit>:src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu > old_rglru.cu
    python3 tools/kernel_ab.py [--flash old_flash.cu] [--paged old_paged.cu] \\
        [--ssd old_ssd.cu] [--rglru old_rglru.cu] [--iters 200]

``OLD_ENTRY`` lists the C entry points the sources had before their
redesigns (at any commit up to 01c70cf for flash, up to 90943cd for paged
decode and the SSD scan, up to 0b0fa41 for the RG-LRU scan). The old paged
and ssd calls are wrapped as their wrappers were (ctypes signature set,
scratch allocated and ``torch.cuda.current_stream`` read on every call),
so "call ms" compares the wrappers too; the old RG-LRU call as its last
wrapper was (signature set once, raw stream). Times are
chip_smoke.py's: device time per call summed by torch.profiler, and
CUDA-event time per call, over inputs cycled through >160 MB of copies.
Prints one JSON line per measurement and a summary line. Needs one CUDA
device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_ENTRY = {
    # q, k, v, o, B, H, Hk, Sq, Tk, D, q_offset, window, scale, dtype, stream
    "flash_prefill": ("flash_prefill_launch",
                      [_P] * 4 + [_I] * 8 + [_F, _I, _P]),
    # q, k, v, page_table, lengths, part, o, B, H, Hk, D, page, MP, scale,
    # dtype, stream
    "paged_attention": ("paged_attention_launch",
                        [_P] * 7 + [_I] * 6 + [_F, _I, _P]),
    # x, la, Bm, Cm, h0, y, h_final, B, S, H, P, N, Q, stream
    "ssd_scan": ("ssd_scan_launch", [_P] * 7 + [_I] * 6 + [_P]),
    # log_a, gated, h0, h, h_final, B, S, W, stream
    "rglru_scan": ("rglru_scan_launch", [_P] * 5 + [_I] * 3 + [_P]),
}


def build_old(src: Path, out_dir: Path, name: str, entry=None,
              tag: str = "old"):
    """The old source's C entry point (``entry``, else ``OLD_ENTRY[name]``),
    built into ``out_dir``, its signature set."""
    from repro_torch.kernels import _build
    lib = out_dir / f"lib{name}_{tag}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    symbol, argtypes = entry or OLD_ENTRY[name]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def turns(name, runs, sets, iters, time_ms):
    """old, new, new, old: {"<which>_device_ms": [...], "<which>_call_ms":
    [...]}."""
    res = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        dev_ms, call_ms = time_ms(runs[which], sets, iters)
        res[which].append((dev_ms, call_ms))
        print(json.dumps({"kernel_ab": name, "turn": which,
                          "device_ms": dev_ms, "call_ms": call_ms}),
              flush=True)
    return {f"{w}_{k}": [r[i] for r in res[w]]
            for w in res for i, k in ((0, "device_ms"), (1, "call_ms"))}


def by_kernel(fn, args=(), iters: int = 100) -> dict:
    """Device microseconds per call of each kernel ``fn(*args)`` launches
    (``repro_torch.bench.common.device_us_per_call``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bench.common import device_us_per_call
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    return device_us_per_call(prof, iters)


def host_us(fn, n: int = 2000) -> float:
    """Host microseconds per call of ``fn`` (the device keeps up: the
    kernels here take less time than their launches)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def flash_ab(old_src, tmp, iters, splits, cs):
    import torch.nn.functional as F

    from repro_torch.kernels import _build, flash_chunk_op
    from repro_torch.kernels.flash_prefill import flash_prefill_ref
    from repro_torch.kernels.flash_prefill.ops import LAUNCH, plan
    old_fn = build_old(old_src, tmp, "flash_prefill")

    def old(q, k, v, off):
        B, S, H, D = q.shape
        o = torch.empty_like(q)
        err = old_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     B, H, k.shape[2], S, k.shape[1], D, off, 0,
                     1.0 / math.sqrt(D), 1,
                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old flash_prefill_launch: CUDA error {err}")
        return o

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    H, Hk, D = 16, 8, 128                    # qwen3-1.7b
    shapes = {"flash_prefill": (128, 128, 0),          # Sq, T, q_offset
              "flash_prefill_dyn": (256, 1024, 512)}
    summary = {}
    for name, (Sq, T, off) in shapes.items():
        q, k, v = (torch.randn(s, generator=g, device=dev)
                   .to(torch.bfloat16)
                   for s in ((1, Sq, H, D), (1, T, Hk, D), (1, T, Hk, D)))
        want = flash_prefill_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                                 q_offset=off).transpose(1, 2).float()
        errs = {f"{which}_max_abs_err": float((f(q, k, v, off).float()
                                               - want).abs().max())
                for which, f in (("old", old), ("new", flash_chunk_op))}
        sets = cs.copies([q, k, v])
        live = off + Sq
        qpos = torch.arange(Sq, device=dev)[:, None] + off
        mask = torch.arange(live, device=dev)[None, :] <= qpos
        lib_sets = [tuple(t[:, :live].transpose(1, 2).contiguous()
                          for t in s) for s in sets]
        out = turns(name, {"old": lambda a, b, c: old(a, b, c, off),
                           "new": lambda a, b, c: flash_chunk_op(a, b, c,
                                                                 off)},
                    sets, iters, cs.time_ms)
        causal = off == 0 and T == Sq       # as chip_smoke.py times SDPA
        sdpa = cs.time_ms(
            lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, attn_mask=None if causal else mask,
                is_causal=causal, enable_gqa=True), lib_sets, iters)
        pl = plan(1, H, Hk, Sq, T, D, off, None)
        new_fn = _build.fn(*LAUNCH)
        o = torch.empty_like(q)
        base = pl.blocks // pl.n_split     # (kv head, query tile) pairs
        part = torch.empty(max([pl.n_split, *splits]) * base * 64
                           * (D + 2), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        launch = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  part.data_ptr(), 1, H, Hk, Sq, T, D, off, 0,
                  1.0 / math.sqrt(D), 1, pl.qp, pl.n_split, stream)
        old_launch = launch[:4] + launch[5:15] + (stream,)
        host = {"wrapper": host_us(lambda: flash_chunk_op(q, k, v, off)),
                "c_launch": host_us(lambda: new_fn(*launch)),
                "old_c_launch": host_us(lambda: old_fn(*old_launch)),
                "plan": host_us(lambda: plan(1, H, Hk, Sq, T, D, off,
                                             None)),
                "empty_like": host_us(lambda: torch.empty_like(q)),
                "current_stream": host_us(
                    lambda: torch.cuda.current_stream(dev).cuda_stream)}
        print(json.dumps({"kernel_ab_host_us": name, **host}), flush=True)
        by_split = {}                       # the plan's split count vs others
        for ns in splits:
            la = launch[:16] + (ns,) + launch[17:]
            by_split[ns] = by_kernel(lambda: new_fn(*la))
        summary[name] = {
            "shape": f"q(1,{Sq},{H},{D}) at offset {off}, "
                     f"kv(1,{T},{Hk},{D}) bf16", **out,
            "sdpa_device_ms": sdpa[0], "sdpa_call_ms": sdpa[1], **errs,
            "host_us_per_call": host,
            "new_device_us_by_kernel": by_kernel(
                lambda a, b, c: flash_chunk_op(a, b, c, off), (q, k, v)),
            "new_device_us_by_kernel_and_split": by_split,
            "blocks": pl.blocks, "n_split": pl.n_split}
    return summary


def paged_ab(old_src, tmp, iters, pps_sweep, cs):
    import torch.nn.functional as F

    from repro_torch.kernels import _build, paged_attention_op
    from repro_torch.kernels.paged_attention import paged_attention_ref
    from repro_torch.kernels.paged_attention.ops import (LAUNCH, kernel_attrs,
                                                         plan)
    old_fn = build_old(old_src, tmp, "paged_attention")

    def old(q, kp, vp, pt, ln):                  # as the old wrapper called it
        old_fn.argtypes = OLD_ENTRY["paged_attention"][1]
        B, H, D = q.shape
        _, page, Hk, _ = kp.shape
        MP = pt.shape[1]
        o = torch.empty_like(q)
        part = torch.empty(B * Hk * MP * (H // Hk) * (D + 2),
                           dtype=torch.float32, device=q.device)
        err = old_fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                     pt.data_ptr(), ln.data_ptr(), part.data_ptr(),
                     o.data_ptr(), B, H, Hk, D, page, MP, 1.0 / math.sqrt(D),
                     1, torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"old paged_attention_launch: error {err}")
        return o

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    B, H, Hk, D, page, MP = 8, 16, 8, 128, 128, 8
    lengths = [1, 100, 257, 400, 512, 700, 731, 1024]
    bf = torch.bfloat16
    q = torch.randn(B, H, D, generator=g, device=dev).to(bf)
    kp, vp = (torch.randn(B * MP, page, Hk, D, generator=g, device=dev)
              .to(bf) for _ in range(2))
    perm = torch.randperm(B * MP, generator=g, device=dev)
    pt = perm.reshape(B, MP).to(torch.int32)     # a shuffled page table
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    want = paged_attention_ref(q, kp, vp, pt, ln).float()
    errs = {f"{w}_max_abs_err": float((f(q, kp, vp, pt, ln).float() - want)
                                      .abs().max())
            for w, f in (("old", old), ("new", paged_attention_op))}
    sets = cs.copies([q, kp, vp])
    runs = {"old": lambda a, b, c: old(a, b, c, pt, ln),
            "new": lambda a, b, c: paged_attention_op(a, b, c, pt, ln)}
    out = turns("paged_attention", runs, sets, iters, cs.time_ms)
    # SDPA over the same keys gathered by the page table, as chip_smoke.py
    C = MP * page
    pos = torch.arange(C, device=dev)
    mask = (pos[None, :] < ln[:, None].long())[:, None, None, :]

    def gathered(t):
        return t[pt.long()].reshape(B, C, Hk, D).transpose(1, 2).contiguous()

    lib_sets = [(a[:, :, None], gathered(b), gathered(c)) for a, b, c in sets]
    sd = cs.time_ms(lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, attn_mask=mask, enable_gqa=True), lib_sets, iters)
    pl = plan(B, H, Hk, D, page, MP)
    sweep = {}
    fn = _build.fn(*LAUNCH)
    stream = torch.cuda.current_stream().cuda_stream
    for pps in pps_sweep:
        ns = -(-MP // pps)
        part = torch.empty(B * Hk * ns * (H // Hk) * (D + 2), device=dev)
        o = torch.empty_like(q)
        args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), pt.data_ptr(),
                ln.data_ptr(), part.data_ptr(), o.data_ptr(), B, H, Hk, D,
                page, MP, pps, ns, 1.0 / math.sqrt(D), 1, stream)
        sweep[pps] = by_kernel(lambda: fn(*args))
    return {"shape": f"q({B},{H},{D}) pages({B * MP},{page},{Hk},{D}) bf16, "
                     f"lengths {lengths}, shuffled page table",
            **out, "sdpa_device_ms": sd[0], "sdpa_call_ms": sd[1], **errs,
            "plan": pl._asdict(),
            "new_device_us_by_kernel": by_kernel(
                lambda: paged_attention_op(q, kp, vp, pt, ln)),
            "old_device_us_by_kernel": by_kernel(
                lambda: old(q, kp, vp, pt, ln)),
            "raw_launch_us_by_pages_per_split": sweep,
            "attrs_bf16_G2_D128": kernel_attrs(bf, 2)}


def ssd_ab(old_src, tmp, iters, cs):
    from repro_torch.kernels import ssd_scan_op
    from repro_torch.kernels.ssd_scan import ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ops import kernel_attrs
    old_fn = build_old(old_src, tmp, "ssd_scan")

    def old(x, la, Bh, Ch, Q, h0):               # as the old wrapper called it
        old_fn.argtypes = OLD_ENTRY["ssd_scan"][1]
        ts = [t.float().contiguous() for t in (x, la, Bh, Ch)]
        h0 = h0.float().contiguous()
        B, S, H, P = x.shape
        N = Bh.shape[3]
        y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
        hT = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
        err = old_fn(*(t.data_ptr() for t in ts), h0.data_ptr(),
                     y.data_ptr(), hT.data_ptr(), B, S, H, P, N, Q,
                     torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"old ssd_scan_launch: error {err}")
        return y, hT

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    B, S, H, P, N, Q, G = 1, 256, 32, 64, 128, 128, 1

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    x, la = rnd(B, S, H, P), -rnd(B, S, H).abs() * 0.5
    Bg, Cg = rnd(B, S, G, N, scale=0.3), rnd(B, S, G, N, scale=0.3)
    h0 = rnd(B, H, P, N)
    Bh, Ch = (t.repeat_interleave(H // G, 2).contiguous() for t in (Bg, Cg))
    want = ssd_scan_ref(x, la, Bg, Cg, h0)
    errs = {}
    for w, got in (("old", old(x, la, Bh, Ch, Q, h0)),
                   ("new", ssd_scan_op(x, la, Bg, Cg, Q, h0=h0))):
        errs[f"{w}_max_abs_err"] = max(float((a - b).abs().max())
                                       for a, b in zip(got, want))
    sets = cs.copies([x, la, Bg, Cg, h0, Bh, Ch])
    runs = {"old": lambda x, la, bg, cg, h0, bh, ch: old(x, la, bh, ch, Q,
                                                         h0),
            "new": lambda x, la, bg, cg, h0, bh, ch: ssd_scan_op(
                x, la, bg, cg, Q, h0=h0)}
    out = turns("ssd_scan", runs, sets, iters, cs.time_ms)
    # the model's old call repeated B and C per head first: two copies
    rep = cs.time_ms(lambda x, la, bg, cg, h0, bh, ch: old(
        x, la, bg.repeat_interleave(H // G, 2),
        cg.repeat_interleave(H // G, 2), Q, h0), sets, iters)
    return {"shape": f"x({B},{S},{H},{P}) B/C({B},{S},{G},{N}) h0 chunk {Q} "
                     "f32", **out,
            "old_with_repeat_device_ms": rep[0],
            "old_with_repeat_call_ms": rep[1], **errs,
            "new_device_us_by_kernel": by_kernel(
                lambda: ssd_scan_op(x, la, Bg, Cg, Q, h0=h0)),
            "attrs": kernel_attrs()}


def rglru_ab(old_src, alt_srcs, tmp, iters, cs):
    from repro_torch.kernels import _build, rglru_scan_op
    from repro_torch.kernels.rglru_scan import rglru_scan_ref
    from repro_torch.kernels.rglru_scan.ops import (LAUNCH, ROUTES, _check,
                                                    _f32, kernel_attrs, plan)
    old_fn = build_old(old_src, tmp, "rglru_scan")
    alts = {src.name: build_old(src, tmp, "rglru_scan", LAUNCH[1:], f"alt{i}")
            for i, src in enumerate(alt_srcs)}

    def alt(fn):                                 # the current wrapper's call
        def call(la, gt, h0):
            _check(la, gt, h0)
            B, S, W = la.shape
            pl = plan(B, S, W)
            h = torch.empty((B, S, W), dtype=torch.float32, device=la.device)
            hT = torch.empty((B, W), dtype=torch.float32, device=la.device)
            err = fn(la.data_ptr(), gt.data_ptr(), h0.data_ptr(),
                     h.data_ptr(), hT.data_ptr(), B, S, W, ROUTES[pl.route],
                     pl.cluster, pl.seg, pl.run, pl.rounds,
                     _build.stream(la.device))
            if err:
                raise RuntimeError(f"rglru_scan_launch: error {err}")
            return h, hT
        return call

    def old(la, gt, h0):                         # as the old wrapper called it
        _check(la, gt, h0)
        la, gt, h0 = _f32(la), _f32(gt), _f32(h0)
        B, S, W = la.shape
        h = torch.empty((B, S, W), dtype=torch.float32, device=la.device)
        hT = torch.empty((B, W), dtype=torch.float32, device=la.device)
        err = old_fn(la.data_ptr(), gt.data_ptr(), h0.data_ptr(),
                     h.data_ptr(), hT.data_ptr(), B, S, W,
                     _build.stream(la.device))
        if err:
            raise RuntimeError(f"old rglru_scan_launch: error {err}")
        return h, hT

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for S in (256, 1024):
        la = -torch.randn(1, S, 4096, generator=g, device=dev).abs() * 0.3
        gt = torch.randn(1, S, 4096, generator=g, device=dev)
        h0 = torch.randn(1, 4096, generator=g, device=dev)
        want = rglru_scan_ref(la, gt, h0)
        errs = {f"{w}_max_abs_err": max(float((a - b).abs().max())
                                        for a, b in zip(f(la, gt, h0), want))
                for w, f in (("old", old), ("new", rglru_scan_op))}
        pl = plan(1, S, 4096)
        sets = cs.copies([la, gt, h0])
        # variants with the current entry point, each in turns with the
        # current kernel (reported as "old")
        variants = {}
        for name, fn in alts.items():
            run = alt(fn)
            variants[name] = {
                "max_abs_err": max(float((a - b).abs().max())
                                   for a, b in zip(run(la, gt, h0), want)),
                **turns(f"rglru_scan (1,{S},4096) {name}",
                        {"old": run, "new": rglru_scan_op}, sets, iters,
                        cs.time_ms)}
        # an elementwise op that moves the same bytes (two inputs read,
        # one output written): what streaming alone takes on this card
        hs = torch.empty_like(la)
        same = cs.time_ms(lambda a, b, c: torch.add(a, b, out=hs), sets,
                          iters)
        out[f"(1,{S},4096)"] = {
            "shape": f"log_a/gated(1,{S},4096) h0 f32",
            **turns(f"rglru_scan (1,{S},4096)",
                    {"old": old, "new": rglru_scan_op}, sets, iters,
                    cs.time_ms),
            **errs, "plan": pl._asdict(), "attrs": kernel_attrs(pl),
            "bound_ms": cs.bound(cs.nbytes(la, gt, h0, *want),
                                 2.0 * la.numel(), cs.F32_FLOPS)[0],
            "same_bytes_add_device_ms": same[0], "variants": variants}
    return out


def _ints(a: str):
    return [int(x) for x in a.split(",")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flash", type=Path, help="an older flash_prefill.cu")
    ap.add_argument("--paged", type=Path, help="an older paged_attention.cu")
    ap.add_argument("--ssd", type=Path, help="an older ssd_scan.cu")
    ap.add_argument("--rglru", type=Path, help="an older rglru_scan.cu")
    ap.add_argument("--rglru-alt", type=Path, action="append", default=[],
                    help="with --rglru: also time a variant rglru_scan.cu "
                    "that has the current entry point (repeatable)")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--splits", type=_ints, default=[],
                    help="flash: also time the raw launch at these kv "
                    "split counts (device time by kernel)")
    ap.add_argument("--pps", type=_ints, default=[1, 2, 4, 8],
                    help="paged: also time the raw launch at these pages "
                    "a split")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.bench import common as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tmp = tempfile.TemporaryDirectory()
    out_dir = Path(tmp.name)
    summary = {}
    if args.flash:
        summary.update(flash_ab(args.flash, out_dir, args.iters, args.splits,
                                cs))
    if args.paged:
        summary["paged_attention"] = paged_ab(args.paged, out_dir,
                                              args.iters, args.pps, cs)
    if args.ssd:
        summary["ssd_scan"] = ssd_ab(args.ssd, out_dir, args.iters, cs)
    if args.rglru:
        summary["rglru_scan"] = rglru_ab(args.rglru, args.rglru_alt, out_dir,
                                         args.iters, cs)
    print(json.dumps({"kernel_ab_summary": summary, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
