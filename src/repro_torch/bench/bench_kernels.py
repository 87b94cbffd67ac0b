"""Micro-benchmarks of the six Hopper kernels against their plain-torch
versions, the port's ``benchmarks/bench_kernels.py``.

On the card (``--device cuda``, the default) each kernel is timed through
its wrapper at three sets of shapes:

  bench  the JAX bench's own, float32: flash (1,4,256,64) with 2 kv heads
         (and the same heads for flash_prefill_dyn: 64 queries at offset
         192 of 256), paged q (4,8,64) over pages (64,16,2,64) by a random
         page table with every length 100, ssd (1,256,4,64) with per-head
         B/C of d_state 64 in chunks of 64, rglru (2,256,512);
  main   the main paths' (``chip_smoke.py``'s kernel checks): qwen3-1.7b's
         flash at 128 tokens and a 256-token chunk at offset 512 of 1024
         slots, paged decode over 8 slots of 1024 in pages of 128 (bf16),
         a 256-token chunk of mamba2-370m through ssd_scan and of
         recurrentgemma-9b through rglru_scan from a random state
         (float32);
  migration  crc32 over qwen3-1.7b's migration images (k then v stacked,
         bf16) of 1736, 4573 and 16320 tokens: 0.2 GB (the ``conv``
         mix's), 0.52 GB (the ``code`` mix's mean) and 1.87 GB (its
         longest prompt); on the CPU 1/1024 of those tokens.

Each row: ``kernel.<name>.<set>_<shape>,<us_per_call>,<derived>`` where
``us_per_call`` is the kernel's CUDA-event time per call (host included),
``device_us`` its device time per call from torch.profiler, ``ref_us``
the plain version's and ``library_us`` that of the one PyTorch call that
computes the same function (``scaled_dot_product_attention`` for the two
flash routes, and for paged decode over K/V gathered beforehand by the
page table; none for the scans and crc32), each device time, inputs
cycling through more than 160 MB of copies; crc32's rows add ``host_us``,
``zlib.crc32`` over the same bytes already on the host (the host path the
kernel replaced, less its copy to host bytes), the least of three calls. ``bound_us`` is the larger of the call's bytes
(inputs read once, outputs written once) over the memory rate and its
operations over the peak of their type (float32 products at the 3xTF32
tensor-core rate, the RG-LRU's elementwise multiply-add at the CUDA-core
rate). ``max_abs_err`` is against the
plain version (crc32's: the CRC's four bytes, which must be equal); a
kernel outside its tolerance fails the run. The card's name and power
limit close each row.

On the CPU (``--device cpu``) only the plain versions run, timed on the
host clock, and each row says so. ``--device cuda`` without a card exits
non-zero.

  PYTHONPATH=src python -m repro_torch.bench.bench_kernels
  PYTHONPATH=src python -m repro_torch.bench.bench_kernels --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.bench.common import (BF16_FLOPS, BF16_TOL, F32_FLOPS,
                                      F32_TOL, RGLRU_TOL, SSD_TOL,
                                      TF32X3_FLOPS, bound, copies,
                                      device_info, emit, max_err, nbytes,
                                      save_json, time_ms, within)
from repro_torch.kernels import (crc32_op, flash_chunk_op, flash_seq_op,
                                 paged_attention_op, rglru_scan_op,
                                 ssd_scan_op)
from repro_torch.kernels.crc32 import crc32_host, crc32_ref
from repro_torch.kernels.flash_prefill import flash_prefill_ref
from repro_torch.kernels.paged_attention import paged_attention_ref
from repro_torch.kernels.rglru_scan import rglru_scan_ref
from repro_torch.kernels.ssd_scan import ssd_scan_ref

SETS = ("bench", "main", "migration")
# qwen3-1.7b's migrated positions: the conv mix's 199 MB, the code mix's
# 524 MB mean and 1.87 GB longest prompt (2 x 28 x 8 x 128 bf16 a token)
MIGRATION_TOKENS = {"conv": 1736, "code_mean": 4573, "code_max": 16320}
ITERS = {"kernel": 200, "plain": 50, "library": 200}


class Case(NamedTuple):
    name: str                     # the TPU kernel's
    label: str                    # <set>_<shape>
    inputs: tuple                 # copied for timing
    kernel: Callable              # the wrapper on the inputs
    plain: Callable               # the plain version on the inputs
    library: Optional[Callable]   # one PyTorch call, on lib_inputs(inputs)
    lib_inputs: Optional[Callable]
    tol: float
    bytes: float
    flops: float
    peak: float
    plain_iters: int = ITERS["plain"]
    host: Optional[Callable] = None   # timed on host copies of the inputs


def bhsd(t):
    return t.transpose(1, 2).contiguous()


def sdpa(q, k, v, mask=None, causal=False):
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          is_causal=causal, enable_gqa=True)


def flash_case(set_: str, dev, g, dtype, B, S, H, Hk, D, T=None, off=None):
    """flash_prefill (static: T = S) or flash_prefill_dyn (S queries at
    ``off`` against a ``T``-slot cache whose first off + S are valid)."""
    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    dyn = off is not None
    T = T if dyn else S
    off = off if dyn else 0
    valid = off + S
    q, k, v = rnd(B, S, H, D), rnd(B, T, Hk, D), rnd(B, T, Hk, D)
    pairs = S * off + S * (S + 1) // 2
    el = q.element_size()
    if dyn:
        kernel = lambda a, b, c: flash_chunk_op(a, b, c, off)  # noqa: E731
        qpos = torch.arange(S, device=dev)[:, None] + off
        mask = torch.arange(valid, device=dev)[None, :] <= qpos
        lib = lambda a, b, c: sdpa(a, b, c, mask=mask)  # noqa: E731
    else:
        kernel = lambda a, b, c: flash_seq_op(a, b, c)  # noqa: E731
        lib = lambda a, b, c: sdpa(a, b, c, causal=True)  # noqa: E731
    tag = f"at{off}t{T}" if dyn else ""
    return Case(
        name="flash_prefill_dyn" if dyn else "flash_prefill",
        label=f"{set_}_b{B}s{S}{tag}h{H}k{Hk}d{D}_{dtype_tag(dtype)}",
        inputs=(q, k, v), kernel=kernel,
        plain=lambda a, b, c: flash_prefill_ref(
            bhsd(a), bhsd(b), bhsd(c), q_offset=off).transpose(1, 2),
        library=lib,
        lib_inputs=lambda a, b, c: (bhsd(a), bhsd(b[:, :valid]),
                                    bhsd(c[:, :valid])),
        tol=tol_for(dtype),
        bytes=el * (2 * q.numel() + 2 * B * valid * Hk * D),
        flops=4.0 * D * H * B * pairs, peak=peak_for(dtype))


def paged_case(set_: str, dev, g, dtype, B, H, Hk, D, page, n_pages, MP,
               lengths, table="random"):
    """Decode over ``n_pages`` pages of ``page``; each row's ``MP`` table
    entries drawn at random, or its own run of consecutive pages."""
    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q = rnd(B, H, D)
    kp, vp = rnd(n_pages, page, Hk, D), rnd(n_pages, page, Hk, D)
    if table == "random":
        pt = torch.randint(0, n_pages, (B, MP), generator=g, device=dev,
                           dtype=torch.int32)
    else:
        pt = (torch.arange(B, device=dev)[:, None] * MP
              + torch.arange(MP, device=dev)[None, :]).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    live = sum(lengths)
    C = MP * page
    pos = torch.arange(C, device=dev)
    mask = (pos[None, :] < ln[:, None].long())[:, None, None, :]

    def gathered(a, b, c):
        k = b[pt.long()].reshape(B, C, Hk, D).transpose(1, 2).contiguous()
        v = c[pt.long()].reshape(B, C, Hk, D).transpose(1, 2).contiguous()
        return a[:, :, None], k, v

    el = q.element_size()
    return Case(
        name="paged_attention",
        label=f"{set_}_b{B}h{H}k{Hk}d{D}p{page}x{MP}_{dtype_tag(dtype)}",
        inputs=(q, kp, vp),
        kernel=lambda a, b, c: paged_attention_op(a, b, c, pt, ln),
        plain=lambda a, b, c: paged_attention_ref(a, b, c, pt, ln),
        library=lambda a, b, c: sdpa(a, b, c, mask=mask)[:, :, 0],
        lib_inputs=gathered, tol=tol_for(dtype),
        bytes=el * (2 * q.numel() + 2 * live * Hk * D)
        + 4 * (pt.numel() + B),
        flops=4.0 * D * H * live, peak=peak_for(dtype))


def ssd_case(set_: str, dev, g, B, S, H, P, N, G, Q, with_h0: bool):
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    x, la = rnd(B, S, H, P), -rnd(B, S, H).abs() * 0.5
    Bm, Cm = rnd(B, S, G, N, scale=0.3), rnd(B, S, G, N, scale=0.3)
    h0 = rnd(B, H, P, N) if with_h0 else None
    inputs = (x, la, Bm, Cm) + ((h0,) if with_h0 else ())
    nc, pairs = S // Q, Q * (Q + 1) // 2
    flops = B * nc * (H * (2 * pairs * P + 2 * 2 * Q * N * P)
                      + G * 2 * pairs * N)
    out_bytes = 4 * (B * S * H * P + B * H * P * N)
    return Case(
        name="ssd_scan",
        label=f"{set_}_b{B}s{S}h{H}p{P}n{N}g{G}c{Q}{'h0' if with_h0 else ''}"
              "_f32",
        inputs=inputs,
        kernel=lambda *a: ssd_scan_op(*a[:4], Q, h0=a[4] if with_h0
                                      else None),
        plain=lambda *a: ssd_scan_ref(*a), library=None, lib_inputs=None,
        tol=SSD_TOL, bytes=nbytes(*inputs) + out_bytes, flops=flops,
        peak=TF32X3_FLOPS, plain_iters=10)


def rglru_case(set_: str, dev, g, B, S, W, with_h0: bool):
    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    la, gt = -rnd(B, S, W).abs() * 0.3, rnd(B, S, W)
    inputs = (la, gt) + ((rnd(B, W),) if with_h0 else ())
    return Case(
        name="rglru_scan",
        label=f"{set_}_b{B}s{S}w{W}{'h0' if with_h0 else ''}_f32",
        inputs=inputs, kernel=lambda *a: rglru_scan_op(*a),
        plain=lambda *a: rglru_scan_ref(*a), library=None, lib_inputs=None,
        tol=RGLRU_TOL, bytes=nbytes(*inputs) + 4 * (B * S * W + B * W),
        # an elementwise multiply-add: no product for the tensor cores
        flops=2.0 * B * S * W, peak=F32_FLOPS)


def crc_bytes(crc: int) -> torch.Tensor:
    """A CRC as its four bytes, so ``check`` compares it exactly."""
    return torch.tensor(list(crc.to_bytes(4, "little")), dtype=torch.float32)


def crc_case(set_: str, dev, g, key: str, tokens: int):
    """crc32 over a migration image of ``tokens`` positions: k then v
    stacked, (2, 28 layers, tokens, 8 kv heads, 128), bf16."""
    img = torch.randn((2, 28, tokens, 8, 128), generator=g,
                      device=dev).to(torch.bfloat16)
    return Case(
        name="crc32", label=f"{set_}_{key}_t{tokens}_bf16", inputs=(img,),
        kernel=lambda t: crc_bytes(crc32_op(t)),
        plain=lambda t: crc_bytes(crc32_ref(t)), library=None,
        lib_inputs=None, tol=0.0, bytes=nbytes(img), flops=0.0,
        peak=BF16_FLOPS, plain_iters=2,
        host=lambda t: crc_bytes(crc32_host(t)))


def dtype_tag(dtype) -> str:
    return {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]


def tol_for(dtype) -> float:
    return BF16_TOL if dtype == torch.bfloat16 else F32_TOL


def peak_for(dtype) -> float:
    """The peak of attention's products: float32 ones at the full-precision
    tensor-core rate (3xTF32), as the ssd rows."""
    return BF16_FLOPS if dtype == torch.bfloat16 else TF32X3_FLOPS


def cases(set_: str, dev) -> list:
    """The kernels' cases at one set of shapes."""
    g = torch.Generator(device=dev).manual_seed(0)
    f32, bf = torch.float32, torch.bfloat16
    if set_ == "migration":
        scale = 1 if dev.type == "cuda" else 1024
        return [crc_case(set_, dev, g, k, max(1, n // scale))
                for k, n in MIGRATION_TOKENS.items()]
    if set_ == "bench":
        return [
            flash_case(set_, dev, g, f32, 1, 256, 4, 2, 64),
            flash_case(set_, dev, g, f32, 1, 64, 4, 2, 64, T=256, off=192),
            paged_case(set_, dev, g, f32, 4, 8, 2, 64, 16, 64, 8,
                       [100] * 4),
            ssd_case(set_, dev, g, 1, 256, 4, 64, 64, 4, 64, False),
            rglru_case(set_, dev, g, 2, 256, 512, False),
        ]
    # qwen3-1.7b: 16 query heads, 8 kv heads of 128
    return [
        flash_case(set_, dev, g, bf, 1, 128, 16, 8, 128),
        flash_case(set_, dev, g, bf, 1, 256, 16, 8, 128, T=1024, off=512),
        paged_case(set_, dev, g, bf, 8, 16, 8, 128, 128, 64, 8,
                   [1, 100, 257, 400, 512, 700, 731, 1024],
                   table="slots"),
        ssd_case(set_, dev, g, 1, 256, 32, 64, 128, 1, 128, True),
        rglru_case(set_, dev, g, 1, 256, 4096, True),
    ]


def outputs(out):
    return out if isinstance(out, tuple) else (out,)


def check(case: Case):
    """(the kernel's outputs, the plain version's, their max abs error,
    whether all lie within ``case.tol``)."""
    got = outputs(case.kernel(*case.inputs))
    want = outputs(case.plain(*case.inputs))
    torch.cuda.synchronize()
    err = max(max_err(a, b) for a, b in zip(got, want))
    return (got, want, err,
            all(within(a, b, case.tol) for a, b in zip(got, want)))


def run_card(case: Case, card: str) -> dict:
    _, _, err, ok = check(case)
    sets = copies(list(case.inputs))
    dev_ms, call_ms = time_ms(case.kernel, sets, ITERS["kernel"])
    plain_ms, _ = time_ms(case.plain, sets, case.plain_iters)
    lib_ms = None
    if case.library is not None:
        lib_sets = [case.lib_inputs(*s) for s in sets]
        lib_ms, _ = time_ms(case.library, lib_sets, ITERS["library"])
    host_ms = None
    if case.host is not None:
        host_in = [t.cpu() for t in case.inputs]
        host_ms = min(host_call_ms(case.host, host_in) for _ in range(3))
    b_ms, b_by = bound(case.bytes, case.flops, case.peak)
    row = {"name": case.name, "shape": case.label,
           "us_per_call": call_ms * 1e3, "device_us": dev_ms * 1e3,
           "ref_us": plain_ms * 1e3,
           "library_us": None if lib_ms is None else lib_ms * 1e3,
           "bound_us": b_ms * 1e3, "bound_by": b_by, "max_abs_err": err,
           "tol": case.tol, "within_tol": ok, "card": card}
    lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.3f}"
    host = ""
    if host_ms is not None:
        row["host_us"] = host_ms * 1e3
        host = f"host_us={row['host_us']:.3f};"
    emit(f"kernel.{case.name}.{case.label}", row["us_per_call"],
         f"device_us={row['device_us']:.3f};ref_us={row['ref_us']:.3f};"
         f"library_us={lib};{host}bound_us={row['bound_us']:.3f}({b_by});"
         f"max_abs_err={err:.3g};tol={case.tol:g};card={card}")
    return row


def host_call_ms(fn, args) -> float:
    t0 = time.perf_counter()
    fn(*args)
    return (time.perf_counter() - t0) * 1e3


def run_cpu(case: Case) -> dict:
    """One call of the plain version, on the host clock (the sequential
    SSD reference takes seconds at the main path's shape)."""
    t0 = time.perf_counter()
    case.plain(*case.inputs)
    us = (time.perf_counter() - t0) * 1e6
    emit(f"kernel.{case.name}.{case.label}", us,
         "plain version only (cpu; no kernel): host wall time of one call")
    return {"name": case.name, "shape": case.label, "us_per_call": us,
            "plain_only": True}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu (plain only)")
    args = ap.parse_args(argv)

    from repro_torch.engine.instance import resolve_device
    dev = resolve_device(args.device)
    name, power = device_info(dev)
    card = name if power is None else f"{name}, {power}"
    rows = []
    with torch.no_grad():
        for set_ in SETS:
            for case in cases(set_, dev):
                rows.append(run_card(case, card) if dev.type == "cuda"
                            else run_cpu(case))
    save_json("kernels", {"device": card, "rows": rows})
    bad = [r for r in rows if r.get("within_tol") is False]
    if bad:
        raise AssertionError(
            "kernels outside their tolerance: " + ", ".join(
                f"{r['name']}.{r['shape']} ({r['max_abs_err']:.3g} > "
                f"{r['tol']:g})" for r in bad))
    return rows


if __name__ == "__main__":
    main()
