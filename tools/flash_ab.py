"""Times an earlier revision of the port's flash-prefill kernel beside the
current one on the card, in turns (old, new, new, old), at chip_smoke.py's
two flash check shapes, with SDPA on the same inputs as the yardstick:

    git show <commit>:src/repro_torch/kernels/flash_prefill/csrc/flash_prefill.cu \
        > old.cu
    python3 tools/flash_ab.py old.cu [--iters 200]

The old source is built by nvcc with the port's flags into a temporary
directory and called through the C entry point it had before the split-KV
plan arguments (q, k, v, o, B, H, Hk, Sq, Tk, D, q_offset, window, scale,
dtype, stream). Times are chip_smoke.py's: device time per call summed by
torch.profiler, and CUDA-event time per call, over inputs cycled through
>160 MB of copies. Prints one JSON line per measurement and a summary line.
Needs one CUDA device and nvcc.
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


def build_old(src: Path, out_dir: Path):
    """The old source's C entry point, built into ``out_dir``."""
    from repro_torch.kernels import _build
    lib = out_dir / "libflash_prefill_old.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).flash_prefill_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def device_us_by_kernel(fn, args, iters: int = 100) -> dict:
    """Device microseconds per call of each kernel ``fn(*args)`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / iters
            for e in prof.key_averages() if e.self_device_time_total > 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_source", type=Path)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--splits", type=lambda a: [int(x) for x in a.split(",")],
                    default=[], help="also time the raw launch at these kv "
                    "split counts (device time by kernel)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels import flash_chunk_op
    from repro_torch.kernels.flash_prefill import flash_prefill_ref
    from repro_torch.kernels.flash_prefill.ops import _kernel, plan

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tmp = tempfile.TemporaryDirectory()
    old_fn = build_old(args.old_source, Path(tmp.name))

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
        sets = chip_smoke.copies([q, k, v])
        live = off + Sq
        qpos = torch.arange(Sq, device=dev)[:, None] + off
        mask = torch.arange(live, device=dev)[None, :] <= qpos
        lib_sets = [tuple(t[:, :live].transpose(1, 2).contiguous()
                          for t in s) for s in sets]
        runs = {"old": lambda a, b, c: old(a, b, c, off),
                "new": lambda a, b, c: flash_chunk_op(a, b, c, off)}
        res = {"old": [], "new": []}
        for turn in ("old", "new", "new", "old"):
            dev_ms, call_ms = chip_smoke.time_ms(runs[turn], sets, args.iters)
            res[turn].append((dev_ms, call_ms))
            print(json.dumps({"flash_ab": name, "turn": turn,
                              "device_ms": dev_ms, "call_ms": call_ms}),
                  flush=True)
        causal = off == 0 and T == Sq       # as chip_smoke.py times SDPA
        sdpa = chip_smoke.time_ms(
            lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, attn_mask=None if causal else mask,
                is_causal=causal, enable_gqa=True), lib_sets, args.iters)
        pl = plan(1, H, Hk, Sq, T, D, off, None)
        new_fn = _kernel()
        o = torch.empty_like(q)
        base = pl.blocks // pl.n_split     # (kv head, query tile) pairs
        part = torch.empty(max([pl.n_split, *args.splits]) * base * 64
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
        print(json.dumps({"flash_ab_host_us": name, **host}), flush=True)
        by_kernel = device_us_by_kernel(
            lambda a, b, c: flash_chunk_op(a, b, c, off), (q, k, v))
        by_split = {}                       # the plan's split count vs others
        for ns in args.splits:
            la = launch[:16] + (ns,) + launch[17:]
            by_split[ns] = device_us_by_kernel(lambda: new_fn(*la), ())
        summary[name] = {
            "host_us_per_call": host, "new_device_us_by_kernel": by_kernel,
            "new_device_us_by_kernel_and_split": by_split,
            "shape": f"q(1,{Sq},{H},{D}) at offset {off}, "
                     f"kv(1,{T},{Hk},{D}) bf16",
            "old_device_ms": [r[0] for r in res["old"]],
            "new_device_ms": [r[0] for r in res["new"]],
            "old_call_ms": [r[1] for r in res["old"]],
            "new_call_ms": [r[1] for r in res["new"]],
            "sdpa_device_ms": sdpa[0], "sdpa_call_ms": sdpa[1],
            **errs,
            "blocks": pl.blocks, "n_split": pl.n_split}
    print(json.dumps({"flash_ab_summary": summary, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
