"""Shared helpers of the port's benchmarks: CSV emission per the harness
contract (``name,us_per_call,derived``), a wall-clock timer, result
persistence into the git-ignored ``results/`` directory beside this file,
the simulator benches' profile, the name and power limit of the card a run
measured, and the kernel timing of ``bench_kernels`` and ``chip_smoke.py``:
device time per call from torch.profiler and call time from CUDA events
over input copies larger than the L2, and the bound of a call from its
bytes and operations at the card's peaks."""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import time
from typing import Optional, Tuple

import torch

from repro_torch.sim import InstanceProfile

RESULTS_DIR = pathlib.Path(__file__).resolve().parent / "results"

# the H100 SXM's peaks (data sheet; at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12      # dense bf16 tensor-core peak
F32_FLOPS = 67e12        # float32 CUDA-core peak (no TF32)
TF32X3_FLOPS = 495e12 / 3  # float32 on the TF32 tensor cores (495 TFLOP/s)
#                            split hi + lo: three products a multiply-add

# a kernel against its plain version (atol = rtol)
BF16_TOL = 2e-2          # bf16 inputs (tests/test_kernels.py)
F32_TOL = 2e-5           # float32 attention (tests/test_kernels.py)
SSD_TOL = 2e-4           # ssd_scan vs the sequential plain version, f32
RGLRU_TOL = 1e-5         # rglru_scan vs the doubling-scan plain version, f32

# what sim_profile starts from: the port's InstanceProfile defaults, the
# H100's (a parity test swaps in the JAX cost model's constants)
PROFILE = InstanceProfile()


def sim_profile(**kw) -> InstanceProfile:
    """The profile every simulator bench gives its ``Simulator``:
    ``PROFILE`` with the fields the bench names (chips, efficiencies)
    replaced."""
    return dataclasses.replace(PROFILE, **kw)


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    print(f"{name},{us_per_call:.3f},{derived}")


def save_json(name: str, obj) -> None:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    (RESULTS_DIR / f"{name}.json").write_text(json.dumps(obj, indent=1))


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.s = time.perf_counter() - self.t0

    @property
    def us(self):
        return self.s * 1e6


def device_info(device: torch.device) -> Tuple[str, Optional[str]]:
    """(the device's name, the card's power limit as ``nvidia-smi``
    reports it, or None off the card)."""
    if device.type != "cuda":
        return "cpu", None
    name = torch.cuda.get_device_name(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"], capture_output=True, text=True,
        check=True)
    return name, smi.stdout.strip()


def sync(device: torch.device) -> None:
    """Wait for the device's queued work, so a timed window holds it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_us_per_call(prof, iters: int) -> dict:
    """Device microseconds per call of each kernel in a profile of
    ``iters`` calls that each launch the same kernels. torch.profiler can
    drop some of a kernel's launches from its window (on the H100: 199 of
    200 launches of one kernel, in every profile of a call), so a kernel's
    time is its mean time per recorded launch times its launches per call
    (its count over ``iters``, rounded), not its total over ``iters``."""
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            per_call = e.count / iters
            per_call = round(per_call) if per_call >= 0.5 else per_call
            out[e.key[:60]] = e.self_device_time_total / e.count * per_call
    return out


def time_ms(fn, arg_sets, iters: int):
    """Per-call times of ``fn(*args)`` on the card over ``iters`` calls,
    cycling through ``arg_sets`` (copies of the inputs whose total exceeds
    the 50 MB L2, so each call reads its inputs from device memory).
    Returns (device_ms, call_ms): the device time of every kernel the
    calls launched, from torch.profiler (``device_us_per_call``), and the
    CUDA-event time between the first call and the last, which also holds
    any host overhead that left the device idle."""
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
    dropped = {e.key[:60]: e.count for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.count % iters}
    if dropped:
        print(json.dumps({"profiler_launch_counts_off": dropped,
                          "iters": iters}), flush=True)
    device_us = sum(device_us_per_call(prof, iters).values())
    if device_us <= 0:
        raise AssertionError("torch.profiler saw no device time")
    return device_us / 1e3, call_ms


def copies(tensors, min_total=160 << 20, cap=64):
    """Copies of ``tensors`` whose total passes ``min_total`` bytes (at
    least two, at most ``cap``)."""
    per = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, min(cap, math.ceil(min_total / per)))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` at its memory rate and do ``flops`` at ``peak``,
    and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def within(got, want, tol: float = BF16_TOL) -> bool:
    """allclose with atol = rtol = ``tol``, as tests/test_kernels.py."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= tol + tol * w.abs()).all())
