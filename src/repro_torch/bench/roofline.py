"""Roofline analysis of the port's dry-run records: per (arch x shape x
mesh) the three roofline terms from ``repro_torch.launch.dryrun``'s
records (``results/dryrun_torch/``) and the dominant bottleneck, the port
of ``benchmarks/roofline.py``.

  compute term    = flops_per_device / H100.peak_flops
  memory term     = bytes_per_device / H100.hbm_bw
  collective term = collective_bytes_per_device / NVLINK_BW

The two peaks are ``InstanceProfile``'s (the SXM data sheet's dense bf16
peak and memory rate). Each record is per device, rank 0 of the mesh.
MODEL_FLOPS: analytic 6·N·D (train) / 2·N_active·D + attention (serving),
whole-cluster, divided by the device count for the useful-flops ratio.

The port's dry-run counts the bytes of every local op unfused (inputs
plus outputs of each op that is not a view), where XLA's cost analysis
counts them after fusion: the memory term here is an upper bound, not
comparable term by term with the JAX package's records, and each row
says so.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --single-pod
  PYTHONPATH=src python -m repro_torch.bench.roofline [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import math

from repro_torch.bench.common import emit, save_json
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch.dryrun import load_results
from repro_torch.sim import InstanceProfile

H100 = InstanceProfile()
# NVLink 4 on the H100 SXM: 900 GB/s a card, both directions together
# (NVIDIA H100 Tensor Core GPU data sheet); one direction
NVLINK_BW = 4.5e11


def model_flops(arch: str, shape_name: str) -> float:
    """Whole-cluster useful model FLOPs for one step."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    n_active = cfg.param_count(active_only=True)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * B * S
    if shape.kind == "prefill":
        base = 2.0 * n_active * B * S
        if cfg.family not in ("ssm",):
            w = cfg.sliding_window
            ctx = S / 2 if w is None else min(S / 2, w)
            frac = 1.0
            if cfg.family == "hybrid":
                frac = cfg.hybrid.pattern.count("attn") / len(cfg.hybrid.pattern)
            base += 4.0 * cfg.n_layers * frac * cfg.q_dim * B * S * ctx
        return base
    # decode: one token per sequence
    base = 2.0 * n_active * B
    if cfg.family not in ("ssm", "encdec"):
        w = cfg.sliding_window or (cfg.long_context_window
                                   if shape_name == "long_500k" else None)
        ctx = S if w is None else min(S, w)
        frac = 1.0
        if cfg.family == "hybrid":
            frac = cfg.hybrid.pattern.count("attn") / len(cfg.hybrid.pattern)
        base += 4.0 * cfg.n_layers * frac * cfg.q_dim * B * ctx
    return base


def analyse(rec: dict) -> dict:
    n_dev = math.prod(int(d) for d in rec["mesh"].split("x"))
    flops = rec["flops"]
    bytes_ = rec["bytes_accessed"]
    coll = sum(rec["collective_bytes"].values())
    t_compute = flops / H100.peak_flops
    t_memory = bytes_ / H100.hbm_bw
    t_coll = coll / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"])
    ratio = mf / max(flops * n_dev, 1e-9)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "n_dev": n_dev,
        "compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "flops_total": flops * n_dev,
        "useful_flops_ratio": ratio,
        "collective_breakdown": rec["collective_bytes"],
        "memory_per_device_gb": (rec["memory"]["argument_bytes"]
                                 + rec["memory"]["temp_bytes"]) / 2**30,
        "bytes": "unfused",
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    rows = []
    for rec in load_results():
        if rec.get("status") == "skipped":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec["mesh"], "dominant": "skipped"})
            continue
        if rec.get("status") != "ok":
            continue
        a = analyse(rec)
        rows.append(a)
        if rec["mesh"] == args.mesh:
            emit(f"roofline.{a['arch']}.{a['shape']}",
                 max(a["compute_s"], a["memory_s"], a["collective_s"]) * 1e6,
                 f"dominant={a['dominant']};useful={a['useful_flops_ratio']:.2f};"
                 f"comp={a['compute_s']*1e3:.2f}ms;"
                 f"mem={a['memory_s']*1e3:.2f}ms(unfused bytes);"
                 f"coll={a['collective_s']*1e3:.2f}ms")
    save_json("roofline", rows)
    return rows


if __name__ == "__main__":
    main()
