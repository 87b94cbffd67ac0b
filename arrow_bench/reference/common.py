"""What the plain references share: float32 with TF32 off, RMSNorm, the
float32 and float8 (control) linear layers, and the weights made from the
seed in a few large calls on the device."""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch

E4M3_MAX = 448.0
# init rules of the program's layout (its own init uses the same scales)
NORMAL_STD = 0.02
CONV_STD = 0.2
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32 inside the block (restored after)."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def rms_norm(x, w, eps: float):
    """RMSNorm over the last axis with scale ``1 + w``, float32."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def fp8(t, dim: int):
    """``t`` rounded to float8 e4m3, each slice along ``dim`` with its own
    absmax scale, back in float32."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def linear_f32(x, w):
    return x @ w


def linear_fp8(x, w):
    """x (.., in) @ w (in, out) with both operands in float8 e4m3: x per
    row, w per output column."""
    return fp8(x, -1) @ fp8(w, 0)


def linear_for(precision: str):
    if precision == "f32":
        return linear_f32
    if precision == "fp8":
        return linear_fp8
    raise ValueError(f"unknown precision {precision!r}")


def init_from_layout(layout: List[Tuple[str, tuple, str]], conf: dict,
                     seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights of ``layout`` from ``seed``, on ``device``: every "normal"
    leaf a view into one buffer of standard normals drawn in one call in
    the served dtype and scaled by ``NORMAL_STD`` (or the configuration's
    ``init_std``), "conv" leaves likewise
    at ``CONV_STD``, "zeros" and "ones" filled, and the fixed leaves of a
    state-space layer ("a_log": log of 1..16 spread over the heads;
    float32, as the program keeps them) computed."""
    dtype = DTYPES[conf["torch_dtype"]]
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    for rule, std in (("normal", conf.get("init_std", NORMAL_STD)),
                      ("conv", CONV_STD)):
        leaves = [(p, s) for p, s, r in layout if r == rule]
        n = sum(math.prod(s) for _, s in leaves)
        if not n:
            continue
        buf = torch.randn(n, generator=gen, dtype=dtype, device=dev)
        buf.mul_(std)
        i = 0
        for path, shape in leaves:
            k = math.prod(shape)
            out[path] = buf[i:i + k].view(shape)
            i += k
    for path, shape, rule in layout:
        if rule == "zeros":
            out[path] = torch.zeros(shape, dtype=dtype, device=dev)
        elif rule == "zeros_f32":
            out[path] = torch.zeros(shape, dtype=torch.float32, device=dev)
        elif rule == "ones_f32":
            out[path] = torch.ones(shape, dtype=torch.float32, device=dev)
        elif rule == "a_log":
            row = torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                           dtype=torch.float32, device=dev))
            out[path] = row.expand(shape).contiguous()
        elif rule not in ("normal", "conv"):
            raise ValueError(f"unknown init rule {rule!r} of {path}")
    return {p: out[p] for p, _, _ in layout}
