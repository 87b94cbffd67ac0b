"""Wrapper of the RG-LRU scan kernel.

``rglru_scan_op(log_a, gated, h0=None)`` takes log_a and gated (B,S,W) and
an optional initial state h0 (B,W), and returns (h (B,S,W), h_final (B,W))
in float32, for any S and W (the TPU kernel's VMEM tile sizes ``bs``/``bw``
have no counterpart). On a CUDA tensor it launches the Hopper kernel of
``csrc/rglru_scan.cu`` (or raises); on a CPU tensor it runs the plain-torch
version in ``ref.py``. Launches are counted in ``rglru_scan_op.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


def _check(log_a, gated, h0):
    if log_a.dim() != 3 or log_a.shape != gated.shape:
        raise ValueError(f"want log_a, gated (B,S,W); got "
                         f"{tuple(log_a.shape)}, {tuple(gated.shape)}")
    B, S, W = log_a.shape
    if h0 is not None and tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 {tuple(h0.shape)} is not (B,W) = {(B, W)}")
    ts = (log_a, gated) + ((h0,) if h0 is not None else ())
    if len({t.device for t in ts}) != 1:
        raise ValueError("all inputs must be on one device")


# the C entry point: log_a, gated, h0, h, h_final, B, S, W, stream
LAUNCH = ("rglru_scan", "rglru_scan_launch",
          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _f32(t):
    """``t`` as contiguous float32, copied only when it is not already."""
    if t.dtype != torch.float32:
        t = t.float()
    return t if t.is_contiguous() else t.contiguous()


def _rglru_cuda(log_a, gated, h0):
    B, S, W = log_a.shape
    la, g = _f32(log_a), _f32(gated)
    h0 = None if h0 is None else _f32(h0)
    h = torch.empty((B, S, W), dtype=torch.float32, device=la.device)
    hT = torch.empty((B, W), dtype=torch.float32, device=la.device)
    err = _build.fn(*LAUNCH)(la.data_ptr(), g.data_ptr(),
                             None if h0 is None else h0.data_ptr(),
                             h.data_ptr(), hT.data_ptr(), B, S, W,
                             _build.stream(la.device))
    _build.check(err, "rglru_scan_launch")
    return h, hT


def rglru_scan_op(log_a, gated, h0=None):
    """h_t = exp(log_a_t) * h_{t-1} + gated_t over (B,S,W), seeded from h0
    (B,W) or zeros. Returns (h (B,S,W), h_final (B,W)), float32."""
    _check(log_a, gated, h0)
    if log_a.is_cuda:
        rglru_scan_op.launches += 1
        return _rglru_cuda(log_a, gated, h0)
    if log_a.device.type != "cpu":
        raise RuntimeError(f"no rglru_scan kernel for device {log_a.device}")
    return rglru_scan_ref(log_a, gated, h0)


rglru_scan_op.launches = 0
