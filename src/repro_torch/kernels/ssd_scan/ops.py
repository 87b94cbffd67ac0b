"""Wrapper of the SSD chunked-scan kernel, in the model's layout.

``ssd_scan_op(x, la, Bm, Cm, chunk, h0=None)`` takes x (B,S,H,P) already
scaled by dt, la (B,S,H), per-head Bm/Cm (B,S,H,N) and an optional initial
state h0 (B,H,P,N), and returns (y (B,S,H,P), h_final (B,H,P,N)) in
float32. ``S`` must be a multiple of ``chunk``. On a CUDA tensor it
launches the Hopper kernel of ``csrc/ssd_scan.cu`` (or raises), reading the
model layout directly; on a CPU tensor it runs the sequential plain-torch
version in ``ref.py``. Launches are counted in ``ssd_scan_op.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

MAX_CHUNK = 128          # the kernel's register tiles cover Q <= 128
MAX_STATE = 128          # and N <= 128


def _check(x, la, Bm, Cm, chunk, h0):
    if x.dim() != 4 or la.dim() != 3 or Bm.dim() != 4 \
            or Bm.shape != Cm.shape:
        raise ValueError(f"want x (B,S,H,P), la (B,S,H), Bm/Cm (B,S,H,N); "
                         f"got {tuple(x.shape)}, {tuple(la.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[3]
    if tuple(la.shape) != (B, S, H) or tuple(Bm.shape[:3]) != (B, S, H):
        raise ValueError("x, la, Bm and Cm disagree on (B, S, H)")
    if h0 is not None and tuple(h0.shape) != (B, H, P, N):
        raise ValueError(f"h0 {tuple(h0.shape)} is not (B,H,P,N) = "
                         f"{(B, H, P, N)}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    ts = (x, la, Bm, Cm) + ((h0,) if h0 is not None else ())
    if len({t.device for t in ts}) != 1:
        raise ValueError("all inputs must be on one device")


def _ssd_cuda(x, la, Bm, Cm, chunk, h0):
    B, S, H, P = x.shape
    N = Bm.shape[3]
    if chunk > MAX_CHUNK or chunk % 4 or N > MAX_STATE:
        raise ValueError(f"ssd_scan kernel takes chunk <= {MAX_CHUNK} (a "
                         f"multiple of 4) and d_state <= {MAX_STATE}, got "
                         f"chunk={chunk}, N={N}")
    ts = [t.float().contiguous() for t in (x, la, Bm, Cm)]
    h0 = None if h0 is None else h0.float().contiguous()
    fn = _build.load("ssd_scan").ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    hT = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    err = fn(*(t.data_ptr() for t in ts),
             0 if h0 is None else h0.data_ptr(), y.data_ptr(),
             hT.data_ptr(), B, S, H, P, N, chunk,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan_launch")
    return y, hT


def ssd_scan_op(x, la, Bm, Cm, chunk: int, *, h0=None):
    """The SSD scan of x (B,S,H,P) (dt-scaled), la (B,S,H), Bm/Cm
    (B,S,H,N), seeded from h0 (B,H,P,N) or zeros. Returns (y (B,S,H,P),
    h_final (B,H,P,N)), float32."""
    _check(x, la, Bm, Cm, chunk, h0)
    if x.is_cuda:
        ssd_scan_op.launches += 1
        return _ssd_cuda(x, la, Bm, Cm, chunk, h0)
    if x.device.type != "cpu":
        raise RuntimeError(f"no ssd_scan kernel for device {x.device}")
    return ssd_scan_ref(x, la, Bm, Cm, h0)


ssd_scan_op.launches = 0
