"""Wrapper of the SSD chunked-scan kernel, in the model's layout.

``ssd_scan_op(x, la, Bm, Cm, chunk, h0=None)`` takes x (B,S,H,P) already
scaled by dt, la (B,S,H), Bm/Cm (B,S,G,N) with G dividing H (G = H is the
per-head form of the JAX contract; head h reads group h // (H/G), as
``jnp.repeat(..., axis=2)`` would expand it) and an optional initial state
h0 (B,H,P,N), and returns (y (B,S,H,P), h_final (B,H,P,N)) in float32.
``S`` must be a multiple of ``chunk``. On a CUDA tensor it launches the
Hopper kernels of ``csrc/ssd_scan.cu`` (or raises), reading the model
layout directly; on a CPU tensor it runs the sequential plain-torch version
in ``ref.py``. Launches are counted in ``ssd_scan_op.launches``.
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
        raise ValueError(f"want x (B,S,H,P), la (B,S,H), Bm/Cm (B,S,G,N); "
                         f"got {tuple(x.shape)}, {tuple(la.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(la.shape) != (B, S, H) or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError("x, la, Bm and Cm disagree on (B, S, H)")
    if G <= 0 or H % G:
        raise ValueError(f"Bm/Cm have {G} groups, which do not divide the "
                         f"{H} heads")
    if h0 is not None and tuple(h0.shape) != (B, H, P, N):
        raise ValueError(f"h0 {tuple(h0.shape)} is not (B,H,P,N) = "
                         f"{(B, H, P, N)}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    ts = (x, la, Bm, Cm) + ((h0,) if h0 is not None else ())
    if len({t.device for t in ts}) != 1:
        raise ValueError("all inputs must be on one device")


def scratch_floats(B: int, S: int, H: int, G: int, P: int, N: int,
                   chunk: int) -> int:
    """float32 scratch of one call: each (row, group, chunk)'s C.B^T
    (chunk x chunk), then each (row, chunk, head)'s state term (P x N) and
    its in-chunk prefix sum of the log decay (chunk)."""
    nc = S // chunk
    return B * G * nc * chunk * chunk + B * nc * H * (P * N + chunk)


# the C entry point: x, la, Bm, Cm, h0, y, h_final, scratch, B, S, H, G,
# P, N, Q, stream
LAUNCH = ("ssd_scan", "ssd_scan_launch",
          [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def kernel_attrs() -> dict:
    """Registers, local-memory (spill) bytes, dynamic shared memory and
    resident blocks per SM of the three phases, as the CUDA runtime
    reports them (card only)."""
    out = {}
    for which, name in enumerate(("ssd_cb", "ssd_chunk", "ssd_state")):
        r, lo, sm, bl = (ctypes.c_int() for _ in range(4))
        err = _build.load("ssd_scan").ssd_scan_attrs(
            which, ctypes.byref(r), ctypes.byref(lo), ctypes.byref(sm),
            ctypes.byref(bl))
        _build.check(err, "ssd_scan_attrs")
        out[name] = {"registers": r.value, "local_bytes": lo.value,
                     "smem_bytes": sm.value, "blocks_per_sm": bl.value}
    return out


def _f32(t):
    """``t`` as contiguous, 16-byte aligned float32 (the kernel's 16-byte
    copies), copied only when it is not already."""
    if t.dtype != torch.float32:
        t = t.float()
    if not t.is_contiguous():
        t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _ssd_cuda(x, la, Bm, Cm, chunk, h0):
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if chunk > MAX_CHUNK or chunk % 8 or N > MAX_STATE or N % 8 or P % 8:
        raise ValueError(f"ssd_scan kernel takes chunk <= {MAX_CHUNK} and "
                         f"d_state <= {MAX_STATE}, and chunk, d_state and "
                         f"head_dim multiples of 8; got chunk={chunk}, "
                         f"N={N}, P={P}")
    ts = [_f32(t) for t in (x, la, Bm, Cm)]
    h0 = None if h0 is None else _f32(h0)
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    hT = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    scratch = _build.scratch("ssd_scan", x.device,
                             scratch_floats(B, S, H, G, P, N, chunk))
    err = _build.fn(*LAUNCH)(*(t.data_ptr() for t in ts),
                             None if h0 is None else h0.data_ptr(),
                             y.data_ptr(), hT.data_ptr(), scratch.data_ptr(),
                             B, S, H, G, P, N, chunk,
                             _build.stream(x.device))
    _build.check(err, "ssd_scan_launch")
    return y, hT


def ssd_scan_op(x, la, Bm, Cm, chunk: int, *, h0=None):
    """The SSD scan of x (B,S,H,P) (dt-scaled), la (B,S,H), Bm/Cm
    (B,S,G,N) with G dividing H, seeded from h0 (B,H,P,N) or zeros.
    Returns (y (B,S,H,P), h_final (B,H,P,N)), float32."""
    _check(x, la, Bm, Cm, chunk, h0)
    if x.is_cuda:
        _build.refuse_grad("ssd_scan_op", x, la, Bm, Cm,
                           *([] if h0 is None else [h0]))
        ssd_scan_op.launches += 1
        return _ssd_cuda(x, la, Bm, Cm, chunk, h0)
    if x.device.type != "cpu":
        raise RuntimeError(f"no ssd_scan kernel for device {x.device}")
    return ssd_scan_ref(x, la, Bm, Cm, h0)


ssd_scan_op.launches = 0
