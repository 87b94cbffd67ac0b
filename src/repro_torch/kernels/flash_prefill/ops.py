"""Wrappers of the flash prefill kernel, in the model's layout.

``flash_seq_op`` (whole-prompt prefill, the TPU's static-offset
``flash_prefill``) and ``flash_chunk_op`` (chunked prefill against the slot
cache, the TPU's ``flash_prefill_dyn``) take q (B,S,H,D) and k,v (B,T,Hk,D)
and return (B,S,H,D). Both launch the one Hopper kernel of
``csrc/flash_prefill.cu``, whose query offset is a launch argument.

On a CUDA tensor a wrapper launches the kernel (or raises); on a CPU tensor
it runs the plain-torch version in ``ref.py``. Each wrapper counts its own
launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

HEAD_DIMS = (32, 64, 128, 160)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _block_size(n: int, cap: int = 128) -> int:
    """Largest power-of-two divisor of ``n``, capped at ``cap``. The engine
    pads sequences to 32-token buckets, so this is >= 32 on the serving
    path; the decode path uses it as its page size."""
    return min(cap, n & -n)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,D), k/v (B,T,Hk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch, head_dim or GQA grouping")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def _flash_cuda(q, k, v, q_offset: int, window: Optional[int]):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_prefill kernel takes float32/bfloat16, "
                        f"not {q.dtype}")
    B, S, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_prefill kernel has no head_dim {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_prefill kernel needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_prefill kernel needs 16-byte aligned q, k, v")
    fn = _build.load("flash_prefill").flash_prefill_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             B, H, k.shape[2], S, k.shape[1], D, int(q_offset),
             int(window or 0), 1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill_launch")
    return o


def _flash_plain(q, k, v, q_offset: int, window: Optional[int]):
    if q.device.type != "cpu":
        raise RuntimeError(f"no flash_prefill kernel for device {q.device}")
    o = flash_prefill_ref(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), q_offset=int(q_offset),
                          window=window)
    return o.transpose(1, 2)


def flash_seq_op(q, k, v, *, window: Optional[int] = None):
    """Full-sequence causal attention in model layout — q (B,S,H,D);
    k,v (B,T,Hk,D) -> (B,S,H,D); query i sits at position T - S + i."""
    _check(q, k, v, window)
    q_offset = k.shape[1] - q.shape[1]
    if q.is_cuda:
        flash_seq_op.launches += 1
        return _flash_cuda(q, k, v, q_offset, window)
    return _flash_plain(q, k, v, q_offset, window)


def flash_chunk_op(q, k, v, q_offset: int, *, window: Optional[int] = None):
    """Chunked-prefill attention in model layout — q (B,Sq,H,D) at absolute
    positions [q_offset, q_offset+Sq); k,v (B,C,Hk,D) the whole slot cache,
    positions [0, q_offset) assumed contiguously valid (the engine's KV
    prefix contract). The offset is a host int and a launch argument, so
    no offset ever needs a new build. Returns (B,Sq,H,D)."""
    _check(q, k, v, window)
    if q.is_cuda:
        flash_chunk_op.launches += 1
        return _flash_cuda(q, k, v, q_offset, window)
    return _flash_plain(q, k, v, q_offset, window)


flash_seq_op.launches = 0
flash_chunk_op.launches = 0
