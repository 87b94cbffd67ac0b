"""Wrapper of the paged decode-attention kernel.

``paged_attention_op`` takes q (B,H,D), k/v pages (P, page, Hk, D), a page
table (B, MP) and context lengths (B,), both int32, and returns (B,H,D). On
a CUDA tensor it launches the Hopper kernel of ``csrc/paged_attention.cu``
(or raises); on a CPU tensor it runs the plain-torch version in ``ref.py``.
Its launches are counted in ``paged_attention_op.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k_pages, v_pages, page_table, lengths):
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"want q (B,H,D), pages (P,page,Hk,D); got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    B, H, D = q.shape
    if k_pages.shape[3] != D or H % k_pages.shape[2]:
        raise ValueError("q and pages disagree on head_dim or GQA grouping")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"want page_table (B,MP), lengths (B,); got "
                         f"{tuple(page_table.shape)}, {tuple(lengths.shape)}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    devs = {t.device for t in (q, k_pages, v_pages, page_table, lengths)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def _paged_cuda(q, k_pages, v_pages, page_table, lengths):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_attention kernel takes float32/bfloat16, "
                        f"not {q.dtype}")
    ts = (q, k_pages, v_pages, page_table, lengths)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_attention kernel needs contiguous inputs")
    B, H, D = q.shape
    _, page, Hk, _ = k_pages.shape
    MP = page_table.shape[1]
    if D > 256 or MP > 65535:
        raise ValueError(f"paged_attention kernel takes D <= 256 and at "
                         f"most 65535 pages a row, got D={D}, MP={MP}")
    fn = _build.load("paged_attention").paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    # per-page partial (acc[D], max, sum) of every (row, kv head, page, head)
    part = torch.empty(B * Hk * MP * (H // Hk) * (D + 2),
                       dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), part.data_ptr(),
             o.data_ptr(), B, H, Hk, D, page, MP, 1.0 / math.sqrt(D),
             _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention_launch")
    return o


def paged_attention_op(q, k_pages, v_pages, page_table, lengths):
    """Decode attention of q (B,H,D) over positions [0, lengths[b]) of the
    pages ``page_table[b]`` lists. Returns (B,H,D) in q's dtype."""
    _check(q, k_pages, v_pages, page_table, lengths)
    if q.is_cuda:
        paged_attention_op.launches += 1
        return _paged_cuda(q, k_pages, v_pages, page_table, lengths)
    if q.device.type != "cpu":
        raise RuntimeError(f"no paged_attention kernel for device {q.device}")
    return paged_attention_ref(q, k_pages, v_pages, page_table, lengths)


paged_attention_op.launches = 0
