"""Wrapper of the paged decode-attention kernel.

``paged_attention_op`` takes q (B,H,D), k/v pages (P, page, Hk, D), a page
table (B, MP) and context lengths (B,), both int32, and returns (B,H,D). On
a CUDA tensor it launches the Hopper kernel of ``csrc/paged_attention.cu``
(or raises); on a CPU tensor it runs the plain-torch version in ``ref.py``.
``plan`` says how a call is cut into splits of consecutive pages, from the
static shapes alone, in Python so the CPU tests reach it. Launches are
counted in ``paged_attention_op.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import SM_COUNT
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BLOCKS_PER_SM = 4        # the grid the plan aims for: four blocks an SM
MIN_SPLIT_TOKENS = 64    # a split gets at least this many positions
MAX_PPS = 64             # page-table entries a split (the kernel's cache)
HEAD_DIMS = (32, 64, 128, 160, 256)
THREADS = 128            # the kernel's block, and its limits on G:
MAX_OWN = 4              # G * D / (16 bytes) <= MAX_OWN * THREADS


class PagedPlan(NamedTuple):
    """How the kernel cuts one call: each (row, kv head) walks its page
    table in ``n_split`` splits of ``pages_per_split`` consecutive entries
    (the last may be shorter), one block each; with more than one split
    the blocks write ``scratch`` float32 partial values that a merge pass
    combines."""
    pages_per_split: int
    n_split: int
    blocks: int
    scratch: int


@functools.lru_cache(maxsize=1024)
def plan(B: int, H: int, Hk: int, D: int, page: int, MP: int) -> PagedPlan:
    """The launch plan of one call (pure arithmetic on static shapes; the
    lengths live on the device and are never read here). Splits each row's
    pages until ``B * Hk * n_split`` fills ``BLOCKS_PER_SM`` blocks on every
    SM, keeping at least ``MIN_SPLIT_TOKENS`` positions a split and at
    most ``MAX_PPS`` pages."""
    base = B * Hk
    want = max(1, -(-BLOCKS_PER_SM * SM_COUNT // base))
    pps = max(-(-MP // want), -(-MIN_SPLIT_TOKENS // page))
    pps = min(pps, MP, MAX_PPS)
    n_split = -(-MP // pps)
    scratch = base * n_split * (H // Hk) * (D + 2) if n_split > 1 else 0
    return PagedPlan(pps, n_split, base * n_split, scratch)


def split_pages(pages_per_split: int, MP: int, split: int
                ) -> Tuple[int, int]:
    """Entries [a, b) of a row's page table that split ``split`` walks (the
    kernel's ``lo``/``hi`` before the row's length cuts them)."""
    a = split * pages_per_split
    return a, min(MP, a + pages_per_split)


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


# the C entry point: q, k_pages, v_pages, page_table, lengths, part, o, B,
# H, Hk, D, page, MP, pages_per_split, n_split, scale, dtype, stream
LAUNCH = ("paged_attention", "paged_attention_launch",
          [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
          + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def kernel_attrs(dtype, G: int) -> dict:
    """Registers, local-memory (spill) bytes and dynamic shared memory of
    the split kernel at head_dim 128, as the CUDA runtime reports them
    (card only)."""
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _build.load("paged_attention").paged_attention_attrs(
        _DTYPE_CODE[dtype], G, ctypes.byref(regs), ctypes.byref(local),
        ctypes.byref(smem))
    _build.check(err, "paged_attention_attrs")
    return {"registers": regs.value, "local_bytes": local.value,
            "smem_bytes": smem.value}


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
    if D not in HEAD_DIMS or (H // Hk) * D * q.element_size() // 16 \
            > MAX_OWN * THREADS:
        raise ValueError(f"paged_attention kernel takes head_dim in "
                         f"{HEAD_DIMS} and at most {MAX_OWN * THREADS} "
                         f"16-byte words across a kv head's query heads; "
                         f"got D={D}, G={H // Hk}, {q.dtype}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention kernel needs 16-byte aligned pages")
    pl = plan(B, H, Hk, D, page, MP)
    o = torch.empty_like(q)
    part = _build.scratch("paged_attention", q.device,
                          pl.scratch).data_ptr() if pl.scratch else None
    err = _build.fn(*LAUNCH)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), part, o.data_ptr(),
        B, H, Hk, D, page, MP, pl.pages_per_split, pl.n_split,
        1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype], _build.stream(q.device))
    _build.check(err, "paged_attention_launch")
    return o


def paged_attention_op(q, k_pages, v_pages, page_table, lengths):
    """Decode attention of q (B,H,D) over positions [0, lengths[b]) of the
    pages ``page_table[b]`` lists. Returns (B,H,D) in q's dtype."""
    _check(q, k_pages, v_pages, page_table, lengths)
    if q.is_cuda:
        _build.refuse_grad("paged_attention_op", q, k_pages, v_pages)
        paged_attention_op.launches += 1
        return _paged_cuda(q, k_pages, v_pages, page_table, lengths)
    if q.device.type != "cpu":
        raise RuntimeError(f"no paged_attention kernel for device {q.device}")
    return paged_attention_ref(q, k_pages, v_pages, page_table, lengths)


paged_attention_op.launches = 0
