"""Wrappers of the flash prefill kernel, in the model's layout.

``flash_seq_op`` (whole-prompt prefill, the TPU's static-offset
``flash_prefill``) and ``flash_chunk_op`` (chunked prefill against the slot
cache, the TPU's ``flash_prefill_dyn``) take q (B,S,H,D) and k,v (B,T,Hk,D)
and return (B,S,H,D). Both launch the Hopper kernels of
``csrc/flash_prefill.cu``, whose query offset is a launch argument; ``plan``
says how a call is cut (route, query tile, kv splits), in Python so the CPU
tests reach it.

On a CUDA tensor a wrapper launches the kernel (or raises); on a CPU tensor
it runs the plain-torch version in ``ref.py``. Each wrapper counts its own
launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import SM_COUNT
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

HEAD_DIMS = (32, 64, 128, 160)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                # rows of a query tile and of a kv tile (wgmma)
MIN_SPLIT_TILES = 2      # kv tiles a split must get before the walk splits
MAX_SPLIT = 8


class FlashPlan(NamedTuple):
    """How the kernel cuts one call. ``route``: "wgmma" (bf16, head_dim 64
    or 128, G = H/Hk <= 64), "mma" (other bf16 head dims) or "simt"
    (float32). On the wgmma route a tile's 64 rows are G query heads x
    ``qp`` query positions of one kv head, and each tile's kv walk is cut
    into ``n_split`` splits whose float32 partials (``scratch`` values) a
    merge pass combines."""
    route: str
    qp: int
    n_qt: int
    n_split: int
    blocks: int
    scratch: int


def kv_tile_range(qt: int, qp: int, Sq: int, T: int, q_offset: int,
                  window: Optional[int]) -> Tuple[int, int]:
    """The kv tiles [t0, t1) (of ``TILE`` positions) that query tile ``qt``
    walks: from the window bound of its first row to the causal bound of
    its last, inside the T cached positions."""
    q0 = qt * qp
    q_last = min(q0 + qp, Sq) - 1
    kv_end = min(T, q_offset + q_last + 1)
    kv_begin = max(0, q_offset + q0 - window + 1) if window else 0
    t0 = kv_begin // TILE
    return t0, t0 + max(0, -(-kv_end // TILE) - t0)


def split_range(t0: int, t1: int, split: int, n_split: int
                ) -> Tuple[int, int]:
    """Split ``split`` of ``n_split`` of the kv tiles [t0, t1) (the kernel's
    ``kv_split``): contiguous, disjoint, covering; empty where the walk has
    fewer tiles than splits."""
    n = t1 - t0
    return t0 + n * split // n_split, t0 + n * (split + 1) // n_split


@functools.lru_cache(maxsize=4096)
def plan(B: int, H: int, Hk: int, Sq: int, T: int, D: int, q_offset: int,
         window: Optional[int], dtype=torch.bfloat16) -> FlashPlan:
    """The launch plan of one call (pure arithmetic on the shapes). Splits
    the kv walk while the grid fits in the two wgmma blocks an SM holds, and
    only while the longest walk (the last query tile's) keeps
    ``MIN_SPLIT_TILES`` tiles a split. Cached: the engine repeats a few
    shapes and offsets."""
    G = H // Hk
    if dtype != torch.bfloat16:
        n = -(-Sq // 32)
        return FlashPlan("simt", 32, n, 1, n * H * B, 0)
    if D not in (64, 128) or G > TILE:
        n = -(-Sq // 64)
        return FlashPlan("mma", 64, n, 1, n * H * B, 0)
    qp = TILE // G
    n_qt = -(-Sq // qp)
    base = B * Hk * n_qt
    t0, t1 = kv_tile_range(n_qt - 1, qp, Sq, T, q_offset, window)
    n_split = max(1, min(2 * SM_COUNT // base, (t1 - t0) // MIN_SPLIT_TILES,
                         MAX_SPLIT))
    scratch = n_split * base * TILE * (D + 2) if n_split > 1 else 0
    return FlashPlan("wgmma", qp, n_qt, n_split, base * n_split, scratch)


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


# the C entry point: q, k, v, o, part, B, H, Hk, Sq, Tk, D, q_offset,
# window, scale, dtype, qp, n_split, stream
LAUNCH = ("flash_prefill", "flash_prefill_launch",
          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float]
          + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def wgmma_attrs(D: int) -> dict:
    """Registers, local-memory (spill) bytes and dynamic shared memory of
    the wgmma kernel at head_dim ``D``, as the CUDA runtime reports them
    (card only)."""
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _build.load("flash_prefill").flash_prefill_wgmma_attrs(
        D, ctypes.byref(regs), ctypes.byref(local), ctypes.byref(smem))
    _build.check(err, "flash_prefill_wgmma_attrs")
    return {"registers": regs.value, "local_bytes": local.value,
            "smem_bytes": smem.value}


def _flash_cuda(q, k, v, q_offset: int, window: Optional[int]):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_prefill kernel takes float32/bfloat16, "
                        f"not {q.dtype}")
    B, S, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_prefill kernel has no head_dim {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_prefill kernel needs contiguous q, k, v")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError("flash_prefill kernel needs 16-byte aligned q, k, v")
    Hk, T = k.shape[2], k.shape[1]
    q_offset, window = int(q_offset), int(window or 0)
    pl = plan(B, H, Hk, S, T, D, q_offset, window or None, q.dtype)
    o = torch.empty_like(q)
    part = _build.scratch("flash_prefill", q.device, pl.scratch).data_ptr() \
        if pl.scratch else None
    err = _build.fn(*LAUNCH)(*ptrs, o.data_ptr(), part,
                             B, H, Hk, S, T, D, q_offset, window,
                             1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype], pl.qp,
                             pl.n_split, _build.stream(q.device))
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
        _build.refuse_grad("flash_seq_op", q, k, v)
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
        _build.refuse_grad("flash_chunk_op", q, k, v)
        flash_chunk_op.launches += 1
        return _flash_cuda(q, k, v, q_offset, window)
    return _flash_plain(q, k, v, q_offset, window)


flash_seq_op.launches = 0
flash_chunk_op.launches = 0
