"""Wrapper of the CRC-32 kernel.

``crc32_op(t, crc=0)`` is ``zlib.crc32(bytes of t, crc)``: the CRC-32 of a
tensor's raw bytes (contiguous, in memory order), chained from ``crc``, so
that ``crc32_op(b, crc32_op(a))`` is the CRC of a's bytes then b's. On a
CUDA tensor it launches the two kernels of ``csrc/crc32.cu`` and reads back
the one 32-bit result (the call synchronises its stream); on a CPU tensor
it runs ``zlib`` over the bytes in place. The path follows the tensor's
device: there is no fallback from one to the other. Launches are counted
in ``crc32_op.launches``.
"""
from __future__ import annotations

import ctypes
import zlib
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.crc32.ref import BLOCK_BYTES, tables

# the C entry point: data, n, tables, scratch, prev, stream
LAUNCH = ("crc32", "crc32_launch",
          [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
           ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p])
_TABLES: Dict[int, torch.Tensor] = {}


def kernel_attrs() -> dict:
    """Registers, local-memory (spill) bytes, static shared memory and
    resident blocks per SM of ``crc32_blocks``, as the CUDA runtime
    reports them (card only)."""
    r, lo, sm, bl = (ctypes.c_int() for _ in range(4))
    err = _build.load("crc32").crc32_attrs(
        ctypes.byref(r), ctypes.byref(lo), ctypes.byref(sm), ctypes.byref(bl))
    _build.check(err, "crc32_attrs")
    return {"crc32_blocks": {"registers": r.value, "local_bytes": lo.value,
                             "smem_bytes": sm.value,
                             "blocks_per_sm": bl.value}}


def _device_tables(device: torch.device) -> torch.Tensor:
    """``ref.tables()`` on ``device``, uploaded once."""
    t = _TABLES.get(device.index)
    if t is None:
        t = torch.from_numpy(tables().view(np.int32)).to(device)
        _TABLES[device.index] = t
    return t


def _crc32_cuda(raw: torch.Tensor, crc: int) -> int:
    if raw.data_ptr() % 16:
        raw = raw.clone()            # a fresh block: the 16-byte loads
    n = raw.numel()
    nb = (n - n % 16 + BLOCK_BYTES - 1) // BLOCK_BYTES
    scratch = _build.scratch("crc32", raw.device, nb + 1)
    err = _build.fn(*LAUNCH)(raw.data_ptr(), n,
                             _device_tables(raw.device).data_ptr(),
                             scratch.data_ptr(), crc & 0xFFFFFFFF,
                             _build.stream(raw.device))
    _build.check(err, "crc32_launch")
    return int(scratch[nb:nb + 1].view(torch.int32).item()) & 0xFFFFFFFF


def crc32_host(t: torch.Tensor, crc: int = 0) -> int:
    """``zlib.crc32`` over a host tensor's raw bytes, read in place."""
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    return zlib.crc32(raw.numpy(), crc)


def crc32_op(t: torch.Tensor, crc: int = 0) -> int:
    """CRC-32 (``zlib.crc32``'s) of ``t``'s raw bytes, chained from
    ``crc``."""
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    if raw.is_cuda:
        crc32_op.launches += 1
        return _crc32_cuda(raw, crc)
    if raw.device.type != "cpu":
        raise RuntimeError(f"no crc32 kernel for device {raw.device}")
    return crc32_host(raw, crc)


crc32_op.launches = 0
