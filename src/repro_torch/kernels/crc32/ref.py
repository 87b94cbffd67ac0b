"""Plain-torch version of the CRC-32 kernel's decomposition, and the tables
the kernel reads.

CRC-32 here is ``zlib.crc32``'s: the reflected polynomial 0xEDB88320, the
register preset to 0xFFFFFFFF and inverted at the end, chained across
calls through ``crc``. In the reflected form a 32-bit word is a
polynomial of degree < 32 whose x^0 coefficient is the top bit, and
``R(c, D)``, the register after the bytes D from the register c, is linear:

  R(c, D) = shift(c, |D|) ^ R(0, D),   shift(c, d) = c * x^(8d) mod P,

so the CRCs of pieces computed apart combine by shifting each by the
bytes that follow it. Leading zero bytes leave R(0, .) unchanged.

``crc32_ref`` repeats the kernel's arithmetic step for step (the wrapper
runs ``zlib`` on CPU tensors; the tests and ``bench_kernels`` call this):
the register the CRC starts from (the preset, chained from ``crc``) is
xored into the first four bytes (R(c, D) = R(0, D with c xored into its
first four bytes)); the first ``n16`` bytes (a multiple of 16) are
front-padded with zeros to whole blocks of ``BLOCK_BYTES``; in each block
thread t folds its 64-byte unit of every 16 KB tile through the
slicing-by-16 tables, carrying its register across the tile between; a
log-depth tree over the block's threads carries each thread's register to
the block's end; the blocks' CRCs are combined by a second tree; the last
``n % 16`` bytes and the final inversion come last.
Every shift is a precomputed operator held as four byte tables
(``apply``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0xEDB88320
THREADS = 256                  # a block's threads
UNIT = 64                      # bytes a thread folds per tile
ITERS = 16                     # tiles a block
TILE = THREADS * UNIT          # 16 KB
BLOCK_BYTES = TILE * ITERS     # 256 KB
COMBINE_THREADS = 256          # the combining block's threads
SLICE = 16                     # slicing tables T_0 .. T_15
LOOP_OP = SLICE                # shift by TILE - UNIT: tables 16..19
POW2 = SLICE + 4               # shift by 2^k bytes: tables POW2 + 4k ..
N_POW2 = 48                    # k < 48: any tensor's length
N_TABLES = POW2 + 4 * N_POW2


def mulmod(a: int, b):
    """a * b mod P (zlib's ``multmodp``), ``b`` an int or an int64 array."""
    p = b * 0
    for i in range(32):
        if a & (1 << (31 - i)):
            p = p ^ b
        b = (b >> 1) ^ (POLY * (b & 1))
    return p


def x8nmodp(n: int) -> int:
    """x^(8n) mod P: the operator that shifts a register by n bytes."""
    p, sq = 1 << 31, 1 << 23           # x^0, x^8
    while n:
        if n & 1:
            p = mulmod(sq, p)
        sq = mulmod(sq, sq)
        n >>= 1
    return p


def _op_tables(d: int) -> np.ndarray:
    """The four byte tables of shift-by-d: row j maps byte j of the
    register to its share of the shifted register."""
    op, v = x8nmodp(d), np.arange(256, dtype=np.int64)
    return np.stack([mulmod(op, v << (8 * j)) for j in range(4)])


@functools.lru_cache(maxsize=None)
def tables() -> np.ndarray:
    """(N_TABLES, 256) uint32: T_k[v] = R(0, v then k zero bytes) for the
    slicing, then the loop's shift by TILE - UNIT, then shift by 2^k bytes
    for every k < N_POW2."""
    t = np.zeros((N_TABLES, 256), np.int64)
    for v in range(256):
        c = v
        for _ in range(8):
            c = (c >> 1) ^ (POLY * (c & 1))
        t[0, v] = c
    for k in range(1, SLICE):
        t[k] = (t[k - 1] >> 8) ^ t[0][t[k - 1] & 0xFF]
    t[LOOP_OP:LOOP_OP + 4] = _op_tables(TILE - UNIT)
    for k in range(N_POW2):
        t[POW2 + 4 * k:POW2 + 4 * k + 4] = _op_tables(1 << k)
    return t.astype(np.uint32)


def apply(T: torch.Tensor, first: int, c: torch.Tensor) -> torch.Tensor:
    """Tables ``first`` .. ``first + 3`` of the flat table ``T`` applied to
    the registers ``c`` (int64): the shift they hold."""
    out = T[first * 256 + (c & 0xFF)]
    for j in range(1, 4):
        out = out ^ T[(first + j) * 256 + ((c >> (8 * j)) & 0xFF)]
    return out


def _fold16(T, c, b):
    """Slicing-by-16: the register after the 16 bytes ``b`` (..., 16),
    int64, from the register ``c``: byte i goes through T_(15-i), the
    register folded into the first four."""
    out = 0
    for i in range(16):
        idx = b[..., i] ^ ((c >> (8 * i)) & 0xFF) if i < 4 else b[..., i]
        out = out ^ T[(15 - i) * 256 + idx]
    return out


def _shift_pow2(T, c, k):
    return apply(T, POW2 + 4 * k, c)


def _block_crcs(T, raw: torch.Tensor) -> torch.Tensor:
    """The kernel's first pass: R(0, block) of each BLOCK_BYTES block of
    ``raw`` (a multiple of 16 bytes) front-padded with zeros."""
    n16 = raw.numel()
    nb = -(-n16 // BLOCK_BYTES)
    v = torch.cat([raw.new_zeros(nb * BLOCK_BYTES - n16), raw])
    units = v.view(nb, ITERS, THREADS, UNIT)
    acc = torch.zeros((nb, THREADS), dtype=torch.int64, device=raw.device)
    for i in range(ITERS):
        c = apply(T, LOOP_OP, acc)
        u = units[:, i].to(torch.int64)
        for q in range(UNIT // 16):
            c = _fold16(T, c, u[..., 16 * q:16 * q + 16])
        acc = c
    for j in range(8):                     # THREADS = 2^8
        pair = acc.view(nb, -1, 2)
        acc = _shift_pow2(T, pair[..., 0], 6 + j) ^ pair[..., 1]
    return acc.view(nb)


def _combine(T, blocks: torch.Tensor) -> int:
    """The kernel's second pass: R(0, all blocks) from each block's CRC,
    thread t folding ``per`` of them (a power of two, zeros in front), then
    a tree over the threads."""
    nb = blocks.numel()
    lg = 0
    while (COMBINE_THREADS << lg) < nb:
        lg += 1
    per = 1 << lg
    v = torch.cat([blocks.new_zeros(per * COMBINE_THREADS - nb), blocks])
    v = v.view(COMBINE_THREADS, per)
    acc = torch.zeros(COMBINE_THREADS, dtype=torch.int64,
                      device=blocks.device)
    blk = BLOCK_BYTES.bit_length() - 1
    for k in range(per):
        acc = _shift_pow2(T, acc, blk) ^ v[:, k]
    s = 0
    while acc.numel() > 1:
        pair = acc.view(-1, 2)
        acc = _shift_pow2(T, pair[:, 0], blk + lg + s) ^ pair[:, 1]
        s += 1
    return int(acc[0])


def crc32_ref(t: torch.Tensor, crc: int = 0) -> int:
    """``zlib.crc32`` of ``t``'s raw bytes chained from ``crc``, computed
    by the kernel's decomposition with torch on ``t``'s device."""
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    T = torch.from_numpy(tables().astype(np.int64)).reshape(-1).to(
        raw.device)
    n = raw.numel()
    n16 = n - n % 16
    c = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    if n16:
        head = raw[:n16].clone()
        head[:4] ^= torch.tensor(list(c.to_bytes(4, "little")),
                                 dtype=torch.uint8, device=raw.device)
        c = _combine(T, _block_crcs(T, head))
    for b in raw[n16:].tolist():
        c = (c >> 8) ^ int(tables()[0, (c ^ b) & 0xFF])
    return c ^ 0xFFFFFFFF
