"""Operations and bytes of one call of each hand-written kernel at the
shapes the serving engine hands it, and the least time the card could
take for it (the larger of bytes over the memory rate and operations over
the peak of their type). Each input byte is counted read once and each
output byte written once; the counts are those of ``bench_kernels`` in the
program (``repro_torch/bench/bench_kernels.py``), frozen here.
"""
from __future__ import annotations

from arrow_bench import peaks


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peak)


def flash_chunk(sq: int, offset: int, heads: int, kv_heads: int,
                head_dim: int, el: int = 2):
    """(bytes, operations) of causal attention of ``sq`` queries at
    absolute positions [offset, offset + sq) over the keys [0, offset + sq)
    of one sequence: q read and o written, K and V of the valid positions
    read once; QK^T and PV over the causal pairs."""
    valid = offset + sq
    pairs = sq * offset + sq * (sq + 1) // 2
    nbytes = el * (2 * sq * heads * head_dim + 2 * valid * kv_heads * head_dim)
    return nbytes, 4.0 * head_dim * heads * pairs


def paged_decode(lengths, heads: int, kv_heads: int, head_dim: int,
                 capacity: int, el: int = 2):
    """(bytes, operations) of single-query decode attention of one row a
    slot over its first ``lengths[b]`` cached positions, the slot's cache
    viewed as contiguous pages (the program's page: the largest power of
    two dividing the capacity, at most 128), with the int32 page table and
    lengths."""
    B, live = len(lengths), sum(lengths)
    page = min(128, capacity & -capacity)
    nbytes = (el * (2 * B * heads * head_dim + 2 * live * kv_heads * head_dim)
              + 4 * (B * (capacity // page) + B))
    return nbytes, 4.0 * head_dim * heads * live


def ssd_chunk(s_pad: int, heads: int, head_dim: int, d_state: int,
              groups: int, chunk: int):
    """(bytes, operations) of the SSD scan of one row of ``s_pad``
    positions (a whole number of chunks) from a carried state, float32:
    x, the log decay, B, C (per group) and h0 read, y and the final state
    written; within each chunk the C.B^T and masked-decay products over the
    causal pairs, the chunk's state and the carried state's read-out."""
    nc, pairs = s_pad // chunk, chunk * (chunk + 1) // 2
    flops = nc * (heads * (2 * pairs * head_dim + 2 * 2 * chunk * d_state
                           * head_dim) + groups * 2 * pairs * d_state)
    state = heads * head_dim * d_state
    nbytes = 4 * (s_pad * heads * head_dim + s_pad * heads
                  + 2 * s_pad * groups * d_state + state
                  + s_pad * heads * head_dim + state)
    return nbytes, float(flops)


def bucket32(n: int, cap: int) -> int:
    """The program's chunk width: ``n`` rounded up to 32, at most ``cap``."""
    return min(-(-n // 32) * 32, cap)
