"""Bit-exact torch port of JAX's threefry2x32 ``PRNGKey``, ``fold_in`` and
``gumbel``, as the serving engine's sampler derives its keys.

This is JAX's **non-partitionable** mode (``jax_threefry_partitionable``
False), the mode the engine's golden sampled streams were recorded under:
random bits for a shape of n values hash the counters 0..n-1, split into a
first and a second half, and concatenate the two output words.

A key is an int64 tensor of shape (..., 2) holding two uint32 words. Every
uint32 operation runs in int64 and is masked with ``& 0xFFFFFFFF``, since
torch has no unsigned 32-bit arithmetic. All functions are batched over the
leading dimensions of the key, so one call serves a whole decode batch.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = 1.1754943508222875e-38          # float32 finfo.tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 with 20 rounds (JAX's ``_threefry2x32_lowering``);
    arguments are int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed, device=None):
    """``jax.random.PRNGKey(seed)`` for int32 seeds: words (0, seed).
    ``seed`` is an int or an integer tensor (batched keys)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: hash the counter pair (0, data)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    h0, h1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([h0, h1], dim=-1)


def random_bits(key, n: int):
    """32-bit random words of shape (..., n) under ``key`` (..., 2)."""
    half = (n + 1) // 2
    counts = torch.arange(2 * half, dtype=torch.int64, device=key.device)
    if n % 2:
        counts[-1] = 0                       # JAX pads an odd count with 0
    k1, k2 = key[..., 0:1], key[..., 1:2]
    h0, h1 = threefry2x32(k1, k2, counts[:half], counts[half:])
    return torch.cat([h0, h1], dim=-1)[..., :n]


def uniform(key, n: int, minval: float = 0.0):
    """``jax.random.uniform(key, (n,), float32, minval, 1.0)``."""
    bits = random_bits(key, n)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    scale = torch.tensor(1.0, dtype=torch.float32, device=key.device) - lo
    return torch.maximum(lo, floats * scale + lo)


def gumbel(key, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low")."""
    return -torch.log(-torch.log(uniform(key, n, minval=_TINY_F32)))
