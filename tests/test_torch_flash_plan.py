"""What surrounds the wgmma flash-prefill kernel, on the CPU: the launch
plan (query tile, kv splits) that ops.py hands the kernel, and the split-KV
arithmetic (per-split partial (o, m, l) merged by log-sum-exp) as its
plain-torch twin in ref.py, held against ``flash_prefill_ref`` and against
JAX's ``flash_prefill_dyn`` (Pallas, interpret mode) on the same numpy
inputs at the float32 tolerance 2e-5 of tests/test_kernels.py. The kernel
itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_prefill import flash_prefill_dyn  # noqa: E402
from repro_torch.kernels.flash_prefill.ops import (  # noqa: E402
    SM_COUNT, TILE, kv_tile_range, plan, split_range)
from repro_torch.kernels.flash_prefill.ref import (  # noqa: E402
    flash_prefill_ref, flash_prefill_split_ref)

F32_TOL = dict(rtol=2e-5, atol=2e-5)

# (Sq, T, q_offset, window, G): engine chunks at every offset of a
# 1024-slot cache, the smallest 32-token bucket, whole prompts, ragged
# lengths, windows across tile and split edges, every GQA group size
PLAN_CASES = [
    (256, 1024, 0, None, 2), (256, 1024, 256, None, 2),
    (256, 1024, 512, None, 2), (256, 1024, 768, None, 2),
    (32, 1024, 992, None, 2), (128, 128, 0, None, 2),
    (100, 100, 0, None, 2), (100, 1024, 3, None, 1),
    (256, 1024, 512, 96, 2), (256, 1024, 512, 130, 4),
    (64, 512, 448, 200, 8), (32, 1024, 0, None, 8),
    (256, 256, 0, 64, 1), (96, 1024, 900, None, 6),
    (256, 1024, 700, 1, 16), (17, 40, 23, None, 3),
]


def live_keys(qpos, T, window):
    lo = max(0, qpos - window + 1) if window else 0
    return range(lo, min(T, qpos + 1))


@pytest.mark.parametrize("Sq,T,q_offset,window,G", PLAN_CASES)
def test_plan_splits_cover_live_range_once(Sq, T, q_offset, window, G):
    """Every live (query, key) pair falls in exactly one split of its query
    tile, and the splits of a tile are contiguous, disjoint and inside the
    tile's kv walk."""
    Hk, D = 2, 128
    pl = plan(1, G * Hk, Hk, Sq, T, D, q_offset, window)
    assert pl.route == "wgmma" and pl.qp * G <= TILE
    assert pl.n_qt * pl.qp >= Sq > (pl.n_qt - 1) * pl.qp
    assert pl.blocks == Hk * pl.n_qt * pl.n_split
    for qt in range(pl.n_qt):
        t0, t1 = kv_tile_range(qt, pl.qp, Sq, T, q_offset, window)
        splits = [split_range(t0, t1, s, pl.n_split)
                  for s in range(pl.n_split)]
        assert splits[0][0] == t0 and splits[-1][1] == t1
        assert all(a <= b for a, b in splits)
        assert all(splits[s][1] == splits[s + 1][0]
                   for s in range(pl.n_split - 1))
        for pos in range(qt * pl.qp, min(qt * pl.qp + pl.qp, Sq)):
            for j in live_keys(q_offset + pos, T, window):
                hits = sum(a * TILE <= j < b * TILE for a, b in splits)
                assert hits == 1, (qt, pos, j, splits)


@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 8])
def test_split_range_is_a_partition(n_split):
    for t0, n in itertools.product((0, 3, 7), range(0, 20)):
        got = [split_range(t0, t0 + n, s, n_split) for s in range(n_split)]
        tiles = [t for a, b in got for t in range(a, b)]
        assert tiles == list(range(t0, t0 + n))


def test_plan_fills_the_card_at_the_engine_chunk():
    """The dyn check shape (a 256-token chunk at offset 512 of a 1024-slot
    cache, qwen3-1.7b's 16/8 heads of 128) gets at least one full wave."""
    pl = plan(1, 16, 8, 256, 1024, 128, 512, None)
    assert pl.blocks >= SM_COUNT and pl.n_split > 1
    assert pl.scratch == pl.blocks * TILE * (128 + 2)
    seq = plan(1, 16, 8, 128, 128, 128, 0, None)     # too short to split
    assert (seq.n_split, seq.scratch, seq.blocks) == (1, 0, 32)


@pytest.mark.parametrize("D,G,dtype,route", [
    (128, 2, torch.bfloat16, "wgmma"), (64, 8, torch.bfloat16, "wgmma"),
    (32, 2, torch.bfloat16, "mma"), (160, 4, torch.bfloat16, "mma"),
    (128, 128, torch.bfloat16, "mma"), (128, 2, torch.float32, "simt")])
def test_plan_route_is_a_switch_on_shape(D, G, dtype, route):
    pl = plan(2, G * 2, 2, 256, 512, D, 256, None, dtype)
    assert pl.route == route
    if route != "wgmma":
        assert pl.n_split == 1 and pl.scratch == 0


def empty_split_rows(Sq, T, q_offset, window, qp, n_split):
    """Count (tile, split, row) triples whose split holds no live key."""
    n = 0
    for qt in range(-(-Sq // qp)):
        t0, t1 = kv_tile_range(qt, qp, Sq, T, q_offset, window)
        for s in range(n_split):
            a, b = split_range(t0, t1, s, n_split)
            for pos in range(qt * qp, min(qt * qp + qp, Sq)):
                keys = live_keys(q_offset + pos, T, window)
                n += not any(a * TILE <= j < b * TILE for j in keys)
    return n


# (B, H, Hk, Sq, T, D, window, qp, n_split, rows with no live key in a
# split)
TWIN_CASES = [
    (1, 4, 2, 64, 256, 32, None, 32, 3, False),
    (2, 8, 2, 100, 320, 64, None, 16, 2, False),   # ragged Sq
    (1, 4, 4, 128, 128, 32, 40, 64, 2, True),      # window
    (1, 8, 1, 32, 512, 32, 70, 8, 8, True),        # short window, 8 splits
    (1, 2, 1, 96, 96, 64, None, 32, 4, True),      # walks shorter than 4
]


@pytest.mark.parametrize("B,H,Hk,Sq,T,D,window,qp,n_split,dead",
                         TWIN_CASES)
def test_split_merge_twin_matches_ref_and_pallas(B, H, Hk, Sq, T, D, window,
                                                 qp, n_split, dead):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, H, Sq, D), np.float32)
    k = rng.standard_normal((B, Hk, T, D), np.float32)
    v = rng.standard_normal((B, Hk, T, D), np.float32)
    off = T - Sq
    got = flash_prefill_split_ref(*map(torch.from_numpy, (q, k, v)),
                                  q_offset=off, window=window, qp=qp,
                                  n_split=n_split).numpy()
    ref = flash_prefill_ref(*map(torch.from_numpy, (q, k, v)), q_offset=off,
                            window=window).numpy()
    # Pallas tiles must divide the lengths: pad Sq at the front of the
    # queries (and drop those rows), keeping the same absolute positions
    pad = (-Sq) % 32
    qj = np.concatenate([np.zeros((B, H, pad, D), np.float32), q], 2)
    want = np.asarray(flash_prefill_dyn(
        jnp.asarray(qj), jnp.asarray(k), jnp.asarray(v), off - pad,
        window=window, bq=32, bk=32, interpret=True), np.float32)[:, :, pad:]
    np.testing.assert_allclose(got, ref, **F32_TOL)
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert (empty_split_rows(Sq, T, off, window, qp, n_split) > 0) == dead
