"""What surrounds the RG-LRU cluster kernel, on the CPU: the launch plan that
ops.py hands the kernel (a thread block cluster of S segments per 32-channel
tile, walked in rounds, chosen from static shapes), and the kernel's
arithmetic as its plain-torch twin in ref.py (runs walked from zero, their
aggregates composed in fixed order from h0, the closed-form output), held
against JAX's ``rglru_scan`` (Pallas, interpret mode) at the lengths its
sequence tile divides and against the JAX oracle ``rglru_scan_ref`` at the
others, on the same numpy inputs, at tests/test_kernels.py's 1e-5 (another
association of the same float32 products and sums). The kernel itself is
held against the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rglru_scan import rglru_scan_op as jax_rglru  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan_ref as jax_rglru_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import (  # noqa: E402
    BLOCKS_PER_SM, MAX_CLUSTER, MIN_SEG, SEG_MAX, SM_COUNT, TILE, WARPS,
    layout, plan, segment)
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_ref, rglru_scan_segments_ref)

RGLRU_TOL = dict(rtol=1e-5, atol=1e-5)
SMEM_LIMIT = 227 * 1024          # shared memory a block may use (H100)
W = 64                           # two 32-channel tiles


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **RGLRU_TOL)


@functools.lru_cache(maxsize=None)
def inputs(B, S, seed):
    rng = np.random.default_rng(seed)
    la = -np.abs(rng.standard_normal((B, S, W), np.float32)) * 0.3
    b = rng.standard_normal((B, S, W), np.float32)
    h0 = rng.standard_normal((B, W), np.float32)
    return la, b, h0


def twin(la, b, h0, K=None):
    """The twin at the plan's layout, or at a cluster of at most K."""
    B, S, _ = la.shape
    pl = plan(B, S, W)
    c, seg, run, rounds = (layout(S, K) if K is not None else
                           (pl.cluster, pl.seg, pl.run, pl.rounds))
    t = [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
         for a in (la, b, h0)]
    return rglru_scan_segments_ref(*t, cluster=c, seg=seg, run=run,
                                   rounds=rounds)


@functools.lru_cache(maxsize=None)
def pallas(B, S, with_h0, seed):
    la, b, h0 = inputs(B, S, seed)
    y, h = jax_rglru(la, b, h0 if with_h0 else None, interpret=True)
    return np.asarray(y), np.asarray(h)


# ----------------------------------------------------------------- plan


def test_plan_at_the_engine_shape():
    """recurrentgemma-9b, one 256-token chunk: 128 tiles x clusters of 4
    segments of 64 steps, one round, 512 blocks (about four an SM)."""
    pl = plan(1, 256, 4096, 132)
    assert pl.route == "cluster"
    assert pl.blocks >= 132 and pl.cluster <= MAX_CLUSTER
    assert pl[1:] == (4, 64, 16, 1, 512, 2 * 64 * TILE * 4)


@pytest.mark.parametrize("B,S,Wd", list(itertools.product(
    (1, 8), (1, 2, 17, 31, 33, 64, 160, 256, 1000, 1024), (32, 4096))))
def test_plan_covers_every_step_once(B, S, Wd):
    """Round r's block k takes steps [(r K + k) seg, + seg): contiguous,
    disjoint, covering [0, S); no block of the first round is empty; a
    segment is at most SEG_MAX steps in at most WARPS runs; the cluster
    stays a portable size and grows only while the grid is under
    BLOCKS_PER_SM blocks an SM; the shared memory fits a block."""
    pl = plan(B, S, Wd)
    assert pl.route == "cluster"
    seen = []
    for r in range(pl.rounds):
        for k in range(pl.cluster):
            a, b = segment(pl, S, r, k)
            assert b - a <= pl.seg
            if r == 0:
                assert a < b
            seen.extend(range(a, b))
    assert seen == list(range(S))
    assert 1 <= pl.cluster <= MAX_CLUSTER and pl.seg <= SEG_MAX
    assert -(-pl.seg // pl.run) <= WARPS
    assert pl.blocks == B * Wd // TILE * pl.cluster
    if pl.cluster > 1:
        assert B * Wd // TILE * (pl.cluster - 1) < BLOCKS_PER_SM * SM_COUNT
        assert pl.cluster <= -(-S // MIN_SEG)
    assert pl.smem <= SMEM_LIMIT


def test_plan_takes_one_block_a_tile_when_the_tiles_fill_the_card():
    """Batch 8 at width 4096 is 1024 tiles: no cluster, 4 rounds of 64
    steps through two stages."""
    assert plan(8, 256, 4096, 132)[1:5] == (1, 64, 16, 4)
    assert plan(8, 256, 4096, 132).smem == 2 * 2 * 64 * TILE * 4


@pytest.mark.parametrize("Wd", [6, 15, 101, 100, 16, 4095])
def test_plan_sends_other_widths_to_the_channel_route(Wd):
    """W % 4 != 0 (no 16-byte rows), and any W that is not a whole number
    of 32-channel tiles, go to the thread-a-channel route."""
    pl = plan(2, 256, Wd)
    assert pl.route == "channel" and pl.smem == 0
    assert pl.blocks == 2 * -(-Wd // 64)


def test_plan_refuses_an_empty_call():
    with pytest.raises(ValueError):
        plan(1, 0, 4096)


# ----------------------------------------------------------------- twin


@pytest.mark.parametrize("K", [None, 1, 2, 3, 8])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 31, 64])
def test_segments_twin_matches_pallas(S, with_h0, K):
    la, b, h0 = inputs(2, S, S)
    y, h = twin(la, b, h0 if with_h0 else None, K)
    jy, jh = pallas(2, S, with_h0, S)
    close(y, jy)
    close(h, jh)


@pytest.mark.parametrize("K", [None, 1, 4, 8])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [160, 1000])
def test_segments_twin_matches_jax_oracle(S, with_h0, K):
    """Lengths the Pallas kernel's sequence tile refuses; 1000 steps at a
    cluster of 8 take two rounds."""
    la, b, h0 = inputs(1, S, S)
    h0 = h0 if with_h0 else None
    y, h = twin(la, b, h0, K)
    ry, rh = jax_rglru_ref(la, b, h0)
    close(y, ry)
    close(h, rh)
    assert torch.equal(h, y[:, -1])


def test_segments_twin_chunk_resume():
    """A 256-step scan as chunks of 96 and 160 steps (the engine's 32-step
    buckets), the second seeded from the first's h_final."""
    la, b, h0 = inputs(1, 256, 9)
    y1, h1 = twin(la[:, :96], b[:, :96], h0)
    y2, h2 = twin(la[:, 96:], b[:, 96:], h1.numpy())
    jy, jh = pallas(1, 256, True, 9)
    close(torch.cat([y1, y2], 1), jy)
    close(h2, jh)


@pytest.mark.parametrize("K", [None, 2, 8])
def test_segments_twin_when_the_decay_underflows(K):
    """Decays whose products leave float32's range (exp(-60)^2, exp(-200))
    and runs of them: the products go to zero, never to NaN, and the state
    restarts from gated as the plain scan's does."""
    la, b, h0 = (a.copy() for a in inputs(1, 300, 11))
    la[:, ::3] = -60.0
    la[:, 100:140] = -200.0
    y, h = twin(la, b, h0, K)
    assert torch.isfinite(y).all()
    ry, rh = jax_rglru_ref(la, b, h0)
    close(y, ry)
    close(h, rh)
    t = [torch.from_numpy(a) for a in (la, b, h0)]
    close(y, rglru_scan_ref(*t)[0])
