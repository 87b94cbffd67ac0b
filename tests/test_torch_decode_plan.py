"""What surrounds the paged decode kernel, on the CPU: the split plan that
ops.py hands the kernel (runs of consecutive page-table entries, chosen from
static shapes), and the split-and-merge arithmetic as its plain-torch twin
in ref.py, held against JAX's ``paged_attention`` (Pallas, interpret mode)
and against ``paged_attention_ref`` on the same numpy inputs, at the
tolerances of tests/test_kernels.py: float32 2e-5 (another summation order
of an f32 softmax), bfloat16 2e-2 (one bf16 rounding of the output). The
kernel itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    BLOCKS_PER_SM, MAX_PPS, MIN_SPLIT_TOKENS, SM_COUNT, plan, split_pages)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref, paged_attention_split_ref)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("B,MP,page", list(itertools.product(
    (1, 8), (1, 8, 64), (16, 128))))
def test_plan_covers_every_page_once(B, MP, page):
    """The splits of a row are contiguous, disjoint, non-empty and cover
    entries [0, MP); the grid is B * Hk * n_split blocks."""
    H, Hk, D = 16, 8, 128
    pl = plan(B, H, Hk, D, page, MP)
    seen = []
    for s in range(pl.n_split):
        a, b = split_pages(pl.pages_per_split, MP, s)
        assert a < b
        seen.extend(range(a, b))
    assert seen == list(range(MP))
    assert pl.blocks == B * Hk * pl.n_split
    assert pl.scratch == (B * Hk * pl.n_split * (H // Hk) * (D + 2)
                          if pl.n_split > 1 else 0)
    # a split keeps MIN_SPLIT_TOKENS positions unless the row is shorter,
    # and the split count stops growing once the grid fills BLOCKS_PER_SM
    # blocks an SM
    assert pl.pages_per_split * page >= min(MIN_SPLIT_TOKENS, MP * page)
    assert pl.pages_per_split <= MAX_PPS
    if pl.n_split > 1:
        assert B * Hk * (pl.n_split - 1) < BLOCKS_PER_SM * SM_COUNT


def test_plan_at_the_engine_shapes():
    """qwen3-1.7b decode: 8 slots of 1024 as 8 pages of 128 -> 8 one-page
    splits (512 blocks); one slot of 4096 -> 32 one-page splits; pages of
    16 keep 64 positions a split."""
    assert plan(8, 16, 8, 128, 128, 8)[:3] == (1, 8, 512)
    assert plan(1, 16, 8, 128, 128, 32)[:3] == (1, 32, 256)
    assert plan(1, 16, 8, 128, 16, 64)[:3] == (4, 16, 128)


def paged_case(B, H, Hk, D, page, MP, dtype, seed):
    """Lengths 1, page, page + 1 and MP * page (cycled over the rows) over
    a shuffled page table: row b's pages are a permutation of the pool."""
    rng = np.random.default_rng(seed)
    P = B * MP
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((P, page, Hk, D), np.float32)
    vp = rng.standard_normal((P, page, Hk, D), np.float32)
    pt = rng.permutation(P).reshape(B, MP).astype(np.int32)
    lens = [1, page, page + 1, MP * page]
    ln = np.array([lens[i % 4] for i in range(B)], np.int32)
    jd, td = DTYPES[dtype]
    jx = [jnp.asarray(a).astype(jd) for a in (q, kp, vp)]
    tx = [torch.from_numpy(a).to(td) for a in (q, kp, vp)]
    return (jx + [jnp.asarray(pt), jnp.asarray(ln)],
            tx + [torch.from_numpy(pt), torch.from_numpy(ln)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hk,D,page,MP,pps", [
    (4, 8, 2, 64, 16, 8, None),     # the plan's own split
    (4, 8, 2, 64, 16, 8, 1),        # a split a page
    (4, 8, 2, 64, 16, 8, 3),        # a short last split
    (4, 8, 2, 64, 16, 8, 8),        # one split: no merge
    (8, 16, 8, 128, 128, 2, None),  # qwen3-1.7b heads, two pages a row
    (2, 8, 1, 32, 16, 5, 2),        # MQA
])
def test_split_twin_matches_pallas(B, H, Hk, D, page, MP, pps, dtype):
    jx, tx = paged_case(B, H, Hk, D, page, MP, dtype, seed=B + MP)
    pl = plan(B, H, Hk, D, page, MP)
    if pps is not None:
        pl = pl._replace(pages_per_split=pps, n_split=-(-MP // pps))
    want = np.asarray(paged_attention(*jx, interpret=True), np.float32)
    got = paged_attention_split_ref(*tx, pages_per_split=pl.pages_per_split,
                                    n_split=pl.n_split)
    ref = paged_attention_ref(*tx)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               **TOL[dtype])


def test_split_twin_gives_zero_without_live_position():
    """A row of length 0 has no live split: the merge gives 0, not NaN."""
    _, tx = paged_case(2, 4, 2, 32, 16, 4, "float32", seed=5)
    tx[4] = torch.tensor([0, 20], dtype=torch.int32)
    got = paged_attention_split_ref(*tx, pages_per_split=1, n_split=4)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(got[1].numpy(),
                               paged_attention_ref(*tx)[1].numpy(),
                               **TOL["float32"])
