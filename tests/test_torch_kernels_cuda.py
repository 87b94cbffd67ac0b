"""The port's Hopper kernels against their plain-torch versions, on the
card. Every test here needs a CUDA device and skips without one (the
kernels have no interpret mode); the file imports no JAX, so it runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Shapes follow tests/test_kernels.py, plus the engine's main-path shapes at
qwen3-1.7b, mamba2-370m and recurrentgemma-9b width, and the speculative
verify's few query rows at unaligned offsets. An engine test holds the
speculative step's streams to the fused sequential ones on the kernels, in
float32. Tolerances: attention
float32 at 2e-5 (other summation orders), bfloat16 at 2e-2 (one bf16
rounding of the output); the scans those of tests/test_kernels.py, ssd_scan
at 2e-4 (the chunked form against the sequential recurrence) and
rglru_scan at 1e-5 (a segmented walk with a composed carry against a
doubling scan).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (flash_chunk_op, flash_seq_op,  # noqa: E402
                                 paged_attention_op, rglru_scan_op,
                                 ssd_scan_op)

pytestmark = pytest.mark.cuda
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_SHAPES = [
    (1, 4, 4, 128, 128, 64),
    (2, 8, 2, 128, 256, 64),
    (1, 8, 1, 256, 256, 128),
    (2, 4, 2, 64, 128, 160),
    (1, 16, 8, 256, 1024, 128),   # engine chunk at offset 768, qwen3-1.7b
    (1, 16, 8, 100, 100, 128),    # ragged tiles (Sq, T not multiples of 32)
    (2, 4, 2, 32, 32, 32),        # smoke head_dim
]
PAGED_SHAPES = [
    (2, 8, 2, 64, 16, 32, 4),
    (3, 8, 1, 128, 32, 16, 3),
    (1, 16, 16, 64, 16, 64, 8),
    (8, 16, 8, 128, 128, 64, 8),  # engine decode, qwen3-1.7b, C=1024
    (8, 12, 2, 128, 128, 64, 8),  # qwen2-vl-2b decode (G = 6), C=1024
]
SSD_SHAPES = [                    # B, S, H, P, N, Q
    (2, 64, 3, 32, 16, 16),
    (1, 128, 2, 64, 128, 32),
    (2, 32, 1, 16, 8, 32),
    (1, 256, 32, 64, 128, 128),   # a 256-token chunk, mamba2-370m
    (8, 256, 32, 64, 128, 128),
    (1, 96, 2, 40, 16, 16),       # P not a multiple of the 16-column tile
]
RGLRU_SHAPES = [                  # B, S, W
    (2, 64, 256),
    (1, 128, 512),
    (3, 32, 128),
    (1, 256, 4096),               # a 256-token chunk, recurrentgemma-9b
    (1, 160, 4096),               # a 160-token bucket (S not a tile multiple)
    (8, 256, 4096),               # tiles fill the card: rounds, no cluster
    (2, 7, 100),                  # ragged S and W
    (1, 1, 4096),                 # one step
    (1, 33, 4096),                # a cluster of 3 segments of 11 steps
    (1, 1024, 4096),              # a whole 1024-slot prompt: 4 rounds
    (2, 256, 100),                # W not a whole tile: the channel route
]
SSD_TOL = dict(rtol=2e-4, atol=2e-4)
RGLRU_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels have no "
                    "interpret mode)")
    return torch.device("cuda")


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def rand(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)) \
        .to(DTYPES[dtype])


def f32(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hk,Sq,T,D", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, B, H, Hk, Sq, T, D, dtype,
                                    window):
    rng = np.random.default_rng(0)
    q = rand(rng, (B, Sq, H, D), dtype)
    k = rand(rng, (B, T, Hk, D), dtype)
    v = rand(rng, (B, T, Hk, D), dtype)
    want = f32(flash_chunk_op(q, k, v, T - Sq, window=window))
    n = flash_chunk_op.launches
    got = flash_chunk_op(q.to(cuda), k.to(cuda), v.to(cuda), T - Sq,
                         window=window)
    torch.cuda.synchronize()
    assert flash_chunk_op.launches == n + 1
    np.testing.assert_allclose(f32(got), want, **tol(dtype))
    if T == Sq:
        seq = flash_seq_op(q.to(cuda), k.to(cuda), v.to(cuda), window=window)
        np.testing.assert_allclose(f32(seq), want, **tol(dtype))


# the wgmma route's edges, bf16: (B, H, Hk, Sq, T, D, q_offset, window)
WGMMA_EDGES = [
    (1, 8, 8, 96, 512, 128, 300, None),    # G = 1
    (2, 8, 4, 64, 256, 64, 192, None),     # G = 2, head_dim 64
    (1, 16, 4, 100, 700, 128, 600, None),  # G = 4, ragged Sq and T
    (1, 16, 2, 40, 1024, 64, 984, None),   # G = 8
    (1, 12, 2, 80, 600, 128, 500, None),   # G = 6: 60 of 64 rows live
    (1, 16, 8, 256, 1024, 128, 512, 200),  # window across tiles and splits
    (1, 16, 8, 256, 1024, 128, 700, 65),   # window one past a tile
    (1, 4, 2, 1024, 1024, 128, 0, None),   # walks shorter than the splits
    (1, 16, 8, 32, 1024, 128, 992, None),  # the smallest engine bucket
    (1, 16, 8, 256, 1024, 128, 0, None),   # engine chunks, qwen3-1.7b
    (1, 16, 8, 256, 1024, 128, 256, None),
    (1, 16, 8, 256, 1024, 128, 512, None),
]


@pytest.mark.parametrize("B,H,Hk,Sq,T,D,q_offset,window", WGMMA_EDGES)
def test_flash_wgmma_edges_match_plain(cuda, B, H, Hk, Sq, T, D, q_offset,
                                       window):
    """The wgmma route (TMA ring, split-KV and merge) at GQA groups 1-8,
    windows, short walks and the engine's chunk offsets; a second call at
    the same shape gives the same bits (the kernel keeps no state)."""
    rng = np.random.default_rng(7)
    q = rand(rng, (B, Sq, H, D), "bfloat16")
    k = rand(rng, (B, T, Hk, D), "bfloat16")
    v = rand(rng, (B, T, Hk, D), "bfloat16")
    want = f32(flash_chunk_op(q, k, v, q_offset, window=window))
    args = [t.to(cuda) for t in (q, k, v)]
    got = flash_chunk_op(*args, q_offset, window=window)
    again = flash_chunk_op(*args, q_offset, window=window)
    torch.cuda.synchronize()
    np.testing.assert_allclose(f32(got), want, **tol("bfloat16"))
    assert torch.equal(got, again)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_wgmma_structured_v(cuda, D):
    """Q = K = 0 makes P uniform over each row's live keys; V row j is the
    one-hot e_(j mod D), so O[i, d] counts the live keys j = d (mod D),
    over the count of live keys: a wrong V layout or transpose shows as
    mass in the wrong column."""
    Sq, T, H, Hk, off = 64, 300, 4, 2, 236
    q = torch.zeros(1, Sq, H, D, dtype=torch.bfloat16)
    k = torch.zeros(1, T, Hk, D, dtype=torch.bfloat16)
    v = torch.zeros(1, T, Hk, D, dtype=torch.bfloat16)
    v[0, torch.arange(T), :, torch.arange(T) % D] = 1
    want = f32(flash_chunk_op(q, k, v, off))
    got = flash_chunk_op(q.to(cuda), k.to(cuda), v.to(cuda), off)
    torch.cuda.synchronize()
    np.testing.assert_allclose(f32(got), want, **tol("bfloat16"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hk,D,page,P,MP", PAGED_SHAPES)
def test_paged_kernel_matches_plain(cuda, B, H, Hk, D, page, P, MP, dtype):
    rng = np.random.default_rng(1)
    q = rand(rng, (B, H, D), dtype)
    kp = rand(rng, (P, page, Hk, D), dtype)
    vp = rand(rng, (P, page, Hk, D), dtype)
    pt = torch.from_numpy(rng.integers(0, P, size=(B, MP)).astype(np.int32))
    ln = np.arange(1, B + 1) * (MP * page // (B + 1)) + 1
    ln[0] = 1                                     # a one-token context
    ln = torch.from_numpy(ln.astype(np.int32))
    want = f32(paged_attention_op(q, kp, vp, pt, ln))
    got = paged_attention_op(*(t.to(cuda) for t in (q, kp, vp, pt, ln)))
    torch.cuda.synchronize()
    np.testing.assert_allclose(f32(got), want, **tol(dtype))


# (B, H, Hk, D, page, MP, lengths): B = 1 over 4096 positions (32
# one-page splits), the engine shape (4 splits of 2 pages), lengths on
# page and split edges, float32's widest rows, MQA at head_dim 256
PAGED_EDGES = [
    (1, 16, 8, 128, 128, 32, [4096]),
    (1, 16, 8, 128, 128, 32, [1]),
    (8, 16, 8, 128, 128, 8, [1, 100, 257, 400, 512, 700, 731, 1024]),
    (8, 16, 8, 128, 128, 8, [128, 129, 255, 256, 257, 511, 512, 513]),
    (4, 32, 2, 128, 16, 64, [16, 17, 64, 1024]),
    (2, 8, 1, 256, 128, 8, [300, 1024]),
]


def paged_edge_inputs(rng, B, H, Hk, D, page, MP, lengths, dtype):
    """Pages drawn as a permutation of the pool: a shuffled page table."""
    P = B * MP
    q = rand(rng, (B, H, D), dtype)
    kp = rand(rng, (P, page, Hk, D), dtype)
    vp = rand(rng, (P, page, Hk, D), dtype)
    pt = torch.from_numpy(rng.permutation(P).reshape(B, MP).astype(np.int32))
    ln = torch.tensor(lengths, dtype=torch.int32)
    return q, kp, vp, pt, ln


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hk,D,page,MP,lengths", PAGED_EDGES)
def test_paged_split_edges_match_plain(cuda, B, H, Hk, D, page, MP, lengths,
                                       dtype):
    """The split-KV grid at many and few splits, lengths on page and split
    boundaries, a shuffled page table; a second call gives the same bits
    (the merge reads the splits in order)."""
    args = paged_edge_inputs(np.random.default_rng(11), B, H, Hk, D, page,
                             MP, lengths, dtype)
    want = f32(paged_attention_op(*args))
    dev = [t.to(cuda) for t in args]
    n = paged_attention_op.launches
    got = paged_attention_op(*dev)
    again = paged_attention_op(*dev)
    torch.cuda.synchronize()
    assert paged_attention_op.launches == n + 2
    np.testing.assert_allclose(f32(got), want, **tol(dtype))
    assert torch.equal(got, again)


def test_paged_zero_length_gives_zero(cuda):
    """A row with no live position: 0 on the one-split and merge routes."""
    for MP in (1, 8):
        args = paged_edge_inputs(np.random.default_rng(12), 2, 4, 2, 64, 128,
                                 MP, [0, 5], "bfloat16")
        got = paged_attention_op(*(t.to(cuda) for t in args))
        torch.cuda.synchronize()
        assert not got[0].any()
        np.testing.assert_allclose(f32(got[1]),
                                   f32(paged_attention_op(*args)[1]),
                                   **tol("bfloat16"))


def ssd_inputs(rng, B, S, H, P, N):
    x = rng.standard_normal((B, S, H, P), np.float32)
    la = -np.abs(rng.standard_normal((B, S, H), np.float32)) * 0.5
    Bm = rng.standard_normal((B, S, H, N), np.float32) * 0.3
    Cm = rng.standard_normal((B, S, H, N), np.float32) * 0.3
    h0 = rng.standard_normal((B, H, P, N), np.float32)
    return [torch.from_numpy(a) for a in (x, la, Bm, Cm, h0)]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,Q", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(cuda, B, S, H, P, N, Q, with_h0):
    x, la, Bm, Cm, h0 = ssd_inputs(np.random.default_rng(3), B, S, H, P, N)
    h0 = h0 if with_h0 else None
    want = ssd_scan_op(x, la, Bm, Cm, Q, h0=h0)
    n = ssd_scan_op.launches
    got = ssd_scan_op(*(t.to(cuda) for t in (x, la, Bm, Cm)), Q,
                      h0=None if h0 is None else h0.to(cuda))
    torch.cuda.synchronize()
    assert ssd_scan_op.launches == n + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(f32(g), f32(w), **SSD_TOL)


def test_ssd_scan_kernel_chunk_resume(cuda):
    """Two halves chained through h0 give the whole scan."""
    B, S, H, P, N, Q = 1, 256, 32, 64, 128, 128
    ts = [t.to(cuda) for t in ssd_inputs(np.random.default_rng(6),
                                         B, S, H, P, N)]
    x, la, Bm, Cm, h0 = ts
    y, h = ssd_scan_op(x, la, Bm, Cm, Q, h0=h0)
    y1, h1 = ssd_scan_op(x[:, :Q], la[:, :Q], Bm[:, :Q], Cm[:, :Q], Q, h0=h0)
    y2, h2 = ssd_scan_op(x[:, Q:], la[:, Q:], Bm[:, Q:], Cm[:, Q:], Q, h0=h1)
    torch.cuda.synchronize()
    np.testing.assert_allclose(f32(torch.cat([y1, y2], 1)), f32(y), **SSD_TOL)
    np.testing.assert_allclose(f32(h2), f32(h), **SSD_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,G", [(1, 256, 1), (1, 256, 2), (1, 256, 32),
                                   (1, 1024, 1), (2, 1024, 8)])
def test_ssd_scan_kernel_group_level(cuda, B, S, G, with_h0):
    """Group-level Bm/Cm (B,S,G,N) at mamba2-370m width (H=32, P=64,
    N=128, chunk 128; S = 1024 is 8 chunks) equal the per-head form the
    plain version gets by repeating each group over its heads."""
    H, P, N, Q = 32, 64, 128, 128
    rng = np.random.default_rng(21)
    x, la, _, _, h0 = ssd_inputs(rng, B, S, H, P, N)
    Bg = torch.from_numpy(rng.standard_normal((B, S, G, N), np.float32) * .3)
    Cg = torch.from_numpy(rng.standard_normal((B, S, G, N), np.float32) * .3)
    h0 = h0 if with_h0 else None
    want = ssd_scan_op(x, la, Bg.repeat_interleave(H // G, 2),
                       Cg.repeat_interleave(H // G, 2), Q, h0=h0)
    got = ssd_scan_op(*(t.to(cuda) for t in (x, la, Bg, Cg)), Q,
                      h0=None if h0 is None else h0.to(cuda))
    again = ssd_scan_op(*(t.to(cuda) for t in (x, la, Bg, Cg)), Q,
                        h0=None if h0 is None else h0.to(cuda))
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        np.testing.assert_allclose(f32(g), f32(w), **SSD_TOL)
        assert torch.equal(g, a)


def test_ssd_scan_kernel_group_resume(cuda):
    """Group-level chunk resume: 8 chunks as two calls of 4 through h0."""
    B, S, H, P, N, Q, G = 1, 1024, 32, 64, 128, 128, 1
    rng = np.random.default_rng(22)
    x, la, _, _, h0 = [t.to(cuda) for t in ssd_inputs(rng, B, S, H, P, N)]
    Bg, Cg = (torch.from_numpy(rng.standard_normal((B, S, G, N), np.float32)
                               * .3).to(cuda) for _ in range(2))
    y, h = ssd_scan_op(x, la, Bg, Cg, Q, h0=h0)
    c = S // 2
    y1, h1 = ssd_scan_op(x[:, :c], la[:, :c], Bg[:, :c], Cg[:, :c], Q, h0=h0)
    y2, h2 = ssd_scan_op(x[:, c:], la[:, c:], Bg[:, c:], Cg[:, c:], Q, h0=h1)
    torch.cuda.synchronize()
    np.testing.assert_allclose(f32(torch.cat([y1, y2], 1)), f32(y), **SSD_TOL)
    np.testing.assert_allclose(f32(h2), f32(h), **SSD_TOL)
    want = ssd_scan_op(*(t.cpu() for t in (x, la, Bg, Cg)), Q, h0=h0.cpu())
    np.testing.assert_allclose(f32(h), f32(want[1]), **SSD_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", RGLRU_SHAPES)
def test_rglru_scan_kernel_matches_plain(cuda, B, S, W, with_h0):
    rng = np.random.default_rng(4)
    la = torch.from_numpy(-np.abs(rng.standard_normal((B, S, W),
                                                      np.float32)) * 0.3)
    g = torch.from_numpy(rng.standard_normal((B, S, W), np.float32))
    h0 = torch.from_numpy(rng.standard_normal((B, W), np.float32)) \
        if with_h0 else None
    want = rglru_scan_op(la, g, h0)
    n = rglru_scan_op.launches
    got = rglru_scan_op(la.to(cuda), g.to(cuda),
                        None if h0 is None else h0.to(cuda))
    torch.cuda.synchronize()
    assert rglru_scan_op.launches == n + 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(f32(a), f32(b), **RGLRU_TOL)


def rglru_case(cuda, B, S, W, seed):
    rng = np.random.default_rng(seed)
    la = -np.abs(rng.standard_normal((B, S, W), np.float32)) * 0.3
    return [torch.from_numpy(a).to(cuda) for a in (
        la, rng.standard_normal((B, S, W), np.float32),
        rng.standard_normal((B, W), np.float32))]


@pytest.mark.parametrize("B,S,W", [(1, 256, 4096), (1, 1024, 4096),
                                   (8, 256, 4096), (1, 33, 4096),
                                   (2, 256, 100)])
def test_rglru_scan_kernel_is_deterministic(cuda, B, S, W):
    """The cluster carry composes the segments in a fixed order: two calls
    on the same inputs give the same bits."""
    la, g, h0 = rglru_case(cuda, B, S, W, 23)
    a = rglru_scan_op(la, g, h0)
    b = rglru_scan_op(la, g, h0)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("cuts", [(256, 512, 768), (160, 480, 1000)])
def test_rglru_scan_kernel_chunk_resume(cuda, cuts):
    """A 1024-step scan as chunks (256-step chunks; ragged 32-step
    buckets), each seeded from the last one's h_final, matches the whole
    scan."""
    la, g, h0 = rglru_case(cuda, 1, 1024, 4096, 24)
    y, hT = rglru_scan_op(la, g, h0)
    parts, h = [], h0
    for a, b in zip((0,) + cuts, cuts + (1024,)):
        yc, h = rglru_scan_op(la[:, a:b], g[:, a:b], h)
        parts.append(yc)
    torch.cuda.synchronize()
    np.testing.assert_allclose(f32(torch.cat(parts, 1)), f32(y), **RGLRU_TOL)
    np.testing.assert_allclose(f32(h), f32(hT), **RGLRU_TOL)


def test_rglru_scan_kernel_takes_unaligned_inputs(cuda):
    """Contiguous inputs whose data is not 16-byte aligned (a view at an
    odd offset) reach the cluster route through an aligned copy."""
    la, g, h0 = rglru_case(cuda, 1, 64, 4096, 25)
    odd = [torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
           .copy_(t) for t in (la, g)]
    assert odd[0].data_ptr() % 16 and odd[0].is_contiguous()
    want = rglru_scan_op(la.cpu(), g.cpu(), h0.cpu())
    got = rglru_scan_op(*odd, h0)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        np.testing.assert_allclose(f32(a), f32(b), **RGLRU_TOL)


def test_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros(1, 32, 4, 48, device=cuda)    # head_dim 48: no variant
    with pytest.raises(ValueError):
        flash_seq_op(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(TypeError):                # float16: no variant
        flash_seq_op(q.half(), q[:, :, :2].half(), q[:, :, :2].half())
    z = torch.zeros(1, 256, 1, 16, device=cuda)   # chunk 256: no tile
    with pytest.raises(ValueError):
        ssd_scan_op(z, z[..., 0], z, z, 256)


# the speculative verify's shapes: k+1 = 2..9 query rows at offsets that are
# no multiple of the 64-position kv tile, against a 1024-slot cache at
# qwen3-1.7b's heads (the wgmma route's 32-position query tile holds them)
VERIFY_SHAPES = [(sq, off) for sq in (2, 5, 9) for off in (37, 517, 1015)] \
    + [(3, 0), (7, 63), (8, 64), (4, 1020)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,q_offset", VERIFY_SHAPES)
def test_flash_few_rows_at_unaligned_offsets(cuda, Sq, q_offset, dtype):
    """flash_chunk_op at the verify's few query rows matches its plain
    version. Launched through the C entry point with q carved from a
    buffer whose rows past Sq are NaN, and o carved from one whose rows
    past Sq hold a sentinel: the rows that exist come out right and
    finite, and no row past Sq is written."""
    import math

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_prefill import ops as fops
    H, Hk, D, C = 16, 8, 128, 1024
    rng = np.random.default_rng(Sq * 1000 + q_offset)
    q = rand(rng, (1, Sq, H, D), dtype)
    k = rand(rng, (1, C, Hk, D), dtype)
    v = rand(rng, (1, C, Hk, D), dtype)
    want = f32(flash_chunk_op(q, k, v, q_offset))
    np.testing.assert_allclose(
        f32(flash_chunk_op(q.to(cuda), k.to(cuda), v.to(cuda), q_offset)),
        want, **tol(dtype))
    qbuf = torch.full((1, Sq + 64, H, D), float("nan"),
                      dtype=DTYPES[dtype], device=cuda)
    qbuf[:, :Sq] = q.to(cuda)
    obuf = torch.full_like(qbuf, 7.0)
    qv, ov = qbuf[:, :Sq], obuf[:, :Sq]
    kd, vd = k.to(cuda), v.to(cuda)
    pl = fops.plan(1, H, Hk, Sq, C, D, q_offset, None, DTYPES[dtype])
    dev = kd.device                              # with its index
    part = _build.scratch("flash_prefill", dev, pl.scratch).data_ptr() \
        if pl.scratch else None
    err = _build.fn(*fops.LAUNCH)(
        qv.data_ptr(), kd.data_ptr(), vd.data_ptr(), ov.data_ptr(), part,
        1, H, Hk, Sq, C, D, q_offset, 0, 1.0 / math.sqrt(D),
        fops._DTYPE_CODE[DTYPES[dtype]], pl.qp, pl.n_split,
        _build.stream(dev))
    _build.check(err, "flash_prefill_launch")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ov).all())
    np.testing.assert_allclose(f32(ov), want, **tol(dtype))
    assert bool((obuf[:, Sq:] == 7.0).all())


def _f32_model(cuda):
    """qwen3-1.7b's attention layout (16/8 heads of 128) at 4 narrow
    layers, float32, seeded random weights on the card."""
    from repro_torch.configs import get_config
    from repro_torch.weights import init_params
    cfg = get_config("qwen3-1.7b").replace(
        n_layers=4, d_model=256, d_ff=512, vocab_size=2048,
        dtype="float32", attn_impl="hopper")
    return cfg, init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), cuda)


def _streams(cfg, params, cuda, **kw):
    """4 requests (2 greedy, 2 sampled) on one instance, decoded together
    through dispatch/finalize until each has 24 tokens."""
    from repro_torch.core import SamplingParams
    from repro_torch.engine import EngineInstance
    inst = EngineInstance(0, cfg, params, n_slots=4, capacity=256,
                          device=cuda, **kw)
    rng = np.random.default_rng(5)
    rids = list(range(4))
    for rid in rids:
        prompt = rng.integers(1, cfg.vocab_size, size=int(rng.integers(
            20, 120))).astype(np.int32)
        inst.set_sampling(rid, SamplingParams(0.8, 0.9, seed=3)
                          if rid % 2 else None)
        inst.run_prefill(rid, prompt)
        inst.local.start_local_decode(rid, len(prompt), 23)
    while any(len(inst.generated[r]) < 24 for r in rids):
        live = [r for r in rids if len(inst.generated[r]) < 24]
        inst.finalize_step(inst.dispatch_step(live, []))
    return [inst.generated[r][:24] for r in rids]


def test_speculative_streams_equal_sequential_f32(cuda):
    """Self-speculative decoding on the kernels (draft on paged decode,
    verify on flash at k+1 rows) emits the sequential stream id for id in
    float32, TF32 off."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, params = _f32_model(cuda)
        seq = _streams(cfg, params, cuda)
        reset_launch_counts()
        spec = _streams(cfg, params, cuda, speculate=4, draft_layers=2)
        counts = launch_counts()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert spec == seq
    assert counts["flash_chunk_op"] > 0 and counts["paged_attention_op"] > 0


def test_kernels_refuse_inputs_that_require_grad(cuda):
    """No kernel has a backward: each wrapper raises on CUDA inputs that
    require grad (a detached output would train with zero gradients), and
    launches as usual under torch.no_grad()."""
    bf = torch.bfloat16

    def rnd(*shape, grad=False):
        return torch.randn(shape, device=cuda).to(bf).requires_grad_(grad)

    q, k, v = rnd(1, 64, 12, 128, grad=True), rnd(1, 64, 2, 128), \
        rnd(1, 64, 2, 128)
    qd, kp, vp = rnd(2, 12, 128, grad=True), rnd(2, 64, 2, 128), \
        rnd(2, 64, 2, 128)
    pt = torch.arange(2, dtype=torch.int32, device=cuda)[:, None]
    ln = torch.tensor([10, 64], dtype=torch.int32, device=cuda)
    xs = torch.randn(1, 32, 2, 16, device=cuda, requires_grad=True)
    la = -torch.rand(1, 32, 2, device=cuda)
    bm, cm_ = torch.randn(1, 32, 1, 8, device=cuda), \
        torch.randn(1, 32, 1, 8, device=cuda)
    ga = torch.randn(1, 32, 64, device=cuda, requires_grad=True)
    calls = {"flash_seq_op": lambda: flash_seq_op(q, k, v),
             "flash_chunk_op": lambda: flash_chunk_op(q, k, v, 0),
             "paged_attention_op": lambda: paged_attention_op(
                 qd, kp, vp, pt, ln),
             "ssd_scan_op": lambda: ssd_scan_op(xs, la, bm, cm_, 16),
             "rglru_scan_op": lambda: rglru_scan_op(
                 -torch.rand(1, 32, 64, device=cuda), ga)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            out = call()
        torch.cuda.synchronize()
        out = out[0] if isinstance(out, tuple) else out
        assert torch.isfinite(out.float()).all(), name
