"""Scan-kernel parity of the PyTorch port: the plain-torch versions that the
``ssd_scan_op`` and ``rglru_scan_op`` wrappers run on CPU tensors are held
against the JAX package's Pallas kernels (in interpret mode) and its
``ref.py`` oracles. The Hopper kernels themselves are held against the
plain versions on the card by tests/test_torch_kernels_cuda.py.

Inputs come from numpy seeds and are handed to both frameworks. Tolerances
are those of tests/test_kernels.py: ssd_scan at 2e-4 (the chunked kernel
against the sequential recurrence), rglru_scan at 1e-5 (a sequential walk
against an associative scan).

The JAX ``rglru_scan_op`` tiles the sequence by min(128, S) and asserts
that the tile divides S, so its Pallas path refuses a 160-token chunk (a
32-token bucket the engine makes); the port takes any S, and at such a
length it is held against the JAX oracle alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rglru_scan import rglru_scan_op as jax_rglru  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan_ref as jax_rglru_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_op as jax_ssd  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels import rglru_scan_op, ssd_scan_op  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_phases_ref  # noqa: E402

SSD_TOL = dict(rtol=2e-4, atol=2e-4)
RGLRU_TOL = dict(rtol=1e-5, atol=1e-5)
SSD_SHAPES = [                   # B, S, H, P, N, Q (tests/test_kernels.py)
    (2, 64, 3, 32, 16, 16),
    (1, 128, 2, 64, 128, 32),    # mamba2-370m-like head
    (2, 32, 1, 16, 8, 32),       # single chunk
]
RGLRU_SHAPES = [                 # B, S, W and the TPU tiles bs, bw
    (2, 64, 256, 16, 128),
    (1, 128, 512, 128, 512),
    (3, 32, 128, 8, 128),
]


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def ssd_inputs(B, S, H, P, N, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), np.float32)
    la = -np.abs(rng.standard_normal((B, S, H), np.float32)) * 0.5
    Bm = rng.standard_normal((B, S, H, N), np.float32) * 0.3
    Cm = rng.standard_normal((B, S, H, N), np.float32) * 0.3
    h0 = rng.standard_normal((B, H, P, N), np.float32)
    return x, la, Bm, Cm, h0


def rglru_inputs(B, S, W, seed=4):
    rng = np.random.default_rng(seed)
    la = -np.abs(rng.standard_normal((B, S, W), np.float32)) * 0.3
    b = rng.standard_normal((B, S, W), np.float32)
    h0 = rng.standard_normal((B, W), np.float32)
    return la, b, h0


def t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,Q", SSD_SHAPES)
def test_ssd_plain_matches_pallas(B, S, H, P, N, Q, with_h0):
    x, la, Bm, Cm, h0 = ssd_inputs(B, S, H, P, N)
    h0 = h0 if with_h0 else None
    jy, jh = jax_ssd(x, la, Bm, Cm, chunk=Q, h0=h0, interpret=True)
    ry, rh = jax_ssd_ref(x, la, Bm, Cm, h0=h0)
    for fn in (lambda *a: ssd_scan_op(*a[:4], Q, h0=a[4]), ssd_scan_ref):
        y, h = fn(*t(x, la, Bm, Cm, h0))
        assert y.dtype == h.dtype == torch.float32
        for want_y, want_h in ((jy, jh), (ry, rh)):
            close(y, want_y, SSD_TOL)
            close(h, want_h, SSD_TOL)


def test_ssd_chunk_resume_matches_full():
    """Two halves chained through h0 equal one scan, as the engine's
    chunked prefill resumes a slot's state (mamba2-370m smoke shapes)."""
    B, S, H, P, N, Q = 2, 64, 2, 32, 16, 16
    x, la, Bm, Cm, _ = ssd_inputs(B, S, H, P, N, seed=6)
    jy, jh = jax_ssd(x, la, Bm, Cm, chunk=Q, interpret=True)
    c = S // 2
    y1, h1 = ssd_scan_op(*t(x[:, :c], la[:, :c], Bm[:, :c], Cm[:, :c]), Q)
    y2, h2 = ssd_scan_op(*t(x[:, c:], la[:, c:], Bm[:, c:], Cm[:, c:]), Q,
                         h0=h1)
    close(torch.cat([y1, y2], 1), jy, SSD_TOL)
    close(h2, jh, SSD_TOL)


def group_inputs(B, S, H, P, N, G, seed):
    """Group-level Bm/Cm (B,S,G,N) beside the other scan inputs."""
    x, la, _, _, h0 = ssd_inputs(B, S, H, P, N, seed=seed)
    rng = np.random.default_rng(seed + 100)
    Bg = rng.standard_normal((B, S, G, N), np.float32) * 0.3
    Cg = rng.standard_normal((B, S, G, N), np.float32) * 0.3
    return x, la, Bg, Cg, h0


@pytest.mark.parametrize("G", [1, 2, 4])
def test_ssd_group_level_matches_pallas_on_repeated(G):
    """ssd_scan_op with group-level Bm/Cm (G in {1, 2, H}, H = 4) equals
    the JAX ssd_scan_op fed the jnp.repeat'ed per-head inputs."""
    import jax.numpy as jnp
    B, S, H, P, N, Q = 2, 64, 4, 16, 16, 16
    x, la, Bg, Cg, h0 = group_inputs(B, S, H, P, N, G, seed=9)
    Bh, Ch = (np.asarray(jnp.repeat(jnp.asarray(a), H // G, axis=2))
              for a in (Bg, Cg))
    jy, jh = jax_ssd(x, la, Bh, Ch, chunk=Q, h0=h0, interpret=True)
    y, h = ssd_scan_op(*t(x, la, Bg, Cg), Q, h0=t(h0)[0])
    close(y, jy, SSD_TOL)
    close(h, jh, SSD_TOL)
    y2, h2 = ssd_scan_phases_ref(*t(x, la, Bg, Cg), Q, t(h0)[0])
    close(y2, jy, SSD_TOL)
    close(h2, jh, SSD_TOL)


@pytest.mark.parametrize("n_chunks", [1, 2, 8])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_phases_twin_matches_sequential_and_pallas(n_chunks, with_h0):
    """The kernel's three-phase arithmetic (C.B^T once per group, the
    chunk-parallel intra-chunk y and state terms, the sequential state
    pass) equals the sequential recurrence and the Pallas kernel."""
    B, H, P, N, Q = 2, 3, 8, 16, 16
    S = n_chunks * Q
    x, la, Bm, Cm, h0 = ssd_inputs(B, S, H, P, N, seed=10 + n_chunks)
    h0 = h0 if with_h0 else None
    jy, jh = jax_ssd(x, la, Bm, Cm, chunk=Q, h0=h0, interpret=True)
    y, h = ssd_scan_phases_ref(*t(x, la, Bm, Cm), Q, t(h0)[0])
    ry, rh = ssd_scan_ref(*t(x, la, Bm, Cm, h0))
    for want_y, want_h in ((jy, jh), (ry, rh)):
        close(y, want_y, SSD_TOL)
        close(h, want_h, SSD_TOL)


def test_ssd_phases_twin_takes_no_exp_of_a_positive_exponent():
    """Strong decay (la down to -60 a step) over a long chunk: the decay is
    formed only where j <= i, so nothing overflows into inf * 0 = NaN."""
    B, S, H, P, N, Q = 1, 64, 2, 8, 8, 64
    x, la, Bm, Cm, _ = ssd_inputs(B, S, H, P, N, seed=13)
    la = la * 120.0
    y, h = ssd_scan_phases_ref(*t(x, la, Bm, Cm), Q)
    ry, rh = ssd_scan_ref(*t(x, la, Bm, Cm))
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    close(y, ry, SSD_TOL)
    close(h, rh, SSD_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W,bs,bw", RGLRU_SHAPES)
def test_rglru_plain_matches_pallas(B, S, W, bs, bw, with_h0):
    la, b, h0 = rglru_inputs(B, S, W)
    h0 = h0 if with_h0 else None
    jy, jh = jax_rglru(la, b, h0, bs=bs, bw=bw, interpret=True)
    ry, rh = jax_rglru_ref(la, b, h0)
    for fn in (rglru_scan_op, rglru_scan_ref):
        y, h = fn(*t(la, b, h0))
        for want_y, want_h in ((jy, jh), (ry, rh)):
            close(y, want_y, RGLRU_TOL)
            close(h, want_h, RGLRU_TOL)


def test_rglru_any_length_matches_jax_oracle():
    """A 160-token chunk: the JAX Pallas path refuses it (its 128-token
    tile does not divide 160); the port matches the JAX oracle."""
    la, b, h0 = rglru_inputs(2, 160, 256, seed=8)
    with pytest.raises(AssertionError):
        jax_rglru(la, b, h0, interpret=True)
    ry, rh = jax_rglru_ref(la, b, h0)
    y, h = rglru_scan_op(*t(la, b, h0))
    close(y, ry, RGLRU_TOL)
    close(h, rh, RGLRU_TOL)


def test_rglru_chunk_resume_matches_full():
    la, b, _ = rglru_inputs(2, 64, 256, seed=7)
    jy, jh = jax_rglru(la, b, None, bs=16, bw=128, interpret=True)
    y1, h1 = rglru_scan_op(*t(la[:, :32], b[:, :32]))
    y2, h2 = rglru_scan_op(*t(la[:, 32:], b[:, 32:]), h1)
    close(torch.cat([y1, y2], 1), jy, RGLRU_TOL)
    close(h2, jh, RGLRU_TOL)


def test_scan_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain version and launch
    nothing, so their counters stay put."""
    before = (ssd_scan_op.launches, rglru_scan_op.launches)
    x, la, Bm, Cm, h0 = t(*ssd_inputs(1, 32, 1, 16, 8))
    ssd_scan_op(x, la, Bm, Cm, 16, h0=h0)
    rglru_scan_op(*t(*rglru_inputs(1, 8, 16)))
    assert (ssd_scan_op.launches, rglru_scan_op.launches) == before


def test_scan_wrappers_reject_bad_inputs():
    x, la, Bm, Cm, h0 = t(*ssd_inputs(1, 32, 2, 16, 8))
    with pytest.raises(ValueError):              # 32 tokens, chunk 24
        ssd_scan_op(x, la, Bm, Cm, 24)
    with pytest.raises(ValueError):              # Bm/Cm shapes differ
        ssd_scan_op(x, la, Bm, Cm[..., :4], 16)
    with pytest.raises(ValueError):              # h0 of another head count
        ssd_scan_op(x, la, Bm, Cm, 16, h0=h0[:, :1])
    x3, la3, Bm3, Cm3, _ = t(*ssd_inputs(1, 32, 3, 16, 8))
    with pytest.raises(ValueError):              # 2 groups over 3 heads
        ssd_scan_op(x3, la3, Bm3[:, :, :2], Cm3[:, :, :2], 16)
    la2, b2, h02 = t(*rglru_inputs(1, 8, 16))
    with pytest.raises(ValueError):
        rglru_scan_op(la2, b2[:, :4])
    with pytest.raises(ValueError):
        rglru_scan_op(la2, b2, h02[:, :8])
