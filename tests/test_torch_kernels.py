"""Kernel parity of the PyTorch port: the plain-torch versions the wrappers
run on CPU tensors are held against the JAX package's Pallas kernels (in
interpret mode) and against their own ``ref.py``. The Hopper kernels
themselves are held against the plain versions on the card by
tests/test_torch_kernels_cuda.py.

Inputs come from numpy seeds and are handed to both frameworks, bf16 by the
same round-to-nearest cast. Tolerances are those of tests/test_kernels.py:
float32 at 2e-5 (different summation orders of an f32 softmax), bfloat16
at 2e-2 (one bf16 rounding of the output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_prefill import (flash_prefill,  # noqa: E402
                                         flash_prefill_dyn)
from repro.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels import (flash_chunk_op, flash_seq_op,  # noqa: E402
                                 paged_attention_op)
from repro_torch.kernels.flash_prefill import flash_prefill_ref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention_ref)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FLASH_SHAPES = [
    (1, 4, 4, 128, 128, 64),     # MHA square
    (2, 8, 2, 128, 256, 64),     # GQA, chunked (q_offset)
    (1, 8, 1, 256, 256, 128),    # MQA
    (2, 4, 2, 64, 128, 160),     # stablelm head_dim (non-128 lane multiple)
]
PAGED_SHAPES = [
    (2, 8, 2, 64, 16, 32, 4),
    (3, 8, 1, 128, 32, 16, 3),   # MQA
    (1, 16, 16, 64, 16, 64, 8),  # MHA
]


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def both(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def flash_inputs(B, H, Hk, Sq, T, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D), np.float32)
    k = rng.standard_normal((B, Hk, T, D), np.float32)
    v = rng.standard_normal((B, Hk, T, D), np.float32)
    return both(q, dtype), both(k, dtype), both(v, dtype)


def model_layout(t):
    """(B,H,S,D) kernel layout -> (B,S,H,D) model layout (contiguous)."""
    return t.transpose(1, 2).contiguous()


@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hk,Sq,T,D", FLASH_SHAPES)
def test_flash_plain_matches_pallas(B, H, Hk, Sq, T, D, dtype, window):
    """flash_seq_op (static offset T-Sq) and flash_chunk_op (runtime offset)
    on CPU tensors vs JAX's flash_prefill / flash_prefill_dyn in interpret
    mode, and vs the port's ref.py."""
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(B, H, Hk, Sq, T, D, dtype)
    off = T - Sq
    want = f32(flash_prefill(jq, jk, jv, q_offset=off, window=window,
                             bq=64, bk=64, interpret=True))
    want_dyn = f32(flash_prefill_dyn(jq, jk, jv, off, window=window,
                                     bq=64, bk=64, interpret=True))
    mq, mk, mv = model_layout(tq), model_layout(tk), model_layout(tv)
    got = f32(flash_seq_op(mq, mk, mv, window=window).transpose(1, 2))
    got_dyn = f32(flash_chunk_op(mq, mk, mv, off,
                                 window=window).transpose(1, 2))
    ref = f32(flash_prefill_ref(tq, tk, tv, q_offset=off, window=window))
    np.testing.assert_allclose(got, want, **tol(dtype))
    np.testing.assert_allclose(got_dyn, want_dyn, **tol(dtype))
    np.testing.assert_allclose(got, ref, **tol(dtype))


def paged_inputs(B, H, Hk, D, page, P, MP, dtype, lengths=None, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((P, page, Hk, D), np.float32)
    vp = rng.standard_normal((P, page, Hk, D), np.float32)
    pt = rng.integers(0, P, size=(B, MP)).astype(np.int32)
    if lengths is None:
        lengths = (np.arange(1, B + 1) * (MP * page // (B + 1)) + 1)
    lengths = np.asarray(lengths, np.int32)
    return (both(q, dtype), both(kp, dtype), both(vp, dtype),
            (jnp.asarray(pt), torch.from_numpy(pt)),
            (jnp.asarray(lengths), torch.from_numpy(lengths)))


def _check_paged(args, dtype):
    (jq, tq), (jk, tk), (jv, tv), (jpt, tpt), (jln, tln) = args
    want = f32(paged_attention(jq, jk, jv, jpt, jln, interpret=True))
    got = f32(paged_attention_op(tq, tk, tv, tpt, tln))
    ref = f32(paged_attention_ref(tq, tk, tv, tpt, tln))
    np.testing.assert_allclose(got, want, **tol(dtype))
    np.testing.assert_allclose(got, ref, **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hk,D,page,P,MP", PAGED_SHAPES)
def test_paged_plain_matches_pallas(B, H, Hk, D, page, P, MP, dtype):
    """paged_attention_op on CPU tensors, over a random (general) page
    table, vs JAX's paged_attention in interpret mode and vs ref.py."""
    _check_paged(paged_inputs(B, H, Hk, D, page, P, MP, dtype), dtype)


def test_paged_plain_single_token_context():
    """length == 1: only the first position of the first page is live."""
    _check_paged(paged_inputs(2, 4, 2, 64, 16, 8, 2, "float32",
                              lengths=[1, 1], seed=2), "float32")


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain version and launch
    nothing, so their counters stay put."""
    (_, tq), (_, tk), (_, tv) = flash_inputs(1, 2, 1, 32, 32, 32, "float32")
    before = (flash_seq_op.launches, flash_chunk_op.launches,
              paged_attention_op.launches)
    flash_seq_op(model_layout(tq), model_layout(tk), model_layout(tv))
    flash_chunk_op(model_layout(tq), model_layout(tk), model_layout(tv), 0)
    args = paged_inputs(1, 2, 1, 32, 16, 4, 2, "float32", lengths=[20])
    paged_attention_op(*(a[1] for a in args))
    assert (flash_seq_op.launches, flash_chunk_op.launches,
            paged_attention_op.launches) == before


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 32, 4, 32)
    k = torch.zeros(1, 32, 3, 32)                 # 4 heads over 3 kv heads
    with pytest.raises(ValueError):
        flash_seq_op(q, k, k)
    with pytest.raises(ValueError):
        flash_chunk_op(q, q, q, 0, window=0)
    pt = torch.zeros(1, 2, dtype=torch.int64)     # page table must be int32
    with pytest.raises(TypeError):
        paged_attention_op(torch.zeros(1, 4, 32), torch.zeros(4, 16, 2, 32),
                           torch.zeros(4, 16, 2, 32), pt,
                           torch.ones(1, dtype=torch.int32))
