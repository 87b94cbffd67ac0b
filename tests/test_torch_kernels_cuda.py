"""The port's Hopper kernels against their plain-torch versions, on the
card. Every test here needs a CUDA device and skips without one (the
kernels have no interpret mode); the file imports no JAX, so it runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Shapes follow tests/test_kernels.py, plus the engine's main-path shapes at
qwen3-1.7b width. Tolerances: float32 at 2e-5 (other summation orders),
bfloat16 at 2e-2 (one bf16 rounding of the output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (flash_chunk_op, flash_seq_op,  # noqa: E402
                                 paged_attention_op)

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
]


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


def test_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros(1, 32, 4, 48, device=cuda)    # head_dim 48: no variant
    with pytest.raises(ValueError):
        flash_seq_op(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(TypeError):                # float16: no variant
        flash_seq_op(q.half(), q[:, :, :2].half(), q[:, :, :2].half())
