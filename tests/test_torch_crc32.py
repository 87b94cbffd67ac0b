"""The CRC-32 kernel's arithmetic on the CPU, and the kernel on the card.

``repro_torch.kernels.crc32.ref.crc32_ref`` repeats the kernel's
decomposition (blocks front-padded with zeros, a thread's 64-byte units
folded through the slicing tables with its register carried over the
tile, a tree over the block, a second tree over the blocks, the ragged
tail, preset, inversion and chaining) and must equal ``zlib.crc32`` at
every length the decomposition cuts differently: empty, shorter than a
16-byte load, around one thread's unit, one tile and one block, and
several blocks with a ragged tail. Chains across tensors of bf16, float32
and uint8 equal zlib over the bytes end to end. ``state_checksum`` on host
tensors reads zlib's value, as it did before the kernel.

The last test needs a CUDA device and skips without one: the kernel
against zlib at the migration payloads' shapes of qwen3-1.7b (k then v
stacked, bf16) and at ragged lengths and chains.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_crc32.py
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.engine.instance import state_checksum  # noqa: E402
from repro_torch.kernels.crc32 import crc32_op, crc32_ref  # noqa: E402
from repro_torch.kernels.crc32 import ref  # noqa: E402

UNIT, TILE, BLOCK = ref.UNIT, ref.TILE, ref.BLOCK_BYTES
LENGTHS = [0, 1, 3, 15, 16, 17, UNIT - 1, UNIT, UNIT + 1, TILE - 1, TILE,
           TILE + 1, BLOCK - 1, BLOCK, BLOCK + 1, 3 * BLOCK + 7717]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "u8": torch.uint8}


def host_crc(tensors, crc=0):
    """The checksum as the port took it before the kernel: zlib over a
    ``tobytes`` copy of each tensor's raw bytes, chained."""
    for t in tensors:
        raw = torch.as_tensor(t).contiguous().view(torch.uint8)
        crc = zlib.crc32(raw.cpu().numpy().tobytes(), crc)
    return crc


def rand_bytes(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8))


def rand_tensor(dtype, n, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.uint8:
        return torch.randint(0, 256, (n,), generator=g, dtype=torch.uint8)
    return torch.randn(n, generator=g).to(dtype)


@pytest.mark.parametrize("n", LENGTHS)
def test_decomposition_equals_zlib(n):
    data = rand_bytes(n, n)
    for prev in (0, 0x9E3779B9):
        want = zlib.crc32(data.numpy().tobytes(), prev)
        assert crc32_ref(data, prev) == want, (n, prev)
        assert crc32_op(data, prev) == want, (n, prev)


@pytest.mark.parametrize("dtypes", [("bf16",), ("f32", "u8"),
                                    ("bf16", "f32", "u8")],
                         ids="-".join)
def test_chain_across_tensors(dtypes):
    """Chained from a nonzero CRC across 1-3 tensors of mixed types (odd
    lengths, the first 2-D), the decomposition equals zlib over the bytes
    end to end, and so does the wrapper on the host."""
    ts = [rand_tensor(DTYPES[d], 16385 + 37 * i, i)
          for i, d in enumerate(dtypes)]
    ts[0] = ts[0][:-1].reshape(2, -1) if ts[0].numel() % 2 else ts[0]
    prev = 0x12345678
    want = zlib.crc32(b"".join(t.contiguous().view(torch.uint8).numpy()
                               .tobytes() for t in ts), prev)
    got_ref, got_op = prev, prev
    for t in ts:
        got_ref = crc32_ref(t, got_ref)
        got_op = crc32_op(t, got_op)
    assert got_ref == got_op == want


def test_state_checksum_on_host_unchanged():
    """``state_checksum`` of host tensors (a strided view among them, and a
    numpy array as a JAX payload hands over) is the pre-kernel host CRC,
    and the CPU path never counts a kernel launch."""
    before = crc32_op.launches
    slab = torch.randn(3, 5, 8).to(torch.bfloat16)
    payload = [slab[:, 2], torch.arange(11, dtype=torch.int32),
               np.arange(7, dtype=np.float32),
               torch.zeros(0, dtype=torch.float32)]
    assert state_checksum(payload) == host_crc(payload)
    assert state_checksum([]) == 0
    assert crc32_op.launches == before


def test_tables_are_zlib_and_shift_operators():
    """T_0 is zlib's byte table, and each shift-by-2^k operator moves a
    register as 2^k zero bytes fed to zlib's register would."""
    t = ref.tables().astype(np.int64)
    for v in (0, 1, 0x5A, 0xFF):
        # one byte v from a zero register: R(0, v) = T_0[v]; zlib's preset
        # and inversion cancel for the all-ones register
        assert zlib.crc32(bytes([v]), 0xFFFFFFFF) ^ 0xFFFFFFFF == t[0, v]
    T = torch.from_numpy(t).reshape(-1)
    for k in (0, 1, 2, 6, 13):
        c = 0x2F6A9C41
        want = zlib.crc32(bytes(1 << k), c ^ 0xFFFFFFFF) ^ 0xFFFFFFFF
        got = int(ref.apply(T, ref.POW2 + 4 * k, torch.tensor([c]))[0])
        assert got == want, k


@pytest.mark.cuda
def test_kernel_matches_zlib_on_card():
    """The kernel equals zlib on the card: qwen3-1.7b's k-then-v images at
    the conv mix's 199 MB, the code mix's 0.52 GB mean and its 1.87 GB
    16,320-token prompt (bf16, 28 layers x 8 kv heads x 128), every ragged
    length above, an unaligned start, and a chain of three tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no interpret mode)")
    dev = torch.device("cuda")
    before = crc32_op.launches
    calls = 0
    for tokens in (1736, 4534, 16320):
        img = torch.randn((2, 28, tokens, 8, 128), device=dev).to(
            torch.bfloat16)
        want = host_crc([img.cpu()])
        assert crc32_op(img) == want, tokens
        assert state_checksum([img]) == want, tokens
        calls += 2
        del img
    for n in LENGTHS + [BLOCK * 257 + 3, BLOCK * 1031 - 16]:
        data = rand_bytes(n, n)
        for prev in (0, 0xCAFEF00D):
            assert crc32_op(data.to(dev), prev) == zlib.crc32(
                data.numpy().tobytes(), prev), (n, prev)
            calls += 1
    data = rand_bytes(1 << 20, 5)
    odd = data.to(dev)[3:]                      # an unaligned start
    assert crc32_op(odd) == zlib.crc32(data[3:].numpy().tobytes())
    ts = [rand_tensor(DTYPES[d], 300001 + i, i)
          for i, d in enumerate(("bf16", "f32", "u8"))]
    assert state_checksum([t.to(dev) for t in ts]) == host_crc(ts)
    assert crc32_op.launches - before == calls + 1 + 3
