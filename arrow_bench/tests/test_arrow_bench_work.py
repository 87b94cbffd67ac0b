"""The roofline and MFU work counts against hand-computed shapes, and the
bounds the program's ``bench_kernels`` printed at its main shapes."""
import json
from pathlib import Path

import pytest

from arrow_bench import peaks, work
from arrow_bench.bench import load_module

BENCH = Path(__file__).resolve().parents[1]


def test_flash_chunk_by_hand():
    # 2 queries at positions 3, 4: pairs 4 + 5; q, o 2x(2x2x8); K, V 5x1x8
    nbytes, flops = work.flash_chunk(2, 3, heads=2, kv_heads=1, head_dim=8)
    assert flops == 4 * 8 * 2 * (4 + 5)
    assert nbytes == 2 * (2 * 2 * 2 * 8 + 2 * 5 * 1 * 8)


def test_paged_decode_by_hand():
    nbytes, flops = work.paged_decode([3, 5], heads=2, kv_heads=1,
                                      head_dim=8, capacity=64)
    assert flops == 4 * 8 * 2 * 8
    # q and o, K and V of 8 live positions, page table 2 x (64 / 64), lengths
    assert nbytes == 2 * (2 * 2 * 2 * 8 + 2 * 8 * 1 * 8) + 4 * (2 * 1 + 2)
    # the program's page: the largest power of two dividing it, <= 128
    assert work.paged_decode([1], 1, 1, 8, 8192)[0] == \
        2 * (2 * 8 + 2 * 8) + 4 * (64 + 1)


def test_ssd_chunk_by_hand():
    nbytes, flops = work.ssd_chunk(8, heads=2, head_dim=3, d_state=4,
                                   groups=1, chunk=4)
    pairs = 4 * 5 // 2
    assert flops == 2 * (2 * (2 * pairs * 3 + 4 * 4 * 4 * 3) + 2 * pairs * 4)
    assert nbytes == 4 * (8 * 6 + 8 * 2 + 2 * 8 * 4 + 24 + 8 * 6 + 24)


@pytest.mark.parametrize("case,us", [
    # bench_kernels' main shapes and the bounds it printed (PERF.md)
    (("flash", 256, 512), 1.565),
    (("paged", [1, 100, 257, 400, 512, 700, 731, 1024]), 4.574),
    (("ssd", 256), 2.062)])
def test_bench_kernels_bounds(case, us):
    if case[0] == "flash":
        b = work.bound_s(*work.flash_chunk(case[1], case[2], 16, 8, 128),
                         peaks.BF16_FLOPS)
    elif case[0] == "paged":
        b = work.bound_s(*work.paged_decode(case[1], 16, 8, 128, 1024),
                         peaks.BF16_FLOPS)
    else:
        b = work.bound_s(*work.ssd_chunk(case[1], 32, 64, 128, 1, 128),
                         peaks.TF32X3_FLOPS)
    assert b * 1e6 == pytest.approx(us, abs=5e-4)


def test_model_flops_by_hand():
    conf = json.loads((BENCH / "configs" / "qwen3-1.7b.json").read_text())
    fam = load_module(BENCH / "families" / "dense.py", "t_dense_w")
    d, ff, L = 2048, 6144, 28
    per = 2 * d * (2048 + 2 * 1024) + 2 * 2048 * d + 6 * d * ff
    assert fam.layer_flops(conf, 1, 100) == L * (per + 4 * 16 * 128 * 100)
    assert fam.head_flops(conf) == 2 * d * 151936
    # about 2 x 1.41e9 a token outside attention
    assert fam.layer_flops(conf, 1, 0) == pytest.approx(2 * 1.409e9,
                                                        rel=0.01)
    conf = json.loads((BENCH / "configs" / "mamba2-370m.json").read_text())
    fam = load_module(BENCH / "families" / "ssm.py", "t_ssm_w")
    d, di, H, N = 1024, 2048, 32, 128
    per = (2 * d * (2 * di + 2 * N + H) + 2 * 4 * (di + 2 * N)
           + 4 * H * 64 * N + 2 * di * d)
    assert fam.layer_flops(conf, 3, 999) == 48 * 3 * per
