"""The port's speculative benchmark leg (``repro_torch.bench``) at a tiny
burst on the CPU. Only its content check is asserted here — stream identity
across speculative and sequential decode; its speed ratio is measured on
the card, since a loaded CPU would make it flaky.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bench import bench_speculative  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.weights import init_params  # noqa: E402


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("qwen3-1.7b").replace(attn_impl="hopper")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_speculative_leg_streams_identical(model):
    cfg, params = model
    _, _, base = bench_speculative.run_burst(
        cfg, params, speculate=0, n=3, out_len=12, rid_base=0, device="cpu")
    _, rep, spec = bench_speculative.run_burst(
        cfg, params, speculate=bench_speculative.K_DRAFT, n=3, out_len=12,
        rid_base=0, device="cpu")
    assert [list(h.tokens) for h in spec] == [list(h.tokens) for h in base]
    assert rep.speculation["rounds"] > 0

