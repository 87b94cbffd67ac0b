"""The port's engine benchmark legs (``repro_torch.bench``) at a tiny burst
on the CPU. Only their content checks are asserted here — stream identity
across step modes and across speculative and sequential decode; their speed
ratios are measured on the card, since a loaded CPU would make them flaky.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bench import bench_engine_step, bench_speculative  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.weights import init_params  # noqa: E402


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("qwen3-1.7b").replace(attn_impl="hopper")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_engine_step_leg_streams_identical(model):
    cfg, params = model
    reqs = bench_engine_step.make_workload(cfg, 3)
    _, legacy, tokens = bench_engine_step.run_mode(cfg, params, reqs,
                                                   "legacy", "cpu")
    _, fused, _ = bench_engine_step.run_mode(cfg, params, reqs, "fused",
                                             "cpu")
    assert fused == legacy
    assert len(legacy) == 3
    assert tokens == sum(len(p) + m for p, m in reqs)


def test_speculative_leg_streams_identical(model):
    cfg, params = model
    _, _, base = bench_speculative.run_burst(
        cfg, params, speculate=0, n=3, out_len=12, rid_base=0, device="cpu")
    _, rep, spec = bench_speculative.run_burst(
        cfg, params, speculate=bench_speculative.K_DRAFT, n=3, out_len=12,
        rid_base=0, device="cpu")
    assert [list(h.tokens) for h in spec] == [list(h.tokens) for h in base]
    assert rep.speculation["rounds"] > 0


def test_trajectory_schema_guard(tmp_path):
    """A full run's artifact carries the device and power limit of each
    entry, and the guard refuses an entry without them."""
    entry = {k: 1 for k in bench_engine_step.ENTRY_KEYS}
    bench_engine_step.check_trajectory({"trajectory": [entry]})
    del entry["power_limit"]
    with pytest.raises(AssertionError, match="power_limit"):
        bench_engine_step.check_trajectory({"trajectory": [entry]})
    assert bench_engine_step.load_trajectory(tmp_path / "none.json") \
        == {"workload": None, "trajectory": []}
