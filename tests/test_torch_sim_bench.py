"""Parity of the port's simulator benches with the JAX package's.

Each of the eleven simulator benches of ``benchmarks/`` has a copy in
``repro_torch.bench`` whose every ``Simulator`` takes its profile from
``repro_torch.bench.common.sim_profile``. Given the JAX cost model's
constants through that seam (built as ``tests/test_torch_sim.py`` builds
them), both run the same Python floats, so each copy prints the JAX
module's lines with ``==`` on ``name`` and ``derived``, at its ``--smoke``
size or a short ``--duration``. Left out, because they are host time:

  * the ``us_per_call`` column of every line;
  * ``us_per_request`` and ``us_per_token`` in ``bench_scalability``'s
    overhead point.

Then the JAX package's own bench tests, each on the port's default (H100)
profile, the rule ``bench_e2e`` applies to its baselines, and the runner's
order. Results go to ``tmp_path``.
"""
import contextlib
import importlib
import io
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))          # the JAX benchmarks live at the root

from repro.configs import get_config  # noqa: E402
from repro.sim import CostModel as JaxCostModel  # noqa: E402
from repro.sim import InstanceProfile as JaxProfile  # noqa: E402
from repro.sim import cost_model as jax_cm  # noqa: E402
from repro_torch.bench import common  # noqa: E402
from repro_torch.sim import InstanceProfile  # noqa: E402

HOST_FIELDS = ("us_per_request", "us_per_token")


def jax_constants() -> InstanceProfile:
    """The port's InstanceProfile carrying the JAX defaults and constants
    (the JAX transfer latency is a literal: a zero-byte transfer's time)."""
    d = JaxProfile()
    latency = JaxCostModel(get_config("gemma-2b"), d).transfer_time_bytes(0.0)
    return InstanceProfile(
        chips=d.chips, flop_eff=d.flop_eff, mem_eff=d.mem_eff,
        overhead=d.overhead, peak_flops=jax_cm.PEAK_FLOPS,
        hbm_bw=jax_cm.HBM_BW, hbm_bytes=jax_cm.HBM_BYTES,
        link_bw=jax_cm.ICI_BW, link_latency=latency)


@pytest.fixture
def results(monkeypatch, tmp_path):
    """Both packages' results into ``tmp_path``."""
    import benchmarks.common as jax_common
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path / "port")
    monkeypatch.setattr(jax_common, "RESULTS_DIR", tmp_path / "jax")


@pytest.fixture
def jax_profile(monkeypatch, results):
    monkeypatch.setattr(common, "PROFILE", jax_constants())


def capture(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().strip().splitlines()


def name_derived(lines):
    """(name, derived) of each line, ``derived`` without its host-time
    fields."""
    out = []
    for line in lines:
        name, _us, derived = line.split(",", 2)
        kept = [f for f in derived.split(" ")
                if f.split("=", 1)[0] not in HOST_FIELDS]
        out.append((name, " ".join(kept)))
    return out


def both(module: str, *args):
    """The JAX module's and the port copy's lines, run with ``args``."""
    jax_mod = importlib.import_module(f"benchmarks.{module}")
    port = importlib.import_module(f"repro_torch.bench.{module}")
    return (name_derived(capture(jax_mod.main, *args)),
            name_derived(capture(port.main, *args)))


# module -> argv (None: main takes no arguments); each at its --smoke size
# or a short --duration
PARITY = {
    "bench_trace_stats": None,
    "bench_load_difference": None,
    "bench_ablation": ["--duration", "3"],
    "bench_scalability": ["--smoke"],
    "bench_flip_latency": ["--duration", "10"],
    "bench_elastic": ["--smoke"],
    "bench_deflection": ["--smoke"],
    "bench_prefix": ["--smoke", "--duration", "40"],
    "bench_faults": ["--smoke"],
    "bench_tenants": ["--smoke"],
}


@pytest.mark.parametrize("module", list(PARITY))
def test_copy_prints_the_jax_lines(jax_profile, module):
    argv = PARITY[module]
    jax_lines, port_lines = both(module, *(() if argv is None else (argv,)))
    assert jax_lines, module
    assert port_lines == jax_lines


def test_e2e_curves_equal_the_jax_ones(jax_profile):
    """``bench_e2e`` through ``run_system`` and ``max_sustainable``: one
    trace, two rates, a short trace, every system."""
    from benchmarks import bench_e2e as jax_e2e

    from repro_torch.bench import bench_e2e
    assert list(bench_e2e.SYSTEMS) == list(jax_e2e.SYSTEMS)
    for sys_name in jax_e2e.SYSTEMS:
        want = jax_e2e.run_system("azure_code", sys_name, "gemma-2b", 10.0,
                                  rates=[4.0, 16.0])
        got = bench_e2e.run_system("azure_code", sys_name, "gemma-2b", 10.0,
                                   rates=[4.0, 16.0])
        assert got == want, sys_name
        assert bench_e2e.max_sustainable(got) == \
            jax_e2e.max_sustainable(want)
    assert bench_e2e.RATES == jax_e2e.RATES
    assert bench_e2e.TARGET == jax_e2e.TARGET


def test_e2e_rule_gives_the_jax_literals_on_the_jax_defaults(jax_profile):
    from benchmarks import bench_e2e as jax_e2e

    from repro_torch.bench import bench_e2e
    for sys_name, spec in jax_e2e.SYSTEMS.items():
        want = spec["profile"]
        got = bench_e2e.system_profile(bench_e2e.SYSTEMS[sys_name]["profile"])
        for f in ("chips", "flop_eff", "mem_eff", "overhead"):
            assert abs(getattr(got, f) - getattr(want, f)) <= 1e-12, \
                (sys_name, f)


def test_e2e_scaled_rule_on_the_h100_profile():
    """Each baseline keeps its efficiency's ratio to the default."""
    from repro_torch.bench import bench_e2e
    base = InstanceProfile()
    vllm = bench_e2e.system_profile(bench_e2e.SYSTEMS["vllm"]["profile"])
    assert vllm.chips == 32
    assert abs(vllm.flop_eff - base.flop_eff * 0.4 / 0.5) <= 1e-12
    assert abs(vllm.mem_eff - base.mem_eff * 0.6 / 0.7) <= 1e-12
    arrow = bench_e2e.system_profile(bench_e2e.SYSTEMS["arrow"]["profile"])
    assert arrow == InstanceProfile(chips=4)
    distserve = bench_e2e.system_profile(
        bench_e2e.SYSTEMS["distserve"]["profile"])
    assert abs(distserve.flop_eff - base.flop_eff * 0.25 / 0.5) <= 1e-12
    assert abs(distserve.mem_eff - base.mem_eff * 0.4 / 0.7) <= 1e-12


# ---- the JAX package's bench tests (tests/test_benchmarks.py), on the
# port's default profile


def test_trace_stats_emits_csv(results):
    from repro_torch.bench import bench_trace_stats
    from repro_torch.traces import TRACE_PRESETS
    lines = capture(bench_trace_stats.main)
    assert len(lines) == len(TRACE_PRESETS)
    for line in lines:
        name, us, derived = line.split(",", 2)
        assert name.startswith("trace_stats.")
        assert float(us) >= 0


def test_load_difference_prefill_leads(results):
    from repro_torch.bench import bench_load_difference
    lines = capture(bench_load_difference.main)
    derived = lines[0].split(",", 2)[2]
    lead = float(derived.split("lead=")[1].rstrip("s"))
    assert lead > 0


def test_scalability_quick(results):
    from repro_torch.bench import bench_scalability
    lines = capture(bench_scalability.main, ["--smoke"])
    assert len(lines) == 5          # n2/n4 x two strategies + overhead point
    att = {}
    for line in lines:
        name, _, derived = line.split(",", 2)
        if name.startswith("scalability.overhead"):
            assert "us_per_request=" in derived and "us_per_token=" in derived
        else:
            att[name] = float(derived.split("=")[1])
    assert att["scalability.n4.arrow"] >= att["scalability.n2.arrow"]


def test_elastic_benchmark_smoke(results):
    from repro_torch.bench import bench_elastic
    lines = capture(bench_elastic.main, ["--smoke"])
    assert any(line.startswith("elastic.spike.arrow_elastic")
               for line in lines)
    assert any(line.startswith("elastic.spike.saving") for line in lines)
    for line in lines:
        name, us, derived = line.split(",", 2)
        assert float(us) >= 0


def test_every_simulator_takes_the_seam(monkeypatch, results):
    """No copy builds a profile of its own: with the seam's profile
    swapped, every Simulator a copy makes carries it."""
    import repro_torch.sim as port_sim
    seen = []
    real = port_sim.Simulator

    class Spy(real):
        def __init__(self, *a, **kw):
            seen.append(kw.get("profile"))
            super().__init__(*a, **kw)

    marker = InstanceProfile(overhead=0.00317)
    monkeypatch.setattr(common, "PROFILE", marker)
    for module, argv in (("bench_load_difference", None),
                         ("bench_flip_latency", ["--duration", "5"]),
                         ("bench_faults", ["--smoke", "--duration", "10"])):
        mod = importlib.import_module(f"repro_torch.bench.{module}")
        monkeypatch.setattr(mod, "Simulator", Spy)
        capture(mod.main, *(() if argv is None else (argv,)))
    assert seen and all(p is not None and p.overhead == 0.00317
                        for p in seen)


def test_runner_names_the_jax_modules_in_order():
    """``repro_torch.bench.run`` runs the JAX runner's modules in the JAX
    runner's order, all but its race of the JAX engine's two step modes
    (the port has one)."""
    import ast
    import re

    def calls(path):
        tree = ast.parse(Path(path).read_text())
        fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                  and n.name == "main")
        names = []
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "main"
                    and isinstance(node.func.value, ast.Name)):
                names.append((node.lineno, node.func.value.id))
        return [n for _, n in sorted(names)]

    jax_order = calls(ROOT / "benchmarks" / "run.py")
    port_order = calls(ROOT / "src" / "repro_torch" / "bench" / "run.py")
    assert port_order == [n for n in jax_order if n != "bench_engine_step"]
    assert len(jax_order) == 17
    doc = importlib.import_module("repro_torch.bench").__doc__
    for name in port_order:
        assert re.search(rf"\b{name}\b", doc), name
