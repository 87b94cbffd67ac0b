"""Parity of the port's cluster simulator with the JAX package's.

Each scenario runs the same trace through ``repro.sim.Simulator`` (its
default TPU profile) and through ``repro_torch.sim.Simulator`` given an
``InstanceProfile`` that carries the JAX cost model's constants. Both run
the same Python floats, so every report, per-request metric, migration log
and counter must be equal with ``==``. ``CostModel`` is held against the
JAX one the same way for every architecture. The launcher's sim mode runs
for every preset, and the port's default profile carries none of the TPU's
constants; under it, Arrow flips and scales up on a dense ``spike``.
"""
import dataclasses
import enum
import importlib
import types
import warnings
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS  # noqa: E402
from repro.sim import cost_model as jax_cm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TPU_VALUES = (jax_cm.PEAK_FLOPS, jax_cm.HBM_BW, jax_cm.HBM_BYTES,
              jax_cm.ICI_BW)


def package(prefix: str) -> types.SimpleNamespace:
    """The modules a scenario needs, from one package."""
    return types.SimpleNamespace(**{
        name: importlib.import_module(f"{prefix}.{name}")
        for name in ("configs", "core", "sim", "traces")})


JAX, TORCH = package("repro"), package("repro_torch")


def profile(pkg, **kw):
    """``pkg``'s InstanceProfile; the port's carries the JAX constants (the
    JAX transfer latency is a literal: a zero-byte transfer's time)."""
    if pkg is JAX:
        return JAX.sim.InstanceProfile(**kw)
    d = JAX.sim.InstanceProfile(**kw)
    latency = JAX.sim.CostModel(JAX.configs.get_config("gemma-2b"),
                                d).transfer_time_bytes(0.0)
    return TORCH.sim.InstanceProfile(
        chips=d.chips, flop_eff=d.flop_eff, mem_eff=d.mem_eff,
        overhead=d.overhead, peak_flops=jax_cm.PEAK_FLOPS,
        hbm_bw=jax_cm.HBM_BW, hbm_bytes=jax_cm.HBM_BYTES,
        link_bw=jax_cm.ICI_BW, link_latency=latency)


def norm(x):
    """Package-neutral view: enums by name, dataclasses as dicts."""
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


# scenario -> (trace, rate scale, duration, Simulator kwargs from a package);
# 4 instances unless stated, at loads where each mechanism acts (flips,
# scale events, recovered and lost requests, quarantines, transfer retries,
# deflected chunks, prefix hits, speculative rounds)
CRASH_SLOW = "crash@20:target=3;slow@10:target=0,factor=4,duration=6"
SCENARIOS = {
    **{f"policy_{p}": ("spike", 8.0, 40, lambda P, p=p: {"policy": p})
       for p in JAX.core.POLICIES},
    "elastic_autoscaler": ("spike", 3.0, 40, lambda P: {
        "policy": "arrow_elastic",
        "autoscaler_cfg": P.core.AutoScalerConfig(min_instances=2,
                                                  max_instances=10)}),
    "faults_recovery": ("spike", 8.0, 40, lambda P: {
        "fault_plan": P.core.FaultPlan.parse(CRASH_SLOW)}),
    "faults_no_recovery": ("spike", 8.0, 40, lambda P: {
        "fault_plan": P.core.FaultPlan.parse(CRASH_SLOW, recovery=False)}),
    "tenants_admission": ("tenants", 12.0, 30, lambda P: {
        "n_instances": 2, "tenants": P.core.default_registry(3),
        "admission": True}),
    "deflect": ("spike", 16.0, 40, lambda P: {
        "policy": "arrow_deflect",
        "deflection": P.core.DeflectionConfig(ratio=0.5)}),
    "prefix_multiturn": ("multiturn", 2.0, 60, lambda P: {
        "prefix_cache": True}),
    "speculate": ("azure_code", 4.0, 30, lambda P: {"speculate": 4}),
    "health": ("spike", 8.0, 40, lambda P: {
        "health": True, "fault_plan": P.core.FaultPlan.parse(
            "slow@5:target=2,factor=8,duration=20;"
            "droptransfer@5:p=0.5,duration=4")}),
    "heterogeneous_profiles": ("azure_code", 8.0, 30, lambda P: {
        "n_instances": 8, "profiles": {
            i: profile(P, chips=8 if i < 2 else 2) for i in range(8)}}),
    "flip_latency": ("spike", 16.0, 40, lambda P: {"flip_latency": 2.0}),
    "dbrx_spike": ("spike", 2.0, 30, lambda P: {"arch": "dbrx-132b"}),
    "deprecated_run": ("azure_code", 4.0, 30, lambda P: {"run": True}),
}


def observe(P, name):
    trace_name, rate, duration, make = SCENARIOS[name]
    kw = make(P)
    arch = kw.pop("arch", "gemma-2b")
    deprecated = kw.pop("run", False)
    kw.setdefault("n_instances", 4)
    kw.setdefault("n_prefill", kw["n_instances"] // 2)
    p = P.traces.TRACE_PRESETS[trace_name]
    sim = P.sim.Simulator(P.configs.get_config(arch), profile=profile(P),
                          slo=P.core.SLO(p.slo_ttft, p.slo_tpot), **kw)
    trace = P.traces.load_trace(trace_name, rate_scale=rate, seed=0,
                                duration=duration)
    out = {}
    if deprecated:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = sim.run(trace)
        assert any(issubclass(w.category, DeprecationWarning)
                   for w in caught)
        out["result"] = (res.attainment, res.flips, res.sim_time,
                         res.p90("ttft"), res.p90("tpot"))
        reqs = sorted(res.requests, key=lambda r: r.rid)
        report = sim.report()
    else:
        P.core.replay_trace(sim, trace)
        report = sim.drain()
        reqs = sorted((h.req for h in report.handles), key=lambda r: r.rid)
    out["summary"] = report.summary()
    out["requests"] = [(r.rid, r.ttft, r.tpot, r.finish_time,
                        r.first_token_time, r.prefill_instance,
                        r.decode_instance) for r in reqs]
    out["migration_log"] = sim.migration_log
    out["flips"] = sim.flip_counts()
    out["decisions"] = sim.decisions
    out["report"] = norm({k: getattr(report, k) for k in (
        "flip_detail", "decisions", "duration", "scaling", "prefix",
        "faults", "health", "admission", "deflection", "per_tenant",
        "speculation")})
    out["scale_events"] = norm(sim.autoscaler.events) \
        if sim.autoscaler is not None else None
    out["tenants"] = report.tenant_summary() if report.per_tenant else None
    return out, len(trace)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_simulator_matches_jax(name):
    want, n = observe(JAX, name)
    got, n_port = observe(TORCH, name)
    assert n_port == n > 0
    for key in want:
        assert got[key] == want[key], key


def test_dbrx_kv_capacity_under_both_profiles():
    """dbrx-132b's 264 GB of weights leave the TPU profile only the KV
    floor of 1024 tokens (the ``dbrx_spike`` scenario reproduces what that
    does to its traffic); four of the port's default H100s hold them."""
    cfg = TORCH.configs.get_config("dbrx-132b")
    assert TORCH.sim.CostModel(cfg, profile(TORCH)).kv_capacity_tokens() \
        == 1024
    assert TORCH.sim.CostModel(cfg).kv_capacity_tokens() > 1024


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cost_model_matches_jax(arch):
    from repro.sim import CostModel, SpeculationModel
    want = CostModel(JAX.configs.get_config(arch))
    got = TORCH.sim.CostModel(TORCH.configs.get_config(arch),
                              profile(TORCH))
    spec = SpeculationModel(k=4, draft_frac=0.5, accept=0.8)
    tspec = TORCH.sim.SpeculationModel(k=4, draft_frac=0.5, accept=0.8)
    assert (tspec.expected_emitted, tspec.cost_factor) == \
        (spec.expected_emitted, spec.cost_factor)
    for L in (64, 256, 1024, 2048, 4096, 8192, 16384, 32768, 65536):
        assert got.prefill_time(L) == want.prefill_time(L)
    for chunks, ctx in (([(0, 512)], []), ([], [100, 2000, 7]),
                        ([(256, 128), (0, 64)], [4096] * 16), ([], [])):
        assert got.iteration_time(chunks, ctx) == \
            want.iteration_time(chunks, ctx)
    for ctx in ([300] * 8, [1, 50000]):
        assert got.spec_iteration_time(ctx, tspec) == \
            want.spec_iteration_time(ctx, spec)
    assert got.kv_capacity_tokens() == want.kv_capacity_tokens()
    for kv in (0, 1, 777, 32768):
        assert got.migration_bytes(kv) == want.migration_bytes(kv)
        assert got.transfer_time(kv) == want.transfer_time(kv)
        assert got.transfer_time(kv, ici_links=4) == \
            want.transfer_time(kv, ici_links=4)
    for tpot in (0.02, 0.09, 0.135):
        assert got.max_running_tokens(tpot) == want.max_running_tokens(tpot)
    assert got.profile_ttft_samples() == want.profile_ttft_samples()


def test_default_profile_carries_no_tpu_constant():
    prof = TORCH.sim.InstanceProfile()
    values = [getattr(prof, f.name) for f in dataclasses.fields(prof)]
    assert not set(values) & set(TPU_VALUES), values
    assert prof.peak_flops == 989e12 and prof.hbm_bw == 3.35e12
    assert 0 < prof.flop_eff <= 1 and 0 < prof.mem_eff <= 1
    literals = ("197e12", "819e9", "16 * 2**30", "50e9", "ICI_BW",
                "PEAK_FLOPS")
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        assert not [s for s in literals if s in text], path


@pytest.mark.parametrize("arch,rate", [("qwen3-1.7b", 96.0),
                                       ("recurrentgemma-9b", 48.0)])
def test_default_profile_flips_and_scales_deterministically(arch, rate):
    """Under the port's own H100 profile, a ``spike`` dense enough to load
    four 4-card instances makes Arrow flip pools and the elastic policy
    scale up, the same way in two runs."""
    cfg = TORCH.configs.get_config(arch)
    p = TORCH.traces.TRACE_PRESETS["spike"]
    runs = []
    for _ in range(2):
        sim = TORCH.sim.Simulator(cfg, n_instances=4, n_prefill=2,
                                  policy="arrow_elastic",
                                  slo=TORCH.core.SLO(p.slo_ttft, p.slo_tpot))
        TORCH.core.replay_trace(sim, TORCH.traces.load_trace(
            "spike", rate_scale=rate, seed=0, duration=10.0))
        rep = sim.drain()
        runs.append((rep.summary(), sim.migration_log, rep.flips,
                     rep.scaling["scale_ups"]))
    assert runs[0] == runs[1]
    assert runs[0][2] > 0 and runs[0][3] > 0, runs[0][0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launcher_sim_mode_serves_every_preset(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--mode", "sim", "--arch", arch, "--trace", "spike",
                "--rate", "1", "--duration", "15"])
    out = capsys.readouterr().out
    assert f"[serve-sim {arch} spike x1.0 arrow] finished " in out
