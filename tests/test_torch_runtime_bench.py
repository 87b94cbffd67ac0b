"""The port's ``bench_ssm`` and ``bench_chaos`` engine legs and its
examples on the CPU.

The legs' content is held against the JAX engine: with the JAX weights of
``PRNGKey(7)`` carried across, the chaos leg's streams under drops,
netslow and a crash (the JAX bench's plan, and one whose crash is sure to
land) equal the JAX engine's fault-free sequential streams, and the SSM
leg's forced-migration streams on the spike trace equal the JAX engine's
colocated ones, with the same migration bytes. Then the two benches
(``--smoke --device cpu``) and the four examples (``--device cpu``) run in
subprocesses, each under a time limit of its own.
"""
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import SLO as JSLO  # noqa: E402
from repro.core import SamplingParams as JSamplingParams  # noqa: E402
from repro.core.serving import replay_trace as jax_replay  # noqa: E402
from repro.engine import ArrowEngineCluster as JCluster  # noqa: E402
from repro.engine import EngineInstance as JInstance  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.traces import load_trace as jax_trace  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.bench import bench_chaos, bench_ssm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def bridged():
    """arch -> (JAX config, JAX params, port config, port params), the
    weights of ``PRNGKey(7)`` on both sides (non-partitionable threefry on
    the JAX side; the port on one intra-op thread, which a loaded test
    host does not stall; both restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    out = {}
    for arch in ("qwen3-1.7b", "mamba2-370m"):
        jcfg = jax_smoke(arch)
        jparams = build_model(jcfg).init(jax.random.PRNGKey(7))
        tcfg = get_smoke_config(arch).replace(attn_impl="hopper")
        out[arch] = (jcfg, jparams, tcfg, weights.from_jax_params(
            jax.device_get(jparams), tcfg, "cpu"))
    yield out
    jax.config.update("jax_threefry_partitionable", old)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("plan,late", [
    (bench_chaos.ENGINE_PLAN, None),
    ("droptransfer@0.05:p=0.7,duration=1;netslow@0.2:factor=3,duration=1;"
     "crash@0.1:target=1", (0.5, 4))], ids=["bench_plan", "sure_crash"])
def test_chaos_engine_leg_matches_jax_reference(bridged, plan, late):
    """``run_engine_leg`` under the JAX bench's plan and under one whose
    crash lands (a late request keeps the cluster serving past it): no
    request lost, every stream, greedy and sampled, equal to the port's
    fault-free sequential stream and to the JAX engine's."""
    jcfg, jparams, tcfg, tparams = bridged["qwen3-1.7b"]
    counts, report, streams = bench_chaos.run_engine_leg(
        tcfg, tparams, "cpu", plan=plan, late=late)
    assert counts["mismatched_streams"] == 0, counts
    if late is not None:
        assert counts["crashes"] == 1
    prompts = bench_chaos.engine_prompts(tcfg, counts["n_requests"])
    sp = JSamplingParams(temperature=0.8, top_p=0.9)
    ref = JInstance(99, jcfg, jparams, n_slots=1, capacity=128, run_seed=3)
    for rid, prompt in prompts.items():
        n_new = late[1] if late is not None and rid == 6 else 12
        if rid % 2:
            ref.set_sampling(rid, sp)
        want = [ref.run_prefill(rid, prompt)]
        ref.local.start_local_decode(rid, len(prompt), n_new - 1)
        for _ in range(n_new - 1):
            want.append(ref.run_decode_iteration([rid])[rid])
        ref.drop(rid)
        assert streams[rid] == [int(t) for t in want], rid


def test_chaos_straggler_leaves_the_tpot_slo():
    """The sim legs' straggler: the least whole slowdown whose slowed
    cheapest decode step (one request at context 1) exceeds the spike TPOT
    SLO on the port's default profile, where the JAX plan's 8 stays inside
    the SLO, as it does on the JAX package's own profile."""
    from repro.configs import get_config as jax_config
    from repro.sim.cost_model import CostModel as JCostModel
    from repro_torch.configs import get_config
    from repro_torch.sim.cost_model import CostModel
    from repro_torch.traces import TRACE_PRESETS
    slo = TRACE_PRESETS["spike"].slo_tpot
    cfg = get_config("gemma-2b")
    step = CostModel(cfg).iteration_time([], [1])
    f = bench_chaos.straggler_factor(cfg, slo)
    assert (f - 1) * step <= slo < f * step
    assert f == 39
    assert 8 * step < slo
    assert 8 * JCostModel(jax_config("gemma-2b")).iteration_time([], [1]) \
        < slo


@pytest.mark.parametrize("arch", ["mamba2-370m", "qwen3-1.7b"])
def test_ssm_leg_forced_migration_matches_jax(bridged, arch):
    """The SSM leg's forced-migration run (``arrow``, every decode
    migrates) on the spike trace gives the JAX engine's colocated streams
    (sampled at temperature 0.7 / top-p 0.9) and the JAX engine's
    migration bytes per request: constant for Mamba-2, proportional to
    context for qwen3."""
    jcfg, jparams, tcfg, tparams = bridged[arch]
    _, log, streams = bench_ssm.serve(tcfg, "arrow", rate=1.5, duration=4.0,
                                      device="cpu", params=tparams)
    assert log
    jeng = JCluster(jcfg, n_instances=2, n_prefill=1, n_slots=8,
                    capacity=160, slo=JSLO(5.0, 2.0), policy="colocated",
                    seed=0, params=jparams)
    trace = jax_trace("spike", rate_scale=1.5, seed=0, duration=4.0)
    for r in trace:
        r.sampling = JSamplingParams(temperature=0.7, top_p=0.9, seed=None)
    jax_replay(jeng, trace)
    jeng.drain(timeout=600)
    want = {h.req.rid: tuple(int(t) for t in h.tokens)
            for h in jeng.handles.values()}
    assert {rid: tuple(int(t) for t in s) for rid, s in streams.items()} \
        == want
    jlog = JCluster(jcfg, n_instances=2, n_prefill=1, n_slots=8,
                    capacity=160, slo=JSLO(5.0, 2.0), policy="arrow",
                    seed=0, params=jparams)
    jax_replay(jlog, trace)
    jlog.drain(timeout=600)
    per_rid = {m["rid"]: (m["ctx_tokens"], m["bytes"]) for m in log}
    for m in jlog.migration_log:
        assert per_rid[m["rid"]] == (m["ctx_tokens"], m["bytes"])
    sizes = {b for _, b in per_rid.values()}
    if arch == "mamba2-370m":
        assert len(sizes) == 1
    else:
        assert len({b / c for c, b in per_rid.values()}) == 1


@pytest.mark.parametrize("argv", [
    ["repro_torch.bench.bench_ssm", "--smoke", "--device", "cpu"],
    ["repro_torch.bench.bench_chaos", "--smoke", "--device", "cpu"],
    ["repro_torch.examples.simulate_cluster", "--rates", "4",
     "--duration", "30", "--device", "cpu"],
    ["repro_torch.examples.quickstart", "--device", "cpu"],
    ["repro_torch.examples.serve_arrow", "--device", "cpu"],
    ["repro_torch.examples.train_100m", "--steps", "20", "--device", "cpu"],
], ids=lambda a: a[0].rsplit(".", 1)[-1])
def test_bench_and_example_run_on_cpu(argv):
    """Each bench (its own assertions) and example exits 0 on the CPU,
    on one intra-op thread as the fixtures above run the port."""
    out = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert out.stdout.strip()
