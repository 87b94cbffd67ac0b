"""The port's fused step, on the CPU (``device="cpu"``), against the JAX
engine's legacy (pre-fusion) step mode, which stays as the reference; the
port has no step mode of its own but the fused one.

With the JAX parameters of ``PRNGKey(7)`` carried across by the weight
bridge (float32 on both sides): the fused cluster gives the JAX legacy
cluster's greedy streams over chunked prefill (the mirror of
``tests/test_engine.py::test_fused_step_matches_legacy_streams``); the
fused instance gives the JAX legacy instance's sampled stream (the mirror
of ``tests/test_sampling.py::test_fused_vs_legacy_sampled_streams``), on
both attention paths; a prompt prefilled in fused chunks leaves a valid
``pos_map`` and continues the whole-prompt stream. A cluster asked for
any other step mode refuses.

The JAX side runs in the non-partitionable threefry mode the engine's
golden pins were recorded under (set by a fixture and restored afterwards).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import SLO as JSLO  # noqa: E402
from repro.core import Request as JRequest  # noqa: E402
from repro.core import SamplingParams as JSamplingParams  # noqa: E402
from repro.engine import ArrowEngineCluster as JCluster  # noqa: E402
from repro.engine import EngineInstance as JInstance  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import SLO, Request, SamplingParams  # noqa: E402
from repro_torch.engine import ArrowEngineCluster, EngineInstance  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    jcfg = jax_smoke("qwen3-1.7b").replace(dtype="float32")
    jparams = build_model(jcfg).init(jax.random.PRNGKey(7))
    tcfg = get_smoke_config("qwen3-1.7b").replace(dtype="float32")
    tparams = weights.from_jax_params(jax.device_get(jparams), tcfg, "cpu")
    yield jcfg, jparams, tcfg, tparams
    jax.config.update("jax_threefry_partitionable", old)


def instance_stream(inst, rid, prompt, n_new, sp=None):
    inst.set_sampling(rid, sp)
    inst.run_prefill(rid, prompt)
    inst.local.start_local_decode(rid, len(prompt), n_new - 1)
    for _ in range(n_new - 1):
        inst.run_decode_iteration([rid])
    return [int(t) for t in inst.generated[rid][:n_new]]


def _cluster_streams(cls, req_cls, slo_cls, cfg, params, **kw):
    """5 requests of 8-39 tokens in 16-token chunks (the mirror of the
    JAX fused-vs-legacy cluster test)."""
    rng = np.random.default_rng(21)
    reqs = [(rng.integers(1, cfg.vocab_size, size=int(rng.integers(8, 40)))
             .astype(np.int32), int(rng.integers(2, 6))) for _ in range(5)]
    cluster = cls(cfg, n_instances=2, n_prefill=1, n_slots=4, capacity=128,
                  slo=slo_cls(ttft=5.0, tpot=2.0), params=params,
                  chunk_tokens=16, **kw)
    handles = [cluster.submit(req_cls(rid=i, arrival=0.0, input_len=len(p),
                                      output_len=n), prompt=p)
               for i, (p, n) in enumerate(reqs)]
    report = cluster.drain(timeout=300.0)
    assert report.n_finished == 5
    return {h.rid: [int(t) for t in h.tokens] for h in handles}


def test_fused_cluster_matches_jax_legacy_cluster(setup):
    jcfg, jparams, tcfg, tparams = setup
    fused = _cluster_streams(ArrowEngineCluster, Request, SLO, tcfg,
                             tparams, device="cpu")
    jlegacy = _cluster_streams(JCluster, JRequest, JSLO, jcfg, jparams,
                               step_mode="legacy")
    assert fused == jlegacy


@pytest.mark.parametrize("impl", ["reference", "hopper"])
def test_fused_sampled_stream_matches_jax_legacy_instance(setup, impl):
    jcfg, jparams, tcfg, tparams = setup
    cfg = tcfg.replace(attn_impl=impl)
    prompt = np.random.default_rng(123).integers(
        1, cfg.vocab_size, size=27).astype(np.int32)
    sp = SamplingParams(temperature=0.9, top_p=0.8, seed=3)
    fused = instance_stream(EngineInstance(0, cfg, tparams, n_slots=4,
                                           capacity=128, device="cpu"),
                            9, prompt, 10, sp=sp)
    jlegacy = instance_stream(
        JInstance(1, jcfg, jparams, n_slots=4, capacity=128,
                  step_mode="legacy"), 9, prompt, 10,
        sp=JSamplingParams(temperature=0.9, top_p=0.8, seed=3))
    assert fused == jlegacy


@pytest.mark.parametrize("impl", ["reference", "hopper"])
def test_fused_chunks_continue_the_stream(setup, impl):
    """A 40-token prompt prefilled in fused chunks of 16 and 24 (the first
    chunk's pad positions invalidated on the device) leaves the slot the
    whole-prompt prefill leaves, and the sampled stream goes on as the
    whole-prompt instance's."""
    _, _, tcfg, tparams = setup
    cfg = tcfg.replace(attn_impl=impl)
    prompt = np.random.default_rng(9).integers(
        1, cfg.vocab_size, size=40).astype(np.int32)
    sp = SamplingParams(temperature=0.8, top_p=0.9, seed=5)
    want = instance_stream(EngineInstance(0, cfg, tparams, n_slots=4,
                                          capacity=128, device="cpu"),
                           1, prompt, 8, sp=sp)
    inst = EngineInstance(0, cfg, tparams, n_slots=4, capacity=128,
                          device="cpu")
    inst.set_sampling(1, sp)
    assert inst.run_prefill_chunk(1, prompt[:16], 0, 40) is None
    row = inst.kv.pos_map[inst.kv.slot_of[1]]
    assert torch.equal(row[:16], torch.arange(16, dtype=torch.int32))
    assert bool((row[16:] == -1).all())
    first = inst.run_prefill_chunk(1, prompt[16:], 16, 40)
    assert inst.kv.len_of[1] == 40
    inst.local.start_local_decode(1, 40, 7)
    got = [first] + [inst.run_decode_iteration([1])[1] for _ in range(7)]
    assert got == want


def test_cluster_refuses_other_step_modes(setup):
    _, _, tcfg, tparams = setup
    with pytest.raises(ValueError, match="step_mode"):
        ArrowEngineCluster(tcfg, params=tparams, step_mode="legacy",
                           device="cpu")
