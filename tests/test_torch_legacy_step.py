"""The legacy (pre-fusion) step mode of the PyTorch port, on the CPU
(``device="cpu"``), against the port's fused step and the JAX engine's
legacy mode.

With the JAX parameters of ``PRNGKey(7)`` carried across by the weight
bridge (float32 on both sides): legacy and fused clusters give the same
greedy streams over chunked prefill (the mirror of
``tests/test_engine.py::test_fused_step_matches_legacy_streams``), equal to
the JAX legacy cluster's; legacy and fused instances give the same sampled
stream (the mirror of
``tests/test_sampling.py::test_fused_vs_legacy_sampled_streams``), equal to
the JAX legacy instance's, on both attention paths. Legacy is refused for
the ssm and hybrid families, and an unknown step mode is refused.

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


def _cluster_streams(cls, req_cls, slo_cls, cfg, params, mode, **kw):
    """5 requests of 8-39 tokens in 16-token chunks (the mirror of the
    JAX fused-vs-legacy cluster test)."""
    rng = np.random.default_rng(21)
    reqs = [(rng.integers(1, cfg.vocab_size, size=int(rng.integers(8, 40)))
             .astype(np.int32), int(rng.integers(2, 6))) for _ in range(5)]
    cluster = cls(cfg, n_instances=2, n_prefill=1, n_slots=4, capacity=128,
                  slo=slo_cls(ttft=5.0, tpot=2.0), params=params,
                  chunk_tokens=16, step_mode=mode, **kw)
    handles = [cluster.submit(req_cls(rid=i, arrival=0.0, input_len=len(p),
                                      output_len=n), prompt=p)
               for i, (p, n) in enumerate(reqs)]
    report = cluster.drain(timeout=300.0)
    assert report.n_finished == 5
    return {h.rid: [int(t) for t in h.tokens] for h in handles}


def test_legacy_cluster_matches_fused_and_jax(setup):
    jcfg, jparams, tcfg, tparams = setup
    legacy = _cluster_streams(ArrowEngineCluster, Request, SLO, tcfg,
                              tparams, "legacy", device="cpu")
    fused = _cluster_streams(ArrowEngineCluster, Request, SLO, tcfg,
                             tparams, "fused", device="cpu")
    jlegacy = _cluster_streams(JCluster, JRequest, JSLO, jcfg, jparams,
                               "legacy")
    assert legacy == fused
    assert legacy == jlegacy


@pytest.mark.parametrize("impl", ["reference", "hopper"])
def test_legacy_sampled_stream_matches_fused_and_jax(setup, impl):
    jcfg, jparams, tcfg, tparams = setup
    cfg = tcfg.replace(attn_impl=impl)
    prompt = np.random.default_rng(123).integers(
        1, cfg.vocab_size, size=27).astype(np.int32)
    sp = SamplingParams(temperature=0.9, top_p=0.8, seed=3)
    fused = instance_stream(EngineInstance(0, cfg, tparams, n_slots=4,
                                           capacity=128, device="cpu"),
                            9, prompt, 10, sp=sp)
    legacy = instance_stream(EngineInstance(1, cfg, tparams, n_slots=4,
                                            capacity=128, device="cpu",
                                            step_mode="legacy"),
                             9, prompt, 10, sp=sp)
    jlegacy = instance_stream(
        JInstance(1, jcfg, jparams, n_slots=4, capacity=128,
                  step_mode="legacy"), 9, prompt, 10,
        sp=JSamplingParams(temperature=0.9, top_p=0.8, seed=3))
    assert legacy == fused
    assert legacy == jlegacy


@pytest.mark.parametrize("impl", ["reference", "hopper"])
def test_legacy_chunks_continue_the_stream(setup, impl):
    """A 40-token prompt prefilled in legacy chunks of 16 and 24 (pad
    positions invalidated through the host pos_map round trip) leaves the
    slot the whole-prompt prefill leaves, and the sampled stream goes on
    as the fused instance's."""
    _, _, tcfg, tparams = setup
    cfg = tcfg.replace(attn_impl=impl)
    prompt = np.random.default_rng(9).integers(
        1, cfg.vocab_size, size=40).astype(np.int32)
    sp = SamplingParams(temperature=0.8, top_p=0.9, seed=5)
    want = instance_stream(EngineInstance(0, cfg, tparams, n_slots=4,
                                          capacity=128, device="cpu"),
                           1, prompt, 8, sp=sp)
    inst = EngineInstance(0, cfg, tparams, n_slots=4, capacity=128,
                          device="cpu", step_mode="legacy")
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


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_legacy_is_refused_for_recurrent_families(arch):
    cfg = get_smoke_config(arch)
    with pytest.raises(ValueError, match=cfg.family):
        EngineInstance(0, cfg, None, device="cpu", step_mode="legacy")


def test_unknown_step_mode_is_refused(setup):
    _, _, tcfg, tparams = setup
    with pytest.raises(ValueError, match="step_mode"):
        EngineInstance(0, tcfg, tparams, device="cpu", step_mode="eager")
