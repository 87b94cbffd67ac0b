"""Self-speculative decoding in the PyTorch port, on the CPU
(``device="cpu"``), against the port's own sequential decode and against the
JAX engine's speculative decoding.

With the JAX parameters of ``PRNGKey(7)`` carried across by the weight
bridge (float32 on both sides), a speculative ``EngineInstance`` emits its
sequential stream and the JAX speculative stream id for id, greedy and
sampled, on both attention paths; a speculative ``ArrowEngineCluster`` gives
the JAX cluster's streams and the same ``rep.speculation`` counters. A
parked slot at length C-1 keeps its K/V bytes and ``pos_map`` row bit for
bit across a round; a step in which a row lacks room for k+1 positions
falls back to plain decode; ``draft_layers`` must truncate the model.

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

SAMPLED = {"greedy": None, "sampled": (0.8, 0.9, 21)}


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


def prompt_of(n, vocab, seed):
    return np.random.default_rng(seed).integers(1, vocab, size=n) \
        .astype(np.int32)


def stream(inst, rid, prompt, n_new, sp=None):
    """Prefill, then dispatch/finalize decode steps (speculative rounds
    where the instance speculates) until ``n_new`` tokens exist."""
    inst.set_sampling(rid, sp)
    inst.run_prefill(rid, prompt)
    inst.local.start_local_decode(rid, len(prompt), n_new - 1)
    while len(inst.generated[rid]) < n_new:
        inst.finalize_step(inst.dispatch_step([rid], []))
    return [int(t) for t in inst.generated[rid][:n_new]]


@pytest.mark.parametrize("samp", sorted(SAMPLED))
@pytest.mark.parametrize("k,draft", [(4, None), (3, 1)])
@pytest.mark.parametrize("impl", ["reference", "hopper"])
def test_instance_streams_equal_sequential_and_jax(setup, impl, k, draft,
                                                   samp):
    jcfg, jparams, tcfg, tparams = setup
    cfg = tcfg.replace(attn_impl=impl)
    sp = jsp = None
    if SAMPLED[samp]:
        sp = SamplingParams(*SAMPLED[samp])
        jsp = JSamplingParams(*SAMPLED[samp])
    prompt = prompt_of(20, cfg.vocab_size, 1)

    def make(**kw):
        return EngineInstance(0, cfg, tparams, n_slots=4, capacity=128,
                              device="cpu", **kw)

    seq = stream(make(), 5, prompt, 14, sp)
    spec_inst = make(speculate=k, draft_layers=draft)
    assert spec_inst.draft_layers == 1
    spec = stream(spec_inst, 5, prompt, 14, sp)
    jspec = stream(JInstance(0, jcfg, jparams, n_slots=4, capacity=128,
                             speculate=k, draft_layers=draft),
                   5, prompt, 14, jsp)
    assert spec == seq
    assert spec == jspec


def _cluster_run(cls, req_cls, slo_cls, sp, cfg, params, **kw):
    """Mirror of tests/test_sampling.py's cluster_streams: 4 requests of 20
    tokens, 12 outputs, prefill on instance 0."""
    cluster = cls(cfg, n_instances=2, n_prefill=1, n_slots=4, capacity=128,
                  slo=slo_cls(5.0, 2.0), params=params, seed=4, **kw)
    rng = np.random.default_rng(5)
    prompts = {i: rng.integers(1, cfg.vocab_size, size=20).astype(np.int32)
               for i in range(4)}
    handles = [cluster.submit(req_cls(rid=i, arrival=0.0, input_len=20,
                                      output_len=12, sampling=sp),
                              prompt=prompts[i]) for i in range(4)]
    report = cluster.drain(timeout=300.0)
    assert report.n_finished == 4
    return {h.rid: [int(t) for t in h.tokens] for h in handles}, report


def test_cluster_matches_sequential_and_jax(setup):
    """Speculation changes throughput, never content: the speculative
    cluster's sampled streams equal the sequential cluster's and the JAX
    speculative cluster's, and its speculation counters equal JAX's."""
    jcfg, jparams, tcfg, tparams = setup
    base, rep0 = _cluster_run(ArrowEngineCluster, Request, SLO,
                              SamplingParams(0.8, 0.9), tcfg, tparams,
                              device="cpu")
    spec, rep = _cluster_run(ArrowEngineCluster, Request, SLO,
                             SamplingParams(0.8, 0.9), tcfg, tparams,
                             device="cpu", speculate=4)
    jspec, jrep = _cluster_run(JCluster, JRequest, JSLO,
                               JSamplingParams(0.8, 0.9), jcfg, jparams,
                               speculate=4)
    assert spec == base
    assert spec == jspec
    assert rep0.speculation == {}
    assert rep.speculation["rounds"] > 0
    # some drafts are rejected, so the rollback path ran
    assert rep.speculation["accepted"] < rep.speculation["drafted"]
    assert rep.speculation == jrep.speculation


def test_parked_slot_untouched_by_a_round(setup):
    """A parked slot at length C-1 (not decoding this step) keeps its K/V
    bytes and pos_map row bit for bit across a speculative round, though
    the draft's batched decode writes every row."""
    _, _, tcfg, tparams = setup
    C = 64
    inst = EngineInstance(0, tcfg, tparams, n_slots=4, capacity=C,
                          device="cpu", speculate=4)
    inst.run_prefill(1, prompt_of(C - 1, tcfg.vocab_size, 2))
    inst.run_prefill(2, prompt_of(20, tcfg.vocab_size, 3))
    inst.local.start_local_decode(2, 20, 10)
    s = inst.kv.slot_of[1]
    # the bytes at the free position C-1 are no one's: mark them, so a
    # draft write there (token 0 at C-1, as the prefill's pad) shows
    inst.kv.k[:, s, C - 1] = 3.0
    inst.kv.v[:, s, C - 1] = -3.0
    before = [t[:, s].clone() for t in (inst.kv.k, inst.kv.v)] \
        + [inst.kv.pos_map[s].clone()]
    pending = inst.dispatch_step([2], [])
    assert pending.spec is not None
    out, _ = inst.finalize_step(pending)
    assert isinstance(out[2], list) and len(out[2]) >= 1
    after = [t[:, s] for t in (inst.kv.k, inst.kv.v)] \
        + [inst.kv.pos_map[s]]
    for b, a in zip(before, after):
        assert torch.equal(b, a)
    # the active row's valid context is exactly [0, its new length)
    s2, L2 = inst.kv.slot_of[2], inst.kv.len_of[2]
    row = inst.kv.pos_map[s2]
    assert torch.equal(row[:L2], torch.arange(L2, dtype=torch.int32))
    assert bool((row[L2:] == -1).all())


def test_falls_back_to_plain_decode_without_room(setup):
    """A step in which a decoding row lacks room for k+1 positions is a
    plain decode step (one token, no packed array), and the stream still
    equals sequential decode."""
    _, _, tcfg, tparams = setup
    C, k = 64, 4
    prompt = prompt_of(C - k - 1, tcfg.vocab_size, 4)       # room for one
    sp = SamplingParams(*SAMPLED["sampled"])
    seq = stream(EngineInstance(0, tcfg, tparams, n_slots=2, capacity=C,
                                device="cpu"), 3, prompt, 5, sp)
    inst = EngineInstance(0, tcfg, tparams, n_slots=2, capacity=C,
                          device="cpu", speculate=k)
    inst.set_sampling(3, sp)
    inst.run_prefill(3, prompt)
    inst.local.start_local_decode(3, len(prompt), 4)
    pending = inst.dispatch_step([3], [])             # len + k + 1 == C
    assert pending.spec is not None
    out, _ = inst.finalize_step(pending)
    assert isinstance(out[3], list)
    while len(inst.generated[3]) < 5:
        pending = inst.dispatch_step([3], [])         # len + k + 1 > C
        assert pending.spec is None
        out, _ = inst.finalize_step(pending)
        assert isinstance(out[3], int)
    assert inst.generated[3][:5] == seq


def test_draft_layers_must_truncate_the_model(setup):
    _, _, tcfg, tparams = setup
    with pytest.raises(ValueError, match="draft_layers"):
        EngineInstance(0, tcfg, tparams, device="cpu", speculate=2,
                       draft_layers=tcfg.n_layers)
    inst = EngineInstance(0, tcfg, tparams, device="cpu", speculate=2)
    assert inst.speculate == 2
    assert inst.draft_layers == max(1, tcfg.n_layers // 2)


def test_launcher_serves_speculatively_on_cpu(capsys):
    from repro_torch.launch import serve
    report = serve.run_engine(serve.build_parser().parse_args(
        ["--device", "cpu", "--speculate", "4", "--requests", "6"]))
    assert report.n_finished == 6
    assert report.speculation["rounds"] > 0
    assert "spec_accept=" in capsys.readouterr().out
