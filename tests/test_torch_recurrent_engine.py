"""Engine parity of the PyTorch port's constant-state families on the CPU
(``device="cpu"``): Mamba-2 (mamba2-370m smoke, ``SSMStateSlots``) and
RecurrentGemma (recurrentgemma-9b smoke, ``RecurrentStateSlots``).

With the JAX parameters of ``PRNGKey(7)`` carried across by the weight
bridge, the port's ``EngineInstance`` gives the JAX instance's greedy and
seeded sampled streams on both paths (port ``hopper`` against JAX
``pallas`` in interpret mode, whose chunk lengths here stay within what the
JAX ``rglru_scan`` tiles accept); chunked prefill and migration continue a
stream exactly; a JAX payload imports into a torch instance under the same
CRC and continues its stream; the payload does not grow with context; a
parked slot's state is bit for bit untouched by a decode step it sat out;
``release`` zeroes a slot and ``copy_prefix`` takes whole contexts only; an
``ArrowEngineCluster`` run gives the JAX cluster's streams and migration
log; and the launcher serves both archs. Token ids are compared exactly.

The JAX side runs in the non-partitionable threefry mode the golden pins
were recorded under (set by a fixture and restored afterwards).
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
from repro.engine.instance import state_checksum as jax_checksum  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import SLO, Request, SamplingParams  # noqa: E402
from repro_torch.engine import ArrowEngineCluster, EngineInstance  # noqa: E402
from repro_torch.engine.instance import state_checksum  # noqa: E402
from repro_torch.engine.state_slots import (RecurrentStateSlots,  # noqa: E402
                                            SSMStateSlots)

ARCHS = ["mamba2-370m", "recurrentgemma-9b"]
SLOTS = {"mamba2-370m": SSMStateSlots,
         "recurrentgemma-9b": RecurrentStateSlots}
SAMPLED = (0.8, 0.9, 21)                   # temperature, top_p, seed


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    jcfg = jax_smoke(request.param)
    jparams = build_model(jcfg).init(jax.random.PRNGKey(7))
    tcfg = get_smoke_config(request.param)
    tparams = weights.from_jax_params(jax.device_get(jparams), tcfg, "cpu")
    yield jcfg, jparams, tcfg, tparams
    jax.config.update("jax_threefry_partitionable", old)


def prompt_of(n, vocab, seed):
    return np.random.default_rng(seed).integers(1, vocab, size=n) \
        .astype(np.int32)


def instance_stream(inst, rid, prompt, n_new, sp=None):
    inst.set_sampling(rid, sp)
    inst.run_prefill(rid, prompt)
    inst.local.start_local_decode(rid, len(prompt), n_new - 1)
    for _ in range(n_new - 1):
        inst.run_decode_iteration([rid])
    return [int(t) for t in inst.generated[rid][:n_new]]


def torch_instance(tcfg, tparams, impl="reference", iid=0):
    return EngineInstance(iid, tcfg.replace(attn_impl=impl), tparams,
                          n_slots=4, capacity=128, device="cpu")


def state_rows(inst, slot):
    """Copies of every slab row of ``slot`` (payload order)."""
    return [a.select(axis, slot).clone() for a, axis in inst.kv._leaves()]


@pytest.mark.parametrize("impl", [("reference", "reference"),
                                  ("hopper", "pallas")], ids=lambda i: i[0])
def test_instance_streams_match_jax(setup, impl):
    """Greedy and sampled streams of two prompts (one of them 70 tokens,
    a 96-token bucket) equal the JAX instance's, id for id."""
    jcfg, jparams, tcfg, tparams = setup
    j = JInstance(0, jcfg.replace(attn_impl=impl[1]), jparams, n_slots=4,
                  capacity=128)
    t = torch_instance(tcfg, tparams, impl[0])
    for rid, n in ((3, 23), (4, 70)):
        prompt = prompt_of(n, tcfg.vocab_size, rid)
        for sp, jsp in ((None, None), (SamplingParams(*SAMPLED),
                                       JSamplingParams(*SAMPLED))):
            assert instance_stream(t, rid, prompt, 8, sp) == \
                instance_stream(j, rid, prompt, 8, jsp), (rid, sp)
            t.drop(rid)
            j.drop(rid)


def test_chunked_prefill_and_migration_continue_the_stream(setup):
    """A 40-token prompt prefilled as chunks of 16 and 24 — and a stream
    exported mid-decode into another instance — emit the whole-prompt
    stream."""
    _, _, tcfg, tparams = setup
    prompt = prompt_of(40, tcfg.vocab_size, 9)
    sp = SamplingParams(*SAMPLED)
    a = torch_instance(tcfg, tparams)
    want = instance_stream(a, 1, prompt, 8, sp)
    a.drop(1)

    a.set_sampling(1, sp)
    assert a.run_prefill_chunk(1, prompt[:16], 0, 40) is None
    got = [a.run_prefill_chunk(1, prompt[16:], 16, 40)]
    a.local.start_local_decode(1, 40, 7)
    for _ in range(3):
        got.append(a.run_decode_iteration([1])[1])
    payload, L, last, gen, _ = a.export_state(1)
    assert L == 43
    b = torch_instance(tcfg, tparams, iid=1)
    assert b.import_state(1, payload, L, last, gen,
                          sampling=a.kv.samp_of[1],
                          checksum=state_checksum(payload))
    a.drop(1)
    b.local.start_local_decode(1, L, 4)
    for _ in range(4):
        got.append(b.run_decode_iteration([1])[1])
    assert got == want


def test_jax_payload_imports_into_torch(setup):
    """A JAX instance's exported recurrent state has the same CRC through
    the port's state_checksum and continues its stream on a torch
    instance token for token."""
    jcfg, jparams, tcfg, tparams = setup
    jsp = JSamplingParams(*SAMPLED)
    prompt = prompt_of(30, tcfg.vocab_size, 4)
    ref = instance_stream(JInstance(0, jcfg, jparams, n_slots=4,
                                    capacity=128), 7, prompt, 9, jsp)
    src = JInstance(1, jcfg, jparams, n_slots=4, capacity=128)
    got = instance_stream(src, 7, prompt, 4, jsp)
    payload, L, last, gen = src.export_state(7)
    crc = jax_checksum(payload)
    tpayload = [torch.from_numpy(np.array(p)) for p in payload]
    assert state_checksum(tpayload) == crc
    dst = torch_instance(tcfg, tparams, iid=2)
    assert dst.import_state(7, tpayload, L, last, gen, sampling=SAMPLED,
                            checksum=crc)
    dst.local.start_local_decode(7, L, 5)
    for _ in range(5):
        got.append(dst.run_decode_iteration([7])[7])
    assert got == ref
    tp, *_ = dst.export_state(7)
    assert [p.dtype for p in tp] == [torch.as_tensor(p).dtype
                                     for p in tpayload]
    assert state_checksum(tp) == jax_checksum([p.numpy() for p in tp])


def test_payload_bytes_do_not_grow_with_context(setup):
    _, _, tcfg, tparams = setup
    inst = torch_instance(tcfg, tparams)
    assert isinstance(inst.kv, SLOTS[tcfg.arch_id])
    assert not inst.kv.supports_speculation
    assert inst.kv.prefix_reuse == "exact"

    def wire_bytes(rid, n):
        instance_stream(inst, rid, prompt_of(n, tcfg.vocab_size, rid), 3)
        payload, L, *_ = inst.export_state(rid)
        assert L == n + 2
        assert inst.kv.state_bytes(rid) == sum(p.nbytes for p in payload)
        inst.drop(rid)
        return sum(p.nbytes for p in payload)

    assert wire_bytes(1, 8) == wire_bytes(2, 80) > 0


def test_parked_slot_is_untouched_by_decode(setup):
    """Two residents, one decodes: the other's state rows (and a free
    slot's zeros) are bit for bit what they were."""
    _, _, tcfg, tparams = setup
    inst = torch_instance(tcfg, tparams)
    for rid in (1, 2):
        inst.run_prefill(rid, prompt_of(20 + rid, tcfg.vocab_size, rid))
        inst.local.start_local_decode(rid, 20 + rid, 4)
    active, parked = inst.kv.slot_of[1], inst.kv.slot_of[2]
    free = inst.kv.free[0]
    before = {s: state_rows(inst, s) for s in (active, parked, free)}
    for _ in range(2):
        inst.run_decode_iteration([1])
    for s in (parked, free):
        for a, b in zip(state_rows(inst, s), before[s]):
            assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in
               zip(state_rows(inst, active), before[active]))


def test_release_zeroes_and_copy_prefix_is_exact(setup):
    _, _, tcfg, tparams = setup
    inst = torch_instance(tcfg, tparams)
    prompt = prompt_of(24, tcfg.vocab_size, 5)
    inst.run_prefill(1, prompt)
    inst.alloc_slot(2)
    with pytest.raises(ValueError):
        inst.kv.copy_prefix(1, 2, 16)              # not the whole context
    inst.kv.copy_prefix(1, 2, 24)
    for a, b in zip(state_rows(inst, inst.kv.slot_of[2]),
                    state_rows(inst, inst.kv.slot_of[1])):
        assert torch.equal(a, b)
    slot = inst.kv.slot_of[1]
    inst.drop(1)
    for (a, axis), row in zip(inst.kv._leaves(), state_rows(inst, slot)):
        fill = -1 if a.dtype == torch.int32 else 0
        assert torch.all(row == fill)


def test_speculation_is_pinned_off(setup):
    _, _, tcfg, tparams = setup
    inst = EngineInstance(0, tcfg, tparams, n_slots=2, capacity=64,
                          device="cpu", speculate=2)
    assert inst.speculate == 0


def _cluster_run(cls, req_cls, slo_cls, sp, cfg, params, **kw):
    """4 requests of 20 tokens, 8 outputs, prefill on instance 0, as
    tests/test_torch_engine.py's dense cluster run."""
    cluster = cls(cfg, n_instances=2, n_prefill=1, n_slots=4, capacity=128,
                  slo=slo_cls(5.0, 2.0), params=params, seed=42, **kw)
    rng = np.random.default_rng(5)
    prompts = {i: rng.integers(1, cfg.vocab_size, size=20).astype(np.int32)
               for i in range(4)}
    handles = [cluster.submit(req_cls(rid=i, arrival=0.0, input_len=20,
                                      output_len=8, sampling=sp),
                              prompt=prompts[i]) for i in range(4)]
    report = cluster.drain(timeout=300.0)
    assert report.n_finished == 4
    streams = {h.rid: [int(t) for t in h.tokens] for h in handles}
    log = sorted(cluster.migration_log, key=lambda m: m["rid"])
    return streams, log


def test_cluster_matches_jax_cluster(setup):
    """Same params, prompts, seed and sampling: the torch cluster's streams
    and migration log (rid, context tokens, wire bytes) equal the JAX
    cluster's."""
    jcfg, jparams, tcfg, tparams = setup
    jstreams, jlog = _cluster_run(
        JCluster, JRequest, JSLO, JSamplingParams(temperature=0.8, top_p=0.9),
        jcfg, jparams)
    tstreams, tlog = _cluster_run(
        ArrowEngineCluster, Request, SLO,
        SamplingParams(temperature=0.8, top_p=0.9), tcfg, tparams,
        device="cpu")
    assert tstreams == jstreams
    assert len(tlog) >= 1
    assert tlog == jlog


def test_launcher_serves_on_cpu(setup, capsys):
    from repro_torch.launch import serve
    _, _, tcfg, _ = setup
    report = serve.run_engine(serve.build_parser().parse_args(
        ["--mode", "engine", "--arch", tcfg.arch_id, "--device", "cpu",
         "--attn-impl", "hopper", "--requests", "3"]))
    assert report.n_finished == 3
    assert "finished 3/3" in capsys.readouterr().out
