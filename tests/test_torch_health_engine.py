"""The self-healing layer (transfer checksum, the retry ladder and its
exhaustion, quarantine, SLO-aware preemption) and the async-step schedules
with crashes and retirements, on the port's engine, held against the JAX
engine on the CPU.

Each test is the counterpart of a JAX engine test (named in its
docstring) and asserts what it asserts, on the port's simulator and engine
where the JAX test compares the JAX ones, and equality with the JAX engine's
run: token ids exactly, health counters, victims and quarantine ticks with
``==``. The async-step property keeps the JAX test's ``max_examples=5`` and
replays the JAX corpus ``tests/corpus/async_step_regressions.json``
read-only: a failing drawn schedule is reported, not written there.
"""
import json
import pathlib
import time
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hyp_compat import corpus_backed, given, settings, st  # noqa: E402
from invariants import check_invariants as jax_check_invariants  # noqa: E402
from test_torch_runtime_engine import (SIM_CFG, J, T,  # noqa: E402,F401
                                       both, check_invariants, clusters,
                                       decided, prompts_of, reference_stream,
                                       setup, tokens)

from repro_torch.core.serving import replay_trace  # noqa: E402
from repro_torch.engine import instance as inst_mod  # noqa: E402
from repro_torch.engine.instance import (CorruptPayload,  # noqa: E402
                                         EngineInstance, state_checksum)
from repro_torch.sim import Simulator  # noqa: E402

ASYNC_CORPUS = pathlib.Path(__file__).parent / "corpus" / \
    "async_step_regressions.json"


def engine_barrier(system, handles):
    """tests/test_health.py's barrier: every request decodes on instance 1
    with 2 <= tokens < output_len."""
    for _ in range(100000):
        if all(h.req.state.name == "DECODING"
               and h.req.decode_instance == 1
               and 2 <= len(h.tokens) < h.req.output_len for h in handles):
            return
        assert system.step(), "drained before the mid-decode barrier"


def feed_intervals(system, t, victim, slow=0.060, fast=0.006):
    """One synthetic TPOT sample per ACTIVE instance, then a monitor tick."""
    for iid in system.pools.active_ids():
        system.monitor.record_iteration(iid, t, 1,
                                        slow if iid == victim else fast)
    system.collect_stats(t)


# ------------------------------------------------- transfer integrity (§14)


def test_import_rejects_corrupt_payload_before_alloc(setup):
    """tests/test_health.py::test_engine_import_rejects_corrupt_payload_pre_
    alloc: a payload with a flipped byte raises ``CorruptPayload`` before a
    slot is taken, and the pristine payload then lands; the importer goes
    on decoding the JAX importer's tokens."""
    jcfg, jparams, tcfg, tparams = setup
    from repro.engine.instance import CorruptPayload as JCorrupt
    from repro.engine.instance import EngineInstance as JInstance
    from repro.engine.instance import state_checksum as jchecksum
    prompt = np.arange(1, 25, dtype=np.int32)
    got = {}
    for key, make, corrupt, crc, err in (
            ("jax", lambda i: JInstance(i, jcfg, jparams, n_slots=2,
                                        capacity=128),
             lambda p: [np.array(np.asarray(x), copy=True) for x in p],
             jchecksum, JCorrupt),
            ("port", lambda i: EngineInstance(i, tcfg, tparams, n_slots=2,
                                              capacity=128, device="cpu"),
             lambda p: [x.clone() for x in p], state_checksum,
             CorruptPayload)):
        a, b = make(0), make(1)
        a.run_prefill(7, prompt)
        a.local.start_local_decode(7, len(prompt), 4)
        a.run_decode_iteration([7])
        payload, L, last, gen = a.export_state(7)[:4]
        good = crc(payload)
        wire = corrupt(payload)
        flat = (wire[0].view(np.uint8).reshape(-1) if key == "jax"
                else wire[0].view(torch.uint8).view(-1))
        flat[0] ^= 0xFF
        with pytest.raises(err):
            b.import_state(7, wire, L, last, list(gen), checksum=good)
        assert 7 not in b.kv.slot_of
        assert b.import_state(7, payload, L, last, list(gen), checksum=good)
        assert 7 in b.kv.slot_of
        b.local.start_local_decode(7, L, 3)
        got[key] = [int(b.run_decode_iteration([7])[7]) for _ in range(3)]
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_export_checksum_guards_the_import(arch):
    """The checksum ``export_state`` hands over, taken on the slots' own
    image of the state (k then v stacked for the dense slots, every slab
    row's bytes in one tensor for the fixed-state ones), is ``state_checksum``
    of the host payload it exports and zlib's over its bytes; a byte
    flipped in any of the payload's tensors still raises
    ``CorruptPayload`` with no slot taken, and the pristine payload lands
    with the same image; on the CPU the crc32 kernel never launches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import crc32_op
    from repro_torch.weights import init_params
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    a, b = (EngineInstance(i, cfg, params, n_slots=2, capacity=64,
                           device="cpu") for i in (0, 1))
    before = crc32_op.launches
    prompt = np.arange(1, 25, dtype=np.int32)
    a.run_prefill(7, prompt)
    a.local.start_local_decode(7, len(prompt), 4)
    a.run_decode_iteration([7])
    payload, L, last, gen, crc = a.export_state(7)
    assert crc == state_checksum(payload) == zlib.crc32(b"".join(
        p.contiguous().view(torch.uint8).numpy().tobytes()
        for p in payload))
    for i, p in enumerate(payload):
        if not p.numel():
            continue
        wire = [q.clone() for q in payload]
        wire[i].view(torch.uint8).view(-1)[-1] ^= 0x01
        with pytest.raises(CorruptPayload):
            b.import_state(7, wire, L, last, list(gen), checksum=crc)
        assert 7 not in b.kv.slot_of and len(b.kv.free) == 2
    assert b.import_state(7, payload, L, last, list(gen), checksum=crc)
    assert 7 in b.kv.slot_of
    assert b.export_state(7)[4] == crc
    assert crc32_op.launches == before


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_one_checksum_a_side_of_each_attempt(arch, monkeypatch):
    """A transfer attempt checksums one image at export and one at import,
    whatever the number of payload tensors, each over the payload's whole
    wire size; an import without a checksum uploads nothing before a slot
    is found, so one that finds none costs no upload."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.engine import instance
    from repro_torch.weights import init_params
    sizes, images = [], []

    def counted(t, crc=0):
        sizes.append(t.nbytes)
        return instance.crc32_op.__wrapped__(t, crc)

    def image(parts, device):
        images.append(len(parts))
        return byte_image(parts, device)

    counted.__wrapped__ = instance.crc32_op
    byte_image = instance.byte_image
    monkeypatch.setattr(instance, "crc32_op", counted)
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    a, b = (EngineInstance(i, cfg, params, n_slots=2, capacity=64,
                           device="cpu") for i in (0, 1))
    a.run_prefill(7, np.arange(1, 25, dtype=np.int32))
    payload, L, last, gen, crc = a.export_state(7)
    wire = sum(p.nbytes for p in payload)
    assert sizes == [wire]
    bad = [p.clone() for p in payload]
    bad[-1].view(torch.uint8).view(-1)[0] ^= 0xFF
    with pytest.raises(CorruptPayload):
        b.import_state(7, bad, L, last, list(gen), checksum=crc)
    assert b.import_state(7, payload, L, last, list(gen), checksum=crc)
    assert sizes == [wire] * 3
    monkeypatch.setattr(instance, "byte_image", image)
    assert b.import_state(8, payload, L, last, list(gen))
    assert not b.import_state(9, payload, L, last, list(gen))
    assert images == [] and sizes == [wire] * 3
    assert torch.equal(b.kv.state_image(7)[0], a.kv.state_image(7)[0])


@pytest.mark.parametrize("order", [0, 1])
def test_byte_image_round_trip(order):
    """``byte_image`` lays tensors' bytes back to back in one uint8 tensor
    (a strided one in memory order) and ``split_image`` gives them back as
    views of it; empty and 0-dim tensors take their place."""
    from repro_torch.engine.state_slots import byte_image, split_image
    g = torch.Generator().manual_seed(5)
    parts = [torch.randn(3, 6, generator=g).to(torch.bfloat16),
             torch.randn(2, 4, generator=g),
             torch.tensor(7, dtype=torch.int32),
             torch.empty(0, 3, dtype=torch.uint8),
             torch.randn(4, 2, generator=g).t()]
    if order:
        parts = parts[::-1]
    image = byte_image(parts, "cpu")
    assert image.dtype == torch.uint8 and image.is_contiguous()
    assert image.numpy().tobytes() == b"".join(
        p.reshape(-1).view(torch.uint8).numpy().tobytes() for p in parts)
    out = split_image(image, [(p.shape, p.dtype) for p in parts])
    off = 0
    for p, q in zip(parts, out):
        assert q.shape == p.shape and q.dtype == p.dtype
        assert torch.equal(q, p)
        if p.numel():
            assert q.data_ptr() == image.data_ptr() + off
        off += p.nbytes


def test_quarantine_parity(setup):
    """tests/test_health.py::test_sim_engine_quarantine_parity: the same
    synthetic TPOT samples at the state barrier quarantine instance 1 on
    the same tick on the port's simulator, the port's engine and the JAX
    engine; after restore each counts one quarantine, and the evacuated
    streams are the fault-free ones, id for id the JAX engine's."""
    _, _, tcfg, tparams = setup
    prompts = prompts_of(tcfg, 3, 3, 24)

    def quarantine_tick(system, pkg):
        for i in system.pools.all_ids():
            system.monitor.reset_intervals(i)
        for k in range(1, 60):
            feed_intervals(system, 0.1 * k, victim=1)
            if system.pools.lifecycle_of(1) is pkg.Lifecycle.DEGRADED:
                return k
        return None

    def settle(system, pkg):
        system.health_monitor.cfg = pkg.HealthConfig(
            straggler_factor=1e9, clear_factor=1e8, probation_s=0.2,
            deadline_s=1e9)

    hc = both(lambda p: p.HealthConfig(probation_s=0.2, deadline_s=1e9))
    sim = Simulator(SIM_CFG, n_instances=4, n_prefill=1, policy="arrow",
                    slo=T.SLO(5.0, 2.0), health=hc[1])
    h_sim = replay_trace(sim, [T.Request(rid=i, arrival=0.0, input_len=24,
                                         output_len=8) for i in range(3)])
    engine_barrier(sim, h_sim)
    runs = {"sim": (sim, T, h_sim, quarantine_tick(sim, T))}
    for eng, pkg, key in zip(clusters(setup, n_instances=4, n_prefill=1,
                                      n_slots=4, capacity=128,
                                      slo=both(lambda p: p.SLO(5.0, 2.0)),
                                      health=hc), (J, T), ("jax", "port")):
        hs = [eng.submit(pkg.Request(rid=i, arrival=0.0, input_len=24,
                                     output_len=8), prompt=prompts[i])
              for i in range(3)]
        engine_barrier(eng, hs)
        runs[key] = (eng, pkg, hs, quarantine_tick(eng, pkg))
    ticks = {key: r[3] for key, r in runs.items()}
    assert ticks["sim"] is not None
    assert ticks["sim"] == ticks["port"] == ticks["jax"]
    for system, pkg, hs, _ in runs.values():
        assert system.pools.degraded_ids() == [1]
        settle(system, pkg)
        rep = (system.drain() if system is sim
               else system.drain(timeout=300.0))
        for k in range(200):
            if system.pools.lifecycle_of(1) is pkg.Lifecycle.ACTIVE:
                break
            system.collect_stats(0.1 * (60 + k))
        assert rep.n_finished == 3
        assert system.health_stats["quarantines"] == 1
        assert system.pools.lifecycle_of(1) is pkg.Lifecycle.ACTIVE
        (jax_check_invariants if pkg is J else check_invariants)(system)
    assert runs["port"][0].health_stats == runs["jax"][0].health_stats
    port = tokens(runs["port"][2])
    assert port == tokens(runs["jax"][2])
    for rid, got in port.items():
        assert got == reference_stream(tcfg, tparams, prompts[rid], 8), rid


def test_retry_exhaustion_parity(setup):
    """tests/test_health.py::test_sim_engine_retry_exhaustion_parity: under
    a total drop window while instance 1 retires, every evacuation walks
    the whole retry ladder (budget 3) and falls back to re-prefill; the
    drop, retry, failure and corrupt-copy counters equal the port's
    simulator's and the JAX engine's, and the recovered streams are the
    fault-free ones and the JAX engine's."""
    _, _, tcfg, tparams = setup
    prompts = prompts_of(tcfg, 5, 3, 24)

    def drive(system, handles):
        def fire():
            now = system.clock.now()
            system.apply_transfer_drop(1.0, now + 9999.0)
            system.begin_retire(1, now)
        engine_barrier(system, handles)
        fire()
        return system.drain(timeout=300.0)

    sim = Simulator(SIM_CFG, n_instances=2, n_prefill=1, policy="arrow",
                    slo=T.SLO(5.0, 2.0), health=True)
    runs = {"sim": (drive(sim, replay_trace(sim, [
        T.Request(rid=i, arrival=0.0, input_len=24, output_len=8)
        for i in range(3)])), None)}
    for eng, pkg, key in zip(clusters(setup, n_instances=2, n_prefill=1,
                                      n_slots=4, capacity=128,
                                      slo=both(lambda p: p.SLO(5.0, 2.0)),
                                      health=True), (J, T), ("jax", "port")):
        hs = [eng.submit(pkg.Request(rid=i, arrival=0.0, input_len=24,
                                     output_len=8), prompt=prompts[i])
              for i in range(3)]
        runs[key] = (drive(eng, hs), hs)
        (jax_check_invariants if pkg is J else check_invariants)(eng)
    n, budget = 3, 3
    for rep, _ in runs.values():
        assert rep.n_finished == n
        for k, want in (("xfer_drops", n * (budget + 1)),
                        ("xfer_retries", n * budget), ("xfer_failures", n)):
            assert rep.health[k] == want, (k, rep.health)
    for key in ("jax", "port"):
        assert runs[key][0].health["xfer_corrupt"] == n * (budget + 1)
        assert sorted(h.rid for h in runs[key][1]
                      if h.req.recoveries == 1) == [0, 1, 2]
    assert runs["port"][0].health == runs["jax"][0].health
    assert decided(runs["port"][0].faults) == decided(runs["jax"][0].faults)
    port = tokens(runs["port"][1])
    assert port == tokens(runs["jax"][1])
    for rid, got in port.items():
        assert got == reference_stream(tcfg, tparams, prompts[rid], 8), rid


def preempt_at_blocked_gate(system, pkg, prompts=None):
    """tests/test_health.py's preemption_blocked_gate on either backend:
    two residents on instance 1 (rid 0 short, rid 1 long), one on instance
    2 (rid 2); instance 1's KV capacity clamped one token short of rid 2's
    evacuation, then instance 2 retires (and the clamp is lifted)."""
    lens = {0: 8, 1: 32, 2: 8}

    def submit(i):
        kw = {} if prompts is None else {"prompt": prompts[i]}
        return system.submit(pkg.Request(rid=i, arrival=0.0, input_len=24,
                                         output_len=lens[i]), **kw)

    handles = [submit(0), submit(1)]
    engine_barrier(system, handles)
    system.collect_stats(system.clock.now())
    handles.append(submit(2))
    for _ in range(100000):
        h = handles[2]
        if h.req.state.name == "DECODING" \
                and h.req.decode_instance == 2 and len(h.tokens) >= 2:
            break
        assert system.step(), "rid 2 never decoded on instance 2"
    loc1 = system.local_of(1)
    kv2 = system.local_of(2).decode_running[2].context_len
    real = loc1.kv_capacity
    loc1.kv_capacity = loc1.kv_used + kv2 - 1
    system.begin_retire(2, system.clock.now())
    loc1.kv_capacity = real
    return handles, lens


def test_preemption_victim_parity(setup):
    """tests/test_health.py::test_sim_engine_preemption_victim_parity: the
    blocked memory gate preempts the same victim (rid 1, the long resident)
    on the port's simulator and engine and on the JAX engine, one
    preemption each, and the preempted stream, re-prefilled, is the
    fault-free one and the JAX engine's."""
    _, _, tcfg, tparams = setup
    prompts = prompts_of(tcfg, 11, 3, 24)
    hc = both(lambda p: p.HealthConfig(preemption=True))
    sim = Simulator(SIM_CFG, n_instances=3, n_prefill=1, policy="arrow",
                    slo=T.SLO(5.0, 2.0), health=hc[1])
    h_sim, lens = preempt_at_blocked_gate(sim, T)
    runs = {"sim": (sim.drain(), h_sim)}
    for eng, pkg, key in zip(clusters(setup, n_instances=3, n_prefill=1,
                                      n_slots=4, capacity=128,
                                      slo=both(lambda p: p.SLO(5.0, 2.0)),
                                      health=hc), (J, T), ("jax", "port")):
        hs, _ = preempt_at_blocked_gate(eng, pkg, prompts)
        runs[key] = (eng.drain(timeout=300.0), hs)
        (jax_check_invariants if pkg is J else check_invariants)(eng)
    for rep, hs in runs.values():
        assert sorted(h.rid for h in hs if h.req.recoveries) == [1]
        assert rep.n_finished == 3
        assert rep.health["preemptions"] == 1
    assert runs["port"][0].health == runs["jax"][0].health
    port = tokens(runs["port"][1])
    assert port == tokens(runs["jax"][1])
    for rid, got in port.items():
        assert got == reference_stream(tcfg, tparams, prompts[rid],
                                       lens[rid]), rid


# ------------------------------------------- async-step schedules (§12)


N_ASYNC, OUT_ASYNC = 4, 12


@pytest.fixture(scope="module")
def async_env(setup):
    """The port's config and weights, the schedules' prompts, and the JAX
    engine's sequential streams for them (sampled at temperature 0.8 /
    top-p 0.9, run seed 0), which every schedule's streams must equal."""
    jcfg, jparams, tcfg, tparams = setup
    from repro.engine import EngineInstance as JInstance
    prng = np.random.default_rng(0xA5)
    prompts = {i: prng.integers(1, tcfg.vocab_size, size=16).astype(np.int32)
               for i in range(N_ASYNC)}
    sp = J.SamplingParams(temperature=0.8, top_p=0.9)
    ref = JInstance(99, jcfg, jparams, n_slots=4, capacity=128, run_seed=0)
    want = {}
    for rid, prompt in prompts.items():
        ref.set_sampling(rid, sp)
        got = [ref.run_prefill(rid, prompt)]
        ref.local.start_local_decode(rid, len(prompt), OUT_ASYNC - 1)
        for _ in range(OUT_ASYNC - 1):
            got.append(ref.run_decode_iteration([rid])[rid])
        want[rid] = [int(t) for t in got]
        ref.drop(rid)
    return tcfg, tparams, prompts, want


def run_async_schedule(env, sched: dict):
    """tests/test_properties.py's run_async_schedule on the port: ``ready_p``
    gates ``PendingStep.ready`` with a seeded coin so steps stay in flight
    across random numbers of collect polls, while crashes and retirements
    of decode instances fire at the scheduled step counts. The invariants
    hold throughout, every request finishes, and each sampled stream
    equals the port's sequential single-instance stream and the JAX
    engine's."""
    tcfg, tparams, prompts, want = env
    assert sched.get("n_requests", N_ASYNC) == N_ASYNC
    assert sched.get("out_len", OUT_ASYNC) == OUT_ASYNC
    assert sched.get("temperature", 0.8) == 0.8
    assert sched.get("run_seed", 0) == 0
    rng = np.random.default_rng(sched["seed"])
    sp = T.SamplingParams(temperature=0.8, top_p=0.9)
    from repro_torch.engine import ArrowEngineCluster
    cluster = ArrowEngineCluster(
        tcfg, n_instances=3, n_prefill=1, n_slots=4, capacity=128,
        slo=T.SLO(5.0, 2.0), params=tparams, seed=0,
        speculate=sched.get("speculate", 0), device="cpu")
    handles = [cluster.submit(T.Request(rid=i, arrival=0.0, input_len=16,
                                        output_len=OUT_ASYNC, sampling=sp),
                              prompt=prompts[i]) for i in range(N_ASYNC)]
    ready_p = sched.get("ready_p", 0.5)
    orig_ready = inst_mod.PendingStep.ready

    def gated_ready(self):
        return orig_ready(self) and bool(rng.random() < ready_p)

    crash_at = sorted(sched.get("crash_steps", []), reverse=True)
    retire_at = sorted(sched.get("retire_steps", []), reverse=True)
    deadline = time.time() + 300.0
    steps = 0
    inst_mod.PendingStep.ready = gated_ready
    try:
        while cluster.step() and time.time() < deadline:
            steps += 1
            now = cluster.clock.now()
            for at, act in ((crash_at, cluster.fail_instance),
                            (retire_at, cluster.begin_retire)):
                if at and steps >= at[-1]:
                    at.pop()
                    victims = [i for i in cluster.pools.active_ids()
                               if cluster.pools.pool_of(i) is T.Pool.DECODE]
                    if len(victims) > 1:
                        act(int(rng.choice(victims)), now)
            if steps % 32 == 0:
                check_invariants(cluster, streams=False)
    finally:
        inst_mod.PendingStep.ready = orig_ready
    report = cluster.drain()
    check_invariants(cluster)
    assert report.n_finished == N_ASYNC, \
        f"async schedule lost requests: {report.n_finished}/{N_ASYNC}"
    for h in handles:
        ref = reference_stream(tcfg, tparams, prompts[h.rid], OUT_ASYNC,
                               sp=sp, rid=h.rid)
        got = [int(t) for t in h.tokens]
        assert got == ref, f"rid {h.rid}: async schedule changed the stream"
        assert got == want[h.rid], f"rid {h.rid}: differs from the JAX engine"
    return report


@corpus_backed(ASYNC_CORPUS)
@given(seed=st.integers(0, 2 ** 16),
       ready_p=st.floats(0.05, 1.0),
       speculate=st.sampled_from([0, 0, 4]),
       crash_steps=st.lists(st.integers(1, 400), max_size=1),
       retire_steps=st.lists(st.integers(1, 400), max_size=1))
@settings(max_examples=5, deadline=None)
def test_async_step_schedules_hold_invariants(async_env, seed, ready_p,
                                              speculate, crash_steps,
                                              retire_steps):
    """tests/test_properties.py::test_async_step_schedules_hold_invariants
    on the port (the JAX corpus is only read)."""
    run_async_schedule(async_env, dict(
        seed=seed, ready_p=ready_p, speculate=speculate,
        crash_steps=crash_steps, retire_steps=retire_steps))


@pytest.mark.parametrize(
    "sched", json.loads(ASYNC_CORPUS.read_text()),
    ids=lambda s: s.get("name", str(s.get("seed"))))
def test_async_step_regression_corpus(async_env, sched):
    """tests/test_properties.py::test_async_step_regression_corpus: the
    checked-in schedules (a slow collect, a crash mid-inflight, a
    retirement against an inflight speculative step) on the port."""
    run_async_schedule(async_env, sched)
