"""Engine parity of the PyTorch port on the CPU (``device="cpu"``).

With the JAX parameters of ``PRNGKey(7)`` carried across by the weight
bridge, the port's ``EngineInstance`` reproduces the greedy and seeded
sampled streams pinned in ``golden_streams_pr8.json`` — on both attention
paths — and an ``ArrowEngineCluster`` run gives the JAX cluster's streams
and migration log. Migration payloads checksum to the JAX package's CRC,
and a JAX instance's exported KV continues decoding on a torch instance.
The dense container's ``state_bytes`` is the JAX value and the payload's
size, and ``export_kv``/``import_kv`` continue a sampled stream and refuse
softly on a full cache. Token ids are compared exactly.

The JAX side runs in the non-partitionable threefry mode the golden pin was
recorded under (set by a fixture and restored afterwards).
"""
import json
import subprocess
import sys
from pathlib import Path

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
from repro_torch.engine.instance import (CorruptPayload,  # noqa: E402
                                         state_checksum)

GOLDEN = Path(__file__).parent / "data" / "golden_streams_pr8.json"
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    jcfg = jax_smoke("qwen3-1.7b")
    jparams = build_model(jcfg).init(jax.random.PRNGKey(7))
    tcfg = get_smoke_config("qwen3-1.7b")
    tparams = weights.from_jax_params(jax.device_get(jparams), tcfg, "cpu")
    yield jcfg, jparams, tcfg, tparams
    jax.config.update("jax_threefry_partitionable", old)


def golden_prompts(vocab):
    """The prompts the golden pin was recorded with."""
    rng = np.random.default_rng(123)
    return {i: rng.integers(1, vocab, size=int(rng.integers(8, 28)))
            .astype(np.int32) for i in range(3)}


def instance_stream(inst, rid, prompt, n_new, sp=None):
    inst.set_sampling(rid, sp)
    inst.run_prefill(rid, prompt)
    inst.local.start_local_decode(rid, len(prompt), n_new - 1)
    for _ in range(n_new - 1):
        inst.run_decode_iteration([rid])
    return [int(t) for t in inst.generated[rid][:n_new]]


@pytest.mark.parametrize("impl", ["reference", "hopper"])
def test_instance_streams_match_golden_pin(setup, impl):
    _, _, tcfg, tparams = setup
    golden = json.loads(GOLDEN.read_text())
    cfg = tcfg.replace(attn_impl=impl)
    inst = EngineInstance(0, cfg, tparams, n_slots=4, capacity=128,
                          device="cpu")
    sp = SamplingParams(temperature=0.9, top_p=0.9, seed=77)
    for rid, prompt in golden_prompts(cfg.vocab_size).items():
        assert instance_stream(inst, rid + 100, prompt, 10) \
            == golden["greedy"][str(rid)], f"greedy stream {rid}"
        inst.drop(rid + 100)
        assert instance_stream(inst, rid + 100, prompt, 10, sp=sp) \
            == golden["sampled"][str(rid)], f"sampled stream {rid}"
        inst.drop(rid + 100)


@pytest.mark.parametrize("impl", ["reference", "hopper"])
def test_chunked_and_prefix_prefill_continue_the_stream(setup, impl):
    """A 40-token prompt prefilled in two chunks, and one whose first 16
    positions are copied from another request's resident KV (copy_prefix)
    and whose suffix is chunk-prefilled at offset 16, both emit the
    whole-prompt prefill's sampled stream for the same rid."""
    _, _, tcfg, tparams = setup
    cfg = tcfg.replace(attn_impl=impl)
    prompt = np.random.default_rng(9).integers(
        1, cfg.vocab_size, size=40).astype(np.int32)
    sp = SamplingParams(temperature=0.8, top_p=0.9, seed=5)
    inst = EngineInstance(0, cfg, tparams, n_slots=4, capacity=128,
                          device="cpu")
    want = instance_stream(inst, 1, prompt, 8, sp=sp)
    inst.drop(1)

    def suffix_stream():
        inst.set_sampling(1, sp)
        first = inst.run_prefill_chunk(1, prompt[16:], 16, 40)
        inst.local.start_local_decode(1, len(prompt), 7)
        got = [first] + [inst.run_decode_iteration([1])[1]
                         for _ in range(7)]
        inst.drop(1)
        return got

    assert inst.run_prefill_chunk(1, prompt[:16], 0, 40) is None
    assert suffix_stream() == want
    inst.run_prefill(7, prompt)                   # the resident source
    inst.begin_cached_prefill(1, 7, 16)
    assert suffix_stream() == want


def _cluster_run(cls, req_cls, slo_cls, sp, cfg, params, **kw):
    """Mirror of tests/test_sampling.py's cluster_streams on either
    package: 4 requests of 20 tokens, 8 outputs, prefill on instance 0."""
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
    return streams, log, report


def test_cluster_matches_jax_cluster(setup):
    """Same params, prompts, seed and sampling: the torch cluster's streams
    and migration log (rid, context tokens, wire bytes) equal the JAX
    cluster's."""
    jcfg, jparams, tcfg, tparams = setup
    jstreams, jlog, _ = _cluster_run(
        JCluster, JRequest, JSLO, JSamplingParams(temperature=0.8, top_p=0.9),
        jcfg, jparams)
    tstreams, tlog, rep = _cluster_run(
        ArrowEngineCluster, Request, SLO,
        SamplingParams(temperature=0.8, top_p=0.9), tcfg, tparams,
        device="cpu")
    assert tstreams == jstreams
    assert len(tlog) >= 1
    assert tlog == jlog
    assert rep.sampling["seed"] == 42 and rep.sampling["sampled_requests"] == 4


def test_checksum_and_cross_framework_migration(setup):
    """A JAX instance prefills and decodes; its exported KV checksums to the
    same CRC through the port's state_checksum, imports into a torch
    instance under the JAX checksum, and the torch instance continues the
    stream token for token. A flipped byte is refused before any slot is
    taken."""
    jcfg, jparams, tcfg, tparams = setup
    sp = SamplingParams(temperature=0.8, top_p=0.9, seed=21)
    jsp = JSamplingParams(temperature=0.8, top_p=0.9, seed=21)
    prompt = golden_prompts(tcfg.vocab_size)[0]
    ref = instance_stream(JInstance(0, jcfg, jparams, n_slots=4,
                                    capacity=128), 7, prompt, 9, sp=jsp)
    src = JInstance(1, jcfg, jparams, n_slots=4, capacity=128)
    got = instance_stream(src, 7, prompt, 4, sp=jsp)
    payload, L, last, gen = src.export_state(7)
    crc = jax_checksum(payload)
    tpayload = [torch.from_numpy(np.array(p)) for p in payload]
    assert state_checksum(tpayload) == crc

    dst = EngineInstance(2, tcfg, tparams, n_slots=4, capacity=128,
                         device="cpu")
    bad = [p.clone() for p in tpayload]
    bad[0].view(torch.uint8).view(-1)[0] ^= 0xFF
    with pytest.raises(CorruptPayload):
        dst.import_state(7, bad, L, last, gen, checksum=crc)
    assert len(dst.kv.free) == 4
    assert dst.import_state(7, tpayload, L, last, gen,
                            sampling=(sp.temperature, sp.top_p, sp.seed),
                            checksum=crc)
    dst.local.start_local_decode(7, L, 5)
    for _ in range(5):
        got.append(dst.run_decode_iteration([7])[7])
    assert got == ref
    # and the torch export of the continued state checksums consistently
    tp, *_ = dst.export_state(7)
    assert state_checksum(tp) == jax_checksum([p.numpy() for p in tp])


def test_entry_points_need_a_device_or_cpu(setup):
    _, _, tcfg, tparams = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineInstance(0, tcfg, tparams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArrowEngineCluster(tcfg, params=tparams)


def test_slot_kv_state_bytes_matches_jax(setup):
    """``state_bytes`` of the dense container: 2 x layers x Hk x D x
    itemsize x tokens, the JAX value, and the size of the payload that
    ``export_state`` really moves."""
    from repro.engine.kv_slots import SlotKVCache as JSlotKVCache
    from repro_torch.engine.kv_slots import SlotKVCache
    kv = SlotKVCache(2, 2, 64, 2, 8, device="cpu")
    jkv = JSlotKVCache(2, 2, 64, 2, 8)
    for c in (kv, jkv):
        c.alloc(0)
        c.len_of[0] = 40
    assert kv.state_bytes(0) == 10240 == jkv.state_bytes(0)
    _, _, tcfg, tparams = setup
    inst = EngineInstance(0, tcfg, tparams, n_slots=2, capacity=64,
                          device="cpu")
    inst.run_prefill(3, golden_prompts(tcfg.vocab_size)[0])
    payload, L, *_ = inst.export_state(3)
    assert inst.kv.state_bytes(3) == sum(p.nbytes for p in payload)


def test_migration_payload_pins_only_card_slabs(monkeypatch):
    """Migration payloads leave the slabs through ``host_copy``: pinned
    host memory when the slab is on the card, ordinary memory for CPU
    slabs. On the CPU, ``extract_state`` still gives each slot's bytes as
    a copy of their own (no view of the slab) and ``state_bytes`` counts
    them, for the dense and the recurrent containers."""
    from repro_torch.engine import state_slots
    from repro_torch.engine.kv_slots import SlotKVCache
    calls = []

    class Card:                       # what host_copy reads of a card tensor
        shape, dtype, is_cuda = (2, 3), torch.float32, True

    class Host:
        def copy_(self, src):
            return self

    def empty(shape, dtype=None, pin_memory=False):
        calls.append(pin_memory)
        return Host()

    with monkeypatch.context() as m:
        m.setattr(state_slots.torch, "empty", empty)
        state_slots.host_copy(Card())
        state_slots.host_copy(torch.zeros(2, 3))
    assert calls == [True, False]

    g = torch.Generator().manual_seed(3)
    kv = SlotKVCache(2, 3, 16, 2, 4, device="cpu")
    cfg = get_smoke_config("mamba2-370m")
    ssm = state_slots.make_state_slots(cfg, 3, 16, "cpu")
    for slots in (kv, ssm):
        slots.alloc(5)
        slots.alloc(6)
        slots.len_of[6] = 9
        for a, _ in (slots._leaves() if slots is ssm else
                     ((slots.k, 1), (slots.v, 1))):
            a.copy_(torch.randn(a.shape, generator=g).to(a.dtype))
        payload, n = slots.extract_state(6)
        assert n == 9
        assert slots.state_bytes(6) == sum(p.nbytes for p in payload)
        s = slots.slot_of[6]
        rows = ([slots.k[:, s, :9], slots.v[:, s, :9]] if slots is kv else
                [a.select(axis, s) for a, axis in slots._leaves()])
        for p, row in zip(payload, rows):
            assert not p.is_pinned() and p.is_contiguous()
            assert torch.equal(p, row)
            p.zero_()                 # its own bytes: the slab keeps its
        assert any(row.abs().sum() > 0 for row in rows)


def test_export_import_kv_round_trip(setup):
    """``export_kv``/``import_kv`` (the dense-layout compatibility pair):
    the sampling state rides along and the importer continues the sampled
    stream token for token; a full slot cache refuses softly (False)."""
    _, _, tcfg, tparams = setup
    sp = SamplingParams(temperature=0.8, top_p=0.9, seed=21)
    prompt = golden_prompts(tcfg.vocab_size)[0]
    ref = instance_stream(EngineInstance(0, tcfg, tparams, n_slots=4,
                                         capacity=128, device="cpu"),
                          7, prompt, 9, sp=sp)
    src = EngineInstance(1, tcfg, tparams, n_slots=4, capacity=128,
                         device="cpu")
    got = instance_stream(src, 7, prompt, 4, sp=sp)
    k, v, L, last, gen = src.export_kv(7)
    assert k.shape == (tcfg.n_layers, L, tcfg.n_kv_heads, tcfg.head_dim_)
    dst = EngineInstance(2, tcfg, tparams, n_slots=1, capacity=128,
                         device="cpu")
    assert dst.import_kv(7, k, v, L, last, gen,
                         sampling=(sp.temperature, sp.top_p, sp.seed))
    dst.local.start_local_decode(7, L, 5)
    for _ in range(5):
        got.append(dst.run_decode_iteration([7])[7])
    assert got == ref
    assert dst.import_kv(8, k, v, L, last, gen) is False


def test_launcher_serves_on_cpu(capsys):
    from repro_torch.launch import serve
    report = serve.run_engine(serve.build_parser().parse_args(
        ["--device", "cpu", "--attn-impl", "hopper", "--requests", "3"]))
    assert report.n_finished == 3
    assert "[serve-engine arrow] finished 3/3" in capsys.readouterr().out
    serve.main(["--mode", "sim", "--rate", "1", "--duration", "10"])
    assert "[serve-sim qwen3-1.7b azure_code x1.0 arrow] finished " \
        in capsys.readouterr().out


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.engine, repro_torch.launch.serve\n"
        "import repro_torch.kernels, repro_torch.traces\n"
        "import repro_torch.models.ssm, repro_torch.models.hybrid\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.kernels.rglru_scan\n"
        "import repro_torch.bench.bench_speculative\n"
        "import repro_torch.sim, repro_torch.sim.policies\n"
        "import repro_torch.models.api, repro_torch.models.moe\n"
        "import repro_torch.models.encdec, repro_torch.launch.train\n"
        "import repro_torch.optim, repro_torch.checkpoint, repro_torch.data\n"
        "import repro_torch.distributed, repro_torch.distributed.steps\n"
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
        "import repro_torch.bench.bench_ssm, repro_torch.bench.bench_chaos\n"
        "import repro_torch.examples.quickstart\n"
        "import repro_torch.examples.serve_arrow\n"
        "import repro_torch.examples.simulate_cluster\n"
        "import repro_torch.examples.train_100m\n"
        "import repro_torch.bench.bench_trace_stats\n"
        "import repro_torch.bench.bench_load_difference\n"
        "import repro_torch.bench.bench_e2e, repro_torch.bench.bench_ablation\n"
        "import repro_torch.bench.bench_scalability\n"
        "import repro_torch.bench.bench_flip_latency\n"
        "import repro_torch.bench.bench_elastic\n"
        "import repro_torch.bench.bench_deflection\n"
        "import repro_torch.bench.bench_prefix, repro_torch.bench.bench_faults\n"
        "import repro_torch.bench.bench_tenants\n"
        "import repro_torch.bench.bench_kernels, repro_torch.bench.roofline\n"
        "import repro_torch.bench.run\n"
        "repro_torch.launch.serve.main(['--mode', 'sim', '--arch',"
        " 'olmoe-1b-7b', '--trace', 'spike', '--rate', '1',"
        " '--duration', '10'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "clean"
