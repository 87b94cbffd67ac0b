"""The Mamba-2 decode step replayed from a CUDA graph
(``repro_torch.engine.decode_graph``).

On the CPU: the state write by a bool row mask, which the captured step
uses, equals the index write of the eager step and leaves parked and free
rows bit for bit; the greedy step the graph captures gives the eager fused
step's tokens and state; the rule that builds a graph takes only the ssm
family on CUDA tensors, so CPU instances and the dense and hybrid families
run eager and count no replay under an attached tracer; and an instance
whose graph is a stand-in that runs the captured function eagerly replays
every greedy decode batch, its mixed steps included, and sends a batch
with a sampled row to the eager step, with the eager instance's streams.

On the card (marker ``cuda``, skipped without one): a graph instance and an
eager one serve the same streams id for id over 80 steps through rows
parking and resuming, a slot released and taken again by a mixed step, a
migrated state imported between replays, and a second step dispatched
before the first is finalized, with one capture in all:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_graph.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2  # noqa: E402
from repro_torch.core import Request, SamplingParams  # noqa: E402
from repro_torch.core.trace import Tracer  # noqa: E402
from repro_torch.engine import ArrowEngineCluster  # noqa: E402
from repro_torch.engine import decode_graph  # noqa: E402
from repro_torch.engine import fused_step as fs  # noqa: E402
from repro_torch.engine.instance import ChunkWork, EngineInstance  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

ARCHS = ["mamba2-370m", "qwen3-1.7b", "recurrentgemma-9b"]
SAMPLED = SamplingParams(temperature=0.8, top_p=0.9, seed=21)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke(dtype="float32"):
    return get_smoke_config("mamba2-370m").replace(dtype=dtype)


def params_of(cfg, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return weights.init_params(cfg, gen, device)


def random_cache(cfg, B, seed):
    """Slabs of ``B`` slots holding random state, as a decode meets them."""
    cache = ssm.init_cache(cfg, B, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for a in cache.values():
        a.copy_(torch.randn(a.shape, generator=g).to(a.dtype))
    return cache


def prompt(n, vocab, seed):
    return np.random.default_rng(seed).integers(1, vocab, n).astype(np.int32)


# ------------------------------------------------------------ the masked write


@pytest.mark.parametrize("rows", [[0, 2], [1], [0, 1, 2, 3, 4], []])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_write_equals_the_index_write(rows, dtype):
    """Both slabs and the logits equal the index write's bit for bit; the
    rows outside the mask keep their bits."""
    cfg = smoke(dtype)
    p = params_of(cfg)
    B = 5
    x = ssm.embed_tokens(cfg, p, torch.as_tensor(prompt(B, 512, 1))[:, None])
    before = random_cache(cfg, B, 2)
    by_index = {k: a.clone() for k, a in before.items()}
    by_mask = {k: a.clone() for k, a in before.items()}
    mask = torch.zeros(B, dtype=torch.bool)
    mask[rows] = True
    li, _ = ssm.decode_step(cfg, p, by_index, x,
                            active=torch.as_tensor(rows, dtype=torch.long))
    lm, _ = ssm.decode_step(cfg, p, by_mask, x, active=mask)
    assert torch.equal(li, lm)
    for k in before:
        assert torch.equal(by_index[k], by_mask[k]), k
        kept = by_mask[k][:, ~mask]
        assert torch.equal(kept, before[k][:, ~mask]), k
        if rows:
            assert not torch.equal(by_mask[k][:, mask],
                                   before[k][:, mask]), k


def test_greedy_decode_equals_the_fused_decode():
    """The function the graph captures gives ``ssm_decode``'s tokens
    and state on greedy rows, a parked and a free slot beside them."""
    cfg = smoke()
    p = params_of(cfg)
    B = 4
    active = np.array([True, False, True, False])
    toks = prompt(B, 512, 3)[:, None]
    a = random_cache(cfg, B, 4)
    b = {k: t.clone() for k, t in a.items()}
    zeros = np.zeros(B, np.float32)
    want = fs.ssm_decode(cfg, p, a["conv"], a["ssm"], torch.as_tensor(toks),
                         np.arange(B), zeros, np.ones(B, np.float32),
                         np.zeros(B, np.int32), np.arange(B, dtype=np.int32),
                         active)
    got = fs.ssm_decode_greedy(cfg, p, b["conv"], b["ssm"],
                               torch.as_tensor(toks), torch.as_tensor(active))
    assert got.dtype == torch.int32 and torch.equal(got, want)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --------------------------------------------------------- when it engages


class _Slab:
    def __init__(self, is_cuda):
        self.is_cuda = is_cuda


@pytest.mark.parametrize("arch", ARCHS)
def test_a_graph_is_built_for_ssm_on_cuda_only(arch):
    cfg = get_smoke_config(arch)
    on_card = (_Slab(True), _Slab(True))
    assert decode_graph.fits(cfg, on_card) == (cfg.family == "ssm")
    assert not decode_graph.fits(cfg, (_Slab(True), _Slab(False)))
    if cfg.family == "ssm":
        cache = ssm.init_cache(cfg, 2, device="cpu")
        assert not decode_graph.fits(cfg, (cache["conv"], cache["ssm"]))


def serve_burst(cfg, traced, sampled=(), n=4):
    """A short burst on a 1P+1D cluster; -> (cluster, streams by rid)."""
    c = ArrowEngineCluster(cfg, n_instances=2, n_slots=4, capacity=128,
                           chunk_tokens=32, seed=3, device="cpu")
    if traced:
        c.tracer = Tracer(c.clock)
    hs = [c.submit(Request(rid, arrival=0.01 * rid, input_len=20 + 9 * rid,
                           output_len=5 + rid,
                           sampling=SAMPLED if rid in sampled else None),
                   prompt=prompt(20 + 9 * rid, cfg.vocab_size, rid))
          for rid in range(n)]
    c.drain(timeout=120)
    assert all(h.done for h in hs)
    return c, {h.rid: list(h.tokens) for h in hs}


def dispatch_counts(c):
    cnt = c.tracer.counts()
    return [cnt[i] for i, name in enumerate(c.tracer.names)
            if name == "instance.dispatch" and i in cnt]


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_and_other_families_run_eager(arch):
    """No instance builds a graph on the CPU, whatever the family, and
    every dispatched step counts no replay and no capture."""
    c, _ = serve_burst(get_smoke_config(arch), True, n=3)
    assert all(i._graph is None for i in c.instances.values())
    got = dispatch_counts(c)
    assert got and sum(g["decode_rows"] for g in got) > 0
    assert all(g["graph_replays"] == 0 and g["graph_captures"] == 0
               for g in got)


class StandIn:
    """The graph's interface over the captured function run eagerly, so
    the instance's use of a graph runs on the CPU."""

    def __init__(self, cfg, params, slots):
        self.cfg, self.params, self.slots = cfg, params, slots
        self.captures, self.replays = 1, 0

    def replay(self, tokens, active):
        self.replays += 1
        return fs.ssm_decode_greedy(self.cfg, self.params,
                                    *self.slots.slabs(),
                                    torch.as_tensor(tokens),
                                    torch.as_tensor(active))


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(decode_graph, "fits",
                        lambda cfg, slabs: cfg.family == "ssm")
    monkeypatch.setattr(decode_graph, "SSMDecodeGraph", StandIn)


def test_every_greedy_decode_batch_replays(stand_in, monkeypatch):
    """With a graph on every instance, each dispatched step that decodes
    replays it and counts no capture, and the streams are the eager
    cluster's."""
    cfg = smoke()
    c, got = serve_burst(cfg, True)
    assert all(isinstance(i._graph, StandIn) for i in c.instances.values())
    counts = dispatch_counts(c)
    decoding = [g for g in counts if g["decode_rows"] > 0]
    assert decoding and all(g["graph_replays"] == 1 for g in decoding)
    assert all(g["graph_replays"] == 0 for g in counts
               if g["decode_rows"] == 0)
    assert not any(g["graph_captures"] for g in counts)
    assert sum(i.graph_replays for i in c.instances.values()) == \
        len(decoding)
    monkeypatch.setattr(decode_graph, "fits", lambda cfg, slabs: False)
    assert serve_burst(cfg, False)[1] == got


def test_a_sampled_row_sends_the_batch_eager(stand_in):
    """A decode batch replays only while every decoding row is greedy, a
    mixed step's too; the streams, sampled ones too, are an eager
    instance's."""
    cfg = smoke()
    p = params_of(cfg)
    insts = [EngineInstance(i, cfg, p, n_slots=4, capacity=128, device="cpu")
             for i in range(2)]
    insts[1]._graph = None
    for inst in insts:
        inst.set_sampling(2, SAMPLED)
        for rid in (1, 2):
            inst.run_prefill(rid, prompt(12 + rid, cfg.vocab_size, rid))
    for inst in insts:
        inst.alloc_slot(3)
    text = prompt(40, cfg.vocab_size, 3)
    batches = [([1], (), 1), ([1, 2], (), 0), ([2], (), 0),
               ([1], [ChunkWork(3, 0, 32, text[:32], 40)], 1),
               ([1, 2], [ChunkWork(3, 32, 8, text[32:], 40)], 0),
               ([1, 3], (), 1)]
    for rids, chunks, replayed in batches:
        before = insts[0].graph_replays
        outs = [inst.finalize_step(inst.dispatch_step(rids, chunks))
                for inst in insts]
        assert outs[0] == outs[1]
        assert insts[0].graph_replays - before == replayed
    assert insts[0].generated == insts[1].generated
    assert insts[0].graph_captures == 1 and insts[1].graph_replays == 0


# ------------------------------------------------------------------ the card


def card_config():
    """mamba2-370m's published widths, eps and float32 stream, in bf16,
    with 4 layers and a 1,024 vocabulary."""
    return MAMBA2.replace(n_layers=4, vocab_size=1024, attn_impl="hopper")


def _step(insts, decode_rids, chunks=()):
    """One fused step on each instance; -> their decode tokens."""
    outs = []
    for inst in insts:
        pend = inst.dispatch_step(list(decode_rids), list(chunks))
        outs.append(inst.finalize_step(pend)[0])
    return outs


@pytest.mark.cuda
def test_graph_streams_equal_eager_streams_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU form)")
    dev = torch.device("cuda")
    cfg = card_config()
    p = params_of(cfg, "cuda", seed=5)
    graph, eager, source = (EngineInstance(i, cfg, p, n_slots=8,
                                           capacity=512, device=dev)
                            for i in range(3))
    assert graph._graph is not None and graph.graph_captures == 1
    eager._graph = None
    pair = (graph, eager)
    for rid in (1, 2, 3, 4):
        for inst in pair:
            inst.run_prefill(rid, prompt(40 + 7 * rid, cfg.vocab_size, rid))
    running = [1, 2, 3, 4]
    n_steps = 0
    for t in range(80):
        chunks = ()
        if t == 25:                     # release a slot, take it again
            for inst in pair:
                inst.drop(3)
                inst.alloc_slot(5)
            running.remove(3)
            text = prompt(50, cfg.vocab_size, 5)
            chunks = (ChunkWork(5, 0, 50, text, 50),)   # beside the decode
        if t == 40:                     # a migrated state lands
            source.run_prefill(6, prompt(61, cfg.vocab_size, 6))
            for _ in range(3):
                source.run_decode_iteration([6])
            payload, L, last, gen, crc = source.export_state(6)
            for inst in pair:
                assert inst.import_state(6, payload, L, last, gen,
                                         checksum=crc)
            running.append(6)
        # rid 2 parks for ten steps, then resumes
        rids = [r for r in running if not (r == 2 and 10 <= t < 20)]
        if t == 55:                     # two steps before a finalize
            outs = []
            for inst in pair:
                first = inst.dispatch_step(list(rids), [])
                second = inst.dispatch_step(list(rids), [])
                outs.append((inst.finalize_step(first)[0],
                             inst.finalize_step(second)[0]))
            assert outs[0] == outs[1]
            n_steps += 2
            continue
        a, b = _step(pair, rids, chunks)
        assert a == b, t
        n_steps += 1
        if t == 25:
            running.append(5)
    assert graph.generated == eager.generated
    assert graph.graph_captures == 1            # no recapture
    assert graph.graph_replays == n_steps and eager.graph_replays == 0
    assert all(len(graph.generated[r]) >= 20 for r in running)


@pytest.mark.cuda
def test_sampled_rows_run_eager_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU form)")
    cfg = card_config()
    p = params_of(cfg, "cuda", seed=6)
    graph, eager = (EngineInstance(i, cfg, p, n_slots=4, capacity=256,
                                   device="cuda") for i in range(2))
    eager._graph = None
    for inst in (graph, eager):
        inst.set_sampling(2, SAMPLED)
        for rid in (1, 2):
            inst.run_prefill(rid, prompt(30 + rid, cfg.vocab_size, rid))
    for rids, replayed in [([1], 1), ([1, 2], 0), ([2], 0), ([1], 1)] * 4:
        before = graph.graph_replays
        a, b = _step((graph, eager), rids)
        assert a == b
        assert graph.graph_replays - before == replayed
    assert graph.graph_captures == 1
