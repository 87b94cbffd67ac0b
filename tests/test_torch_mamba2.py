"""The port's Mamba-2 as published (mamba_ssm: RMSNorm eps 1e-5, the
residual stream in float32) against the plain reference
``tests/torch_ref/mamba2.py`` on the CPU, at a small size with seeded
weights, on float32 logits: whole-prompt prefill (``forward_seq`` and one
``prefill_chunk``), chunked prefill ending in a ragged ``valid_len``,
decode through the engine's slot slabs with a parked slot, and the tokens
an ``ArrowEngineCluster`` serves. The JAX package's norm eps (1e-6) and a
bf16 residual stream, each against the published reference, fail the same
tolerances.

Tolerances, each with its reason:

- ``F32_TOL`` (float32 weights): the largest absolute logit difference.
  The two sides differ only in the order of float32 sums (the chunked dual
  form and the kernel route's plain version against a sequential
  recurrence): measured 1.5e-7 here, at most 3e-6 at up to 24 layers.
  The JAX eps moves the logits by 0.13 here (the first norm's input is
  the 0.02-scale embedding, whose mean square, 4e-4, the eps shifts by
  2%).
- ``BF16_TOL`` (bf16 weights, ``STREAM``'s scales): the root mean square
  of the logit error over that of the reference's logits. Each norm's
  output, each product and the head round to bf16 on both streams:
  measured 0.0023-0.0024 with the float32 stream over seeds 0-3. A bf16
  stream also rounds the whole stream at each of the 16 layers, where each
  layer's update is about 1/17 of it: 0.0063-0.0066.
- ``GAP_TOL``: by how much a served token's reference logit lies below
  the reference's best (the benchmark's ``correct`` measure); greedy
  float32 serving leaves only ``F32_TOL``'s rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ref import mamba2 as ref  # noqa: E402

from repro_torch import weights  # noqa: E402
from repro_torch.configs.base import ModelConfig, SSMConfig  # noqa: E402
from repro_torch.core import Request  # noqa: E402
from repro_torch.engine import ArrowEngineCluster  # noqa: E402
from repro_torch.engine.state_slots import SSMStateSlots  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 0.0045
GAP_TOL = 1e-4
V = 250
# (embedding std, w_out std) of the bf16 case: a stream large beside each
# layer's update, as in a deep model's later layers
STREAM = (1.0, 0.005)
VARIANTS = {"published": {}, "jax_eps": {"norm_eps": 1e-6},
            "bf16_stream": {"residual_in_fp32": False}}


def published(dtype="float32", n_layers=2, **kw):
    """A small Mamba-2 with the published model's norm eps and float32
    residual, on the serving path (the scan kernel's plain version)."""
    return ModelConfig(
        arch_id="tiny-mamba2", family="ssm", n_layers=n_layers, d_model=64,
        n_heads=0, n_kv_heads=0, head_dim=16, d_ff=0, vocab_size=V,
        norm="rmsnorm", rope="none", long_context_window=None,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16,
                      n_groups=1),
        norm_eps=1e-5, residual_in_fp32=True, dtype=dtype,
        attn_impl="hopper").replace(**kw)


def reference(cfg):
    s = cfg.ssm
    return ref.Mamba2(n_layer=cfg.n_layers, d_model=cfg.d_model,
                      vocab_size=V, d_state=s.d_state, d_conv=s.d_conv,
                      expand=s.expand, headdim=s.head_dim,
                      ngroups=s.n_groups, norm_epsilon=1e-5)


def params_of(cfg, seed=0, stream=None):
    p = weights.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    if stream is not None:
        emb, w_out = stream
        p["tok/embed"] = p["tok/embed"] * (emb / 0.02)
        p["layers/w_out"] = p["layers/w_out"] * (w_out / 0.02)
    return p


def toks(n, seed):
    return np.random.default_rng(seed).integers(1, V, n).astype(np.int32)


def max_err(got, want):
    return float((got[..., :V].float() - want).abs().max())


def rel_rms(got, want):
    d = got[..., :V].float() - want
    return float(d.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def whole_prompt(cfg, p, t, route):
    x = ssm.embed_tokens(cfg, p, torch.as_tensor(t[None]))
    if route == "forward_seq":
        return ssm.forward_seq(cfg.replace(attn_impl="reference"), p, x)[0][0]
    cache = ssm.init_cache(cfg, 1, device="cpu")
    return ssm.prefill_chunk(cfg, p, cache, x, 0, valid_len=len(t))[0][0]


@pytest.mark.parametrize("route", ["forward_seq", "prefill_chunk"])
@pytest.mark.parametrize("variant", ["published", "jax_eps"])
def test_whole_prompt_prefill(route, variant):
    cfg = published(**VARIANTS[variant])
    p, t = params_of(cfg), toks(96, 1)          # whole scan chunks
    err = max_err(whole_prompt(cfg, p, t, route),
                  ref.logits(reference(cfg), p, t))
    assert (err <= F32_TOL) == (variant == "published"), err


@pytest.mark.parametrize("variant", ["published", "bf16_stream"])
def test_bf16_weights_keep_a_float32_stream(variant):
    cfg = published("bfloat16", n_layers=16, **VARIANTS[variant])
    p, t = params_of(cfg, stream=STREAM), toks(64, 2)
    err = rel_rms(whole_prompt(cfg, p, t, "prefill_chunk"),
                  ref.logits(reference(cfg), p, t))
    assert (err <= BF16_TOL) == (variant == "published"), err


@pytest.mark.parametrize("variant", ["published", "jax_eps"])
def test_chunked_prefill_with_a_ragged_valid_len(variant):
    """Three 32-token chunks, the last holding 11 real tokens and padding,
    each resuming the state the one before left."""
    cfg = published(**VARIANTS[variant])
    p, t = params_of(cfg, seed=3), toks(75, 3)
    cache = ssm.init_cache(cfg, 1, device="cpu")
    got = []
    for off in range(0, len(t), 32):
        part = t[off:off + 32]
        chunk = np.zeros(32, np.int32)
        chunk[:len(part)] = part
        x = ssm.embed_tokens(cfg, p, torch.as_tensor(chunk[None]))
        lg, cache = ssm.prefill_chunk(cfg, p, cache, x, off,
                                      valid_len=len(part))
        got.append(lg[0, :len(part)])
    err = max_err(torch.cat(got), ref.logits(reference(cfg), p, t))
    assert (err <= F32_TOL) == (variant == "published"), err


@pytest.mark.parametrize("variant", ["published", "jax_eps"])
def test_decode_through_the_slot_slabs(variant):
    """Two streams prefilled into slots 0 and 2 of the engine's slabs, then
    decoded a token at a time over all three slots with slot 1 parked:
    each step's logits are the reference's at that position, and the
    parked slot's state is never written."""
    cfg = published(**VARIANTS[variant])
    p = params_of(cfg, seed=4)
    slots = SSMStateSlots(cfg, 3, 64, device="cpu")
    seqs = {0: toks(40, 5), 2: toks(23, 6)}
    n_in = {0: 30, 2: 17}
    for s, t in seqs.items():
        view = {"conv": slots.conv[:, s:s + 1], "ssm": slots.ssm[:, s:s + 1]}
        x = ssm.embed_tokens(cfg, p, torch.as_tensor(t[None, :n_in[s]]))
        ssm.prefill_chunk(cfg, p, view, x, 0, valid_len=n_in[s])
    slots.ssm[:, 1] = 7.0
    parked = (slots.conv[:, 1].clone(), slots.ssm[:, 1].clone())
    active = torch.tensor([0, 2])
    got = {0: [], 2: []}
    for j in range(6):
        step = np.zeros((3, 1), np.int32)
        for s, t in seqs.items():
            step[s, 0] = t[n_in[s] + j]
        x = ssm.embed_tokens(cfg, p, torch.as_tensor(step))
        lg, _ = ssm.decode_step(cfg, p, {"conv": slots.conv,
                                         "ssm": slots.ssm}, x, active=active)
        for s in seqs:
            got[s].append(lg[s, 0])
    m = reference(cfg)
    err = max(max_err(torch.stack(got[s]), ref.logits(m, p, t)[
        n_in[s]:n_in[s] + 6]) for s, t in seqs.items())
    assert (err <= F32_TOL) == (variant == "published"), err
    assert torch.equal(slots.conv[:, 1], parked[0])
    assert torch.equal(slots.ssm[:, 1], parked[1])


def test_served_tokens_are_the_references_best():
    """Greedy streams of a 1 prefill + 1 decode cluster (chunked prefill,
    a migration of the state each, then decode in the shared batch): each
    served token's reference logit is within ``GAP_TOL`` of the
    reference's best at its position."""
    cfg = published(n_layers=3)
    p = params_of(cfg, seed=8)
    c = ArrowEngineCluster(cfg, n_instances=2, n_slots=4, capacity=128,
                           chunk_tokens=32, params=p, device="cpu")
    prompts = [toks(n, 10 + i) for i, n in enumerate((70, 9, 41, 33))]
    hs = [c.submit(Request(i, arrival=0.0, input_len=len(t), output_len=6),
                   prompt=t) for i, t in enumerate(prompts)]
    c.drain(timeout=120)
    assert all(h.done for h in hs) and c.migration_log
    m, worst = reference(cfg), 0.0
    for h, t in zip(hs, prompts):
        served = [int(x) for x in h.tokens]
        assert len(served) == 6
        lg = ref.logits(m, p, np.concatenate([t, served[:-1]]))[len(t) - 1:]
        gap = lg.max(-1).values - lg[torch.arange(6), torch.tensor(served)]
        worst = max(worst, float(gap.max()))
    assert worst <= GAP_TOL, worst
