"""Model parity of the PyTorch port at the qwen3-1.7b smoke config (2 layers,
d_model 128, GQA 4/2, head_dim 32, float32): the weight bridge carries the
JAX parameters across bit for bit, and ``forward_seq`` (also with a ring
cache smaller than the prompt), ``decode_step`` and ``prefill_chunk`` give
the JAX package's logits and caches. The port's ``reference`` path is held
against JAX's ``reference``, its ``hopper`` path (plain-torch kernel
versions on the CPU) against JAX's ``pallas`` path in interpret mode.

Tolerance: logits and K/V within 2e-5 absolute and relative (float32
matmuls and softmaxes summed in other orders); positions exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import dense as jdense  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import dense  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
IMPLS = [("reference", "reference"), ("hopper", "pallas")]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke("qwen3-1.7b")
    jparams = build_model(jcfg).init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config("qwen3-1.7b")
    tparams = weights.from_jax_params(jax.device_get(jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def cfgs(setup, impl):
    jcfg, _, tcfg, _ = setup
    t_impl, j_impl = impl
    return jcfg.replace(attn_impl=j_impl), tcfg.replace(attn_impl=t_impl)


def tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(1, vocab, size=(B, S)) \
        .astype(np.int32)


def close(got, want, **kw):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(kw or TOL))


def test_weight_bridge_round_trip(setup):
    """Every JAX leaf lands under its a/b/c path with its stacked layer axis,
    bit for bit, and init_params makes the same paths, shapes and scales."""
    jcfg, jparams, tcfg, tparams = setup
    flat = dict(weights.flatten(jax.device_get(jparams)))
    assert set(flat) == set(tparams)
    for path, leaf in flat.items():
        assert tparams[path].shape == leaf.shape
        assert np.array_equal(tparams[path].numpy(), np.asarray(leaf)), path
    assert tparams["layers/attn/wq"].shape[0] == tcfg.n_layers
    fresh = weights.init_params(tcfg, torch.Generator().manual_seed(0),
                                "cpu")
    assert {k: v.shape for k, v in fresh.items()} == \
        {k: v.shape for k, v in tparams.items()}
    assert torch.all(fresh["layers/ln1/scale"] == 0)     # rmsnorm: 1 + w
    assert abs(float(fresh["tok/embed"].std()) - 0.02) < 2e-3
    # bf16 leaves cross as their bits
    bf = jnp.asarray(np.linspace(-1, 1, 7), jnp.bfloat16)
    got = weights._to_tensor(np.asarray(bf))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(bf, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reads_jax_checkpoint_files(setup, tmp_path, dtype):
    """A params file written by the JAX package's save_checkpoint loads
    into the same tensors the in-memory bridge gives, bf16 included."""
    from repro.checkpoint.ckpt import save_checkpoint
    _, jparams, tcfg, _ = setup
    jp = jax.tree.map(lambda a: a.astype(dtype), jparams)
    path = str(tmp_path / "params.msgpack")
    save_checkpoint(path, jp)
    cfg = tcfg.replace(dtype=dtype)
    got = weights.load_jax_checkpoint(path, cfg, "cpu")
    want = weights.from_jax_params(jax.device_get(jp), cfg, "cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("capacity", [None, 96, 16])
@pytest.mark.parametrize("impl", IMPLS, ids=lambda i: i[0])
def test_forward_seq_matches_jax(setup, impl, capacity):
    """Full-sequence prefill logits and its cache; capacity 16 < S=32 keeps
    the last 16 positions at their ring slots."""
    jcfg, tcfg = cfgs(setup, impl)
    _, jparams, _, tparams = setup
    toks = tokens(2, 32, tcfg.vocab_size, seed=1)
    jx = jdense.embed_tokens(jcfg, jparams, jnp.asarray(toks))
    jl, jc = jdense.forward_seq(jcfg, jparams, jx, jnp.arange(32),
                                cache_capacity=capacity)
    tx = dense.embed_tokens(tcfg, tparams, torch.from_numpy(toks))
    tl, tc = dense.forward_seq(tcfg, tparams, tx, torch.arange(32),
                               cache_capacity=capacity)
    close(tl, jl)
    if capacity is None:
        assert tc is None and jc is None
        return
    close(tc["k"], jc["k"])
    close(tc["v"], jc["v"])
    assert np.array_equal(tc["pos_map"].numpy(), np.asarray(jc["pos_map"]))


def _prefilled(setup, jcfg, tcfg, S=32, C=96):
    _, jparams, _, tparams = setup
    toks = tokens(2, S, tcfg.vocab_size, seed=2)
    jx = jdense.embed_tokens(jcfg, jparams, jnp.asarray(toks))
    _, jc = jdense.forward_seq(jcfg, jparams, jx, jnp.arange(S),
                               cache_capacity=C)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    return jc, tc


@pytest.mark.parametrize("impl", IMPLS, ids=lambda i: i[0])
def test_decode_step_matches_jax(setup, impl):
    """Two decode steps on a JAX-prefilled cache (capacity 96 = 3 pages of
    32 on the kernel path); rows at different positions."""
    jcfg, tcfg = cfgs(setup, impl)
    _, jparams, _, tparams = setup
    jc, tc = _prefilled(setup, jcfg, tcfg)
    for step, pos in enumerate(([32, 40], [33, 41])):
        tok = tokens(2, 1, tcfg.vocab_size, seed=10 + step)
        jl, jc = jdense.decode_step(
            jcfg, jparams, jc, jdense.embed_tokens(jcfg, jparams,
                                                   jnp.asarray(tok)),
            jnp.asarray(pos, jnp.int32))
        tl, tc = dense.decode_step(
            tcfg, tparams, tc, dense.embed_tokens(tcfg, tparams,
                                                  torch.from_numpy(tok)),
            torch.tensor(pos))
        close(tl, jl)
    close(tc["k"], jc["k"])
    close(tc["v"], jc["v"])
    assert np.array_equal(tc["pos_map"].numpy(), np.asarray(jc["pos_map"]))


@pytest.mark.parametrize("impl", IMPLS, ids=lambda i: i[0])
def test_prefill_chunk_matches_jax(setup, impl):
    """A 32-token chunk at offset 32 against the 96-slot cache."""
    jcfg, tcfg = cfgs(setup, impl)
    _, jparams, _, tparams = setup
    jc, tc = _prefilled(setup, jcfg, tcfg)
    toks = tokens(2, 32, tcfg.vocab_size, seed=3)
    jl, jc = jdense.prefill_chunk(
        jcfg, jparams, jc, jdense.embed_tokens(jcfg, jparams,
                                               jnp.asarray(toks)), 32)
    tl, tc = dense.prefill_chunk(
        tcfg, tparams, tc, dense.embed_tokens(tcfg, tparams,
                                              torch.from_numpy(toks)), 32)
    close(tl, jl)
    close(tc["k"], jc["k"])
    close(tc["v"], jc["v"])
    assert np.array_equal(tc["pos_map"].numpy(), np.asarray(jc["pos_map"]))


def test_kernel_switch_errors(setup):
    """The same refusals as the JAX switch: softcapped logits have no kernel
    variant, windowed decode has no paged variant, unknown names fail."""
    _, _, tcfg, tparams = setup
    x = torch.zeros(1, 1, tcfg.d_model)
    cache = {"k": torch.zeros(tcfg.n_layers, 1, 32, tcfg.n_kv_heads,
                              tcfg.head_dim_),
             "pos_map": torch.full((1, 32), -1, dtype=torch.int32)}
    cache["v"] = cache["k"].clone()
    with pytest.raises(NotImplementedError):
        dense.decode_step(tcfg.replace(attn_impl="hopper"), tparams, cache,
                          x, torch.tensor([0]), window=8)
    with pytest.raises(NotImplementedError):
        dense.forward_seq(tcfg.replace(attn_impl="hopper",
                                       logit_softcap=30.0), tparams,
                          torch.zeros(1, 32, tcfg.d_model), torch.arange(32))
    with pytest.raises(ValueError):
        dense.forward_seq(tcfg.replace(attn_impl="pallas"), tparams,
                          torch.zeros(1, 32, tcfg.d_model), torch.arange(32))


@pytest.mark.parametrize("impl", IMPLS, ids=lambda i: i[0])
@pytest.mark.parametrize("arch", ["gemma-2b", "chatglm3-6b", "stablelm-12b"])
def test_other_dense_archs_match_jax(arch, impl):
    """The rest of the dense family's helpers at their smoke configs:
    geglu and embedding scaling (gemma), partial rope and an untied
    unembedding (chatglm3), layernorm (stablelm). Prefill with a cache,
    one chunk and one decode step, against JAX."""
    t_impl, j_impl = impl
    jcfg = jax_smoke(arch).replace(attn_impl=j_impl)
    tcfg = get_smoke_config(arch).replace(attn_impl=t_impl)
    jparams = build_model(jcfg).init(jax.random.PRNGKey(1))
    tparams = weights.from_jax_params(jax.device_get(jparams), tcfg, "cpu")
    toks = tokens(1, 64, tcfg.vocab_size, seed=4)
    jl, jc = jdense.forward_seq(
        jcfg, jparams, jdense.embed_tokens(jcfg, jparams,
                                           jnp.asarray(toks[:, :32])),
        jnp.arange(32), cache_capacity=64)
    tl, tc = dense.forward_seq(
        tcfg, tparams, dense.embed_tokens(tcfg, tparams,
                                          torch.from_numpy(toks[:, :32])),
        torch.arange(32), cache_capacity=64)
    close(tl, jl)
    jl, jc = jdense.prefill_chunk(
        jcfg, jparams, jc, jdense.embed_tokens(jcfg, jparams,
                                               jnp.asarray(toks[:, 32:])), 32)
    tl, tc = dense.prefill_chunk(
        tcfg, tparams, tc, dense.embed_tokens(tcfg, tparams,
                                              torch.from_numpy(toks[:, 32:])),
        32)
    close(tl, jl)
    # decode the last position again over the full cache
    tok = toks[:, 63:64]
    jl, _ = jdense.decode_step(
        jcfg, jparams, jc, jdense.embed_tokens(jcfg, jparams,
                                               jnp.asarray(tok)),
        jnp.asarray([63], jnp.int32))
    tl, _ = dense.decode_step(
        tcfg, tparams, tc, dense.embed_tokens(tcfg, tparams,
                                              torch.from_numpy(tok)),
        torch.tensor([63]))
    close(tl, jl)
