"""Model parity of the PyTorch port's constant-state families at their smoke
configs (float32): Mamba-2 (mamba2-370m: 2 layers, d_model 128, 8 heads of
32, d_state 16, chunk 16) and RecurrentGemma (recurrentgemma-9b: one
(rglru, rglru, attn) group, window 32; and a 5-layer variant whose last two
layers form the homogeneous rglru tail stack). The weight bridge carries the
JAX parameters across bit for bit, each leaf in its own dtype, and
``forward_seq`` (with a cache, also a ring smaller than the prompt),
``prefill_chunk`` (``valid_len`` < S, resumed from a carried state, and a
chunk longer than the hybrid ring) and ``decode_step`` give the JAX
package's logits and decode state. The port's ``reference`` path is held
against JAX's ``reference``, its ``hopper`` path (the scan kernels' plain
versions on the CPU) against JAX's ``pallas`` path in interpret mode.

Tolerance: logits and states within 2e-5 absolute and relative (float32
sums in other orders); positions exactly. TF32 is off.
"""
import copy
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import hybrid, ssm  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
IMPLS = [("reference", "reference"), ("hopper", "pallas")]
# arch id, layer count override (None: the smoke config's)
VARIANTS = [("mamba2-370m", None), ("recurrentgemma-9b", None),
            ("recurrentgemma-9b", 5)]
F32_LEAVES = {"A_log", "D", "dt_bias", "b_a", "b_i", "lam"}


@pytest.fixture(scope="module", params=VARIANTS,
                ids=lambda v: v[0] + ("" if v[1] is None else f"-L{v[1]}"))
def setup(request):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch, n_layers = request.param
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    if n_layers:
        jcfg = jcfg.replace(n_layers=n_layers)
        tcfg = tcfg.replace(n_layers=n_layers)
    jparams = build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = weights.from_jax_params(jax.device_get(jparams), tcfg, "cpu")
    jmod, tmod = (jssm, ssm) if tcfg.family == "ssm" else (jhybrid, hybrid)
    return jcfg, jparams, jmod, tcfg, tparams, tmod


def cfgs(setup, impl):
    jcfg, _, _, tcfg, _, _ = setup
    return jcfg.replace(attn_impl=impl[1]), tcfg.replace(attn_impl=impl[0])


def tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(1, vocab, size=(B, S)) \
        .astype(np.int32)


def embed(setup, jc, tc, toks):
    _, jp, jm, _, tp, tm = setup
    return (jm.embed_tokens(jc, jp, jnp.asarray(toks)),
            tm.embed_tokens(tc, tp, torch.from_numpy(toks)))


def close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def close_cache(tcache, jcache):
    want = dict(weights.flatten(jax.device_get(jcache)))
    got = dict(weights.flatten(tcache))
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        if got[path].dtype == torch.int32:
            assert np.array_equal(got[path].numpy(), np.asarray(w)), path
        else:
            close(got[path], w)


def prefilled(setup, jc, tc, S=32, C=64):
    """Both packages' caches after a whole-sequence forward of S tokens."""
    jx, tx = embed(setup, jc, tc, tokens(2, S, tc.vocab_size, 1))
    _, jp, jm, _, tp, tm = setup
    _, jcache = jm.forward_seq(jc, jp, jx, jnp.arange(S), cache_capacity=C)
    _, tcache = tm.forward_seq(tc, tp, tx, torch.arange(S), cache_capacity=C)
    return jcache, tcache


def test_weight_bridge_keeps_leaf_dtypes(setup):
    """Every JAX leaf lands under its path bit for bit and in its dtype —
    in a bf16 config the f32 leaves (A_log, D, dt_bias; b_a, b_i, lam) stay
    f32 — and init_params makes the same paths, shapes, dtypes and fixed
    init values."""
    jcfg, _, _, tcfg, _, _ = setup
    jcfg, tcfg = jcfg.replace(dtype="bfloat16"), tcfg.replace(dtype="bfloat16")
    jparams = jax.device_get(build_model(jcfg).init(jax.random.PRNGKey(1)))
    tparams = weights.from_jax_params(jparams, tcfg, "cpu")
    spec = {p: (s, d) for p, s, d in weights.param_shapes(tcfg)}
    flat = dict(weights.flatten(jparams))
    assert set(flat) == set(tparams) == set(spec)
    for path, leaf in flat.items():
        got = tparams[path]
        want_dtype = (torch.float32 if path.rsplit("/", 1)[1] in F32_LEAVES
                      else torch.bfloat16)
        assert got.dtype == want_dtype == spec[path][1], path
        assert tuple(got.shape) == tuple(leaf.shape) == spec[path][0], path
        assert np.array_equal(got.float().numpy(),
                              np.asarray(leaf, np.float32)), path
    fresh = weights.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for path, leaf in flat.items():
        assert fresh[path].dtype == tparams[path].dtype, path
        assert fresh[path].shape == tparams[path].shape, path
        if path.rsplit("/", 1)[1] in F32_LEAVES | {"conv_b", "scale"}:
            # log/linspace within an ulp of XLA's; the rest exactly
            torch.testing.assert_close(fresh[path], tparams[path],
                                       rtol=1e-6, atol=1e-6, msg=path)


@pytest.mark.parametrize("capacity", [None, 64, 16])
@pytest.mark.parametrize("impl", IMPLS, ids=lambda i: i[0])
def test_forward_seq_matches_jax(setup, impl, capacity):
    """Logits and the decode state; capacity 16 is a hybrid ring smaller
    than the 48-token prompt."""
    jc, tc = cfgs(setup, impl)
    _, jp, jm, _, tp, tm = setup
    S = 48
    jx, tx = embed(setup, jc, tc, tokens(2, S, tc.vocab_size, 0))
    jl, jcache = jm.forward_seq(jc, jp, jx, jnp.arange(S),
                                cache_capacity=capacity)
    tl, tcache = tm.forward_seq(tc, tp, tx, torch.arange(S),
                                cache_capacity=capacity)
    close(tl, jl)
    if capacity is None:
        assert tcache is None and jcache is None
    else:
        close_cache(tcache, jcache)


@pytest.mark.parametrize("impl", IMPLS, ids=lambda i: i[0])
def test_prefill_chunk_matches_jax(setup, impl):
    """Two chunks after a 32-token prefill: 20 real tokens of 32, then 50
    of 64 (longer than the hybrid's 32-slot ring, so its commit wraps).
    Logits at real positions and the state agree after each."""
    jc, tc = cfgs(setup, impl)
    _, jp, jm, _, tp, tm = setup
    jcache, tcache = prefilled(setup, jc, tc)
    off = 32
    for i, (Sq, n) in enumerate(((32, 20), (64, 50))):
        jx, tx = embed(setup, jc, tc, tokens(2, Sq, tc.vocab_size, 10 + i))
        jl, jcache = jm.prefill_chunk(jc, jp, jcache, jx, off, valid_len=n)
        tl, tcache = tm.prefill_chunk(tc, tp, tcache, tx, off, valid_len=n)
        close(tl[:, :n], np.asarray(jl)[:, :n])
        close_cache(tcache, jcache)
        off += n


@pytest.mark.parametrize("impl", IMPLS, ids=lambda i: i[0])
def test_decode_step_matches_jax(setup, impl):
    jc, tc = cfgs(setup, impl)
    _, jp, jm, _, tp, tm = setup
    jcache, tcache = prefilled(setup, jc, tc)
    pos = np.array([32, 32], np.int32)
    for step in range(3):
        jx, tx = embed(setup, jc, tc, tokens(2, 1, tc.vocab_size, 20 + step))
        jl, jcache = jm.decode_step(jc, jp, jcache, jx, jnp.asarray(pos))
        tl, tcache = tm.decode_step(tc, tp, tcache, tx, torch.from_numpy(pos))
        close(tl, jl)
        close_cache(tcache, jcache)
        pos = pos + 1


def test_decode_step_writes_only_active_rows(setup):
    """With ``active``, the other rows' state stays bit for bit; the active
    row advances as in an unmasked step."""
    _, _, _, tcfg, tp, tm = setup
    _, cache = prefilled(setup, *cfgs(setup, IMPLS[0]))
    before = copy.deepcopy(cache)
    unmasked = copy.deepcopy(cache)
    x = tm.embed_tokens(tcfg, tp,
                        torch.from_numpy(tokens(2, 1, tcfg.vocab_size, 3)))
    pos = torch.tensor([32, 32])
    tm.decode_step(tcfg, tp, unmasked, x, pos)
    tm.decode_step(tcfg, tp, cache, x, pos, active=torch.tensor([1]))
    want_parked = dict(weights.flatten(before))
    want_active = dict(weights.flatten(unmasked))
    for path, t in weights.flatten(cache):
        axis = 0 if path == "pos_map" else 1      # the slot (batch) axis
        assert torch.equal(t.select(axis, 0),
                           want_parked[path].select(axis, 0)), path
        assert torch.equal(t.select(axis, 1),
                           want_active[path].select(axis, 1)), path


def test_kernel_switch_errors(setup):
    _, _, _, tcfg, tp, tm = setup
    cache = tm.init_cache(tcfg, 1, 64, device="cpu")
    x = tm.embed_tokens(tcfg, tp, torch.ones((1, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        tm.prefill_chunk(tcfg.replace(attn_impl="pallas"), tp, cache, x, 0,
                         valid_len=16)


@pytest.mark.parametrize("ctor", [
    "engine.kv_slots.SlotKVCache", "engine.state_slots.SSMStateSlots",
    "engine.state_slots.RecurrentStateSlots", "models.ssm.init_cache",
    "models.hybrid.init_cache"])
def test_state_containers_default_to_the_card(ctor):
    """The port's state containers, like its other entry points, run on the
    card unless the caller asks for the CPU (as these tests do)."""
    import importlib
    mod, name = ctor.rsplit(".", 1)
    fn = getattr(importlib.import_module(f"repro_torch.{mod}"), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
