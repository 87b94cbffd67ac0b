"""Parity of the port's other model families with the JAX package, through
``build_model``, at the smoke configs in float32: qwen2-vl-2b (the dense
backbone with M-RoPE), olmoe-1b-7b and dbrx-132b (sort-dispatched MoE) and
whisper-medium (encoder–decoder). The weight bridge carries the JAX
parameters across, and ``loss``, ``prefill`` (logits and cache) and three
``decode`` steps give the JAX package's numbers. The VLM runs on both
attention routes: the port's ``reference`` against JAX's ``reference``,
its ``hopper`` route (the kernels' plain versions on the CPU) against
JAX's ``pallas`` route in interpret mode. ``moe_ffn`` is also held alone:
grouped dispatch, a capacity overflow that drops tokens, and an all-tied
router, whose experts must be JAX's ``lax.top_k`` order (lowest index
first). Every arch of the zoo then runs ``build_model``'s three entry
points against JAX once.

Inputs are made from numpy seeds. Tolerance: 2e-5 absolute and relative
(float32 matmuls and softmaxes summed in other orders); positions and
expert ids exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
NEW = ["qwen2-vl-2b", "olmoe-1b-7b", "dbrx-132b", "whisper-medium"]
B, S, C = 2, 32, 64


def close(got, want, **kw):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(kw or TOL))


@functools.lru_cache(maxsize=None)
def bridge(arch, seed=0):
    """(JAX config, JAX params, port config, the same params in the port)
    at ``arch``'s smoke config."""
    jcfg = jax_smoke(arch)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(seed))
    tcfg = get_smoke_config(arch)
    return jcfg, jparams, tcfg, weights.from_jax_params(
        jax.device_get(jparams), tcfg, "cpu")


def batches(cfg, seed):
    """(train/prefill batch, three decode batches) as numpy, per family."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    dec = []
    for step in range(3):
        d = {"token": rng.integers(1, cfg.vocab_size, size=(B, 1))
             .astype(np.int32),
             "pos": np.full((B,), S + step, np.int32)}
        if cfg.family == "vlm":
            d["positions"] = np.stack(
                [d["pos"], rng.integers(0, S, B), rng.integers(0, S, B)],
                axis=1)[:, :, None].astype(np.int32)
        dec.append(d)
    if cfg.family == "vlm":
        # non-trivial (t, h, w): time runs on, height and width wander
        pos = np.stack([np.broadcast_to(np.arange(S), (B, S)),
                        rng.integers(0, 8, (B, S)),
                        rng.integers(0, 8, (B, S))], axis=1).astype(np.int32)
        return {"embeds": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32), "positions": pos, "labels": toks}, dec
    if cfg.family == "encdec":
        return {"audio_embeds": rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32),
            "tokens": toks}, dec
    return {"tokens": toks}, dec


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.mark.parametrize("arch", NEW)
def test_param_shapes_match_jax_init(arch):
    """param_shapes gives the flattened JAX init's paths, shapes and
    dtypes; from_jax_params carries every leaf bit for bit, and
    init_params follows the JAX init rules."""
    jcfg, jparams, tcfg, tparams = bridge(arch)
    flat = dict(weights.flatten(jax.device_get(jparams)))
    want = {p: (tuple(a.shape), weights.torch_dtype(str(a.dtype)))
            for p, a in flat.items()}
    got = {p: (s, d) for p, s, d in weights.param_shapes(tcfg)}
    assert got == want
    for path, leaf in flat.items():
        assert np.array_equal(tparams[path].numpy(), np.asarray(leaf)), path
    fresh = weights.init_params(tcfg, torch.Generator().manual_seed(0),
                                "cpu")
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: s for k, (s, _) in want.items()}
    for path, t in fresh.items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "scale":
            assert torch.all(t == (0.0 if tcfg.norm == "rmsnorm" else 1.0))
        elif leaf in ("bias", "q_norm", "k_norm"):
            assert torch.all(t == 0)
        else:
            assert abs(float(t.std()) - 0.02) < 2e-3, path


def run_both(zoo, t_impl, j_impl, seed):
    """loss, prefill and three decode steps on both packages; returns the
    pairs to compare and the final caches."""
    jcfg, jparams, tcfg, tparams = zoo
    jm = jax_build(jcfg.replace(attn_impl=j_impl))
    tm = build_model(tcfg.replace(attn_impl=t_impl))
    batch, dec = batches(tcfg, seed)
    pairs = [("loss", tm.loss(tparams, as_torch(batch)),
              jm.loss(jparams, as_jax(batch)))]
    tl, tc = tm.prefill(tparams, as_torch(batch), C)
    jl, jc = jm.prefill(jparams, as_jax(batch), C)
    pairs.append(("prefill", tl, jl))
    for i, d in enumerate(dec):
        tl, tc = tm.decode(tparams, tc, as_torch(d))
        jl, jc = jm.decode(jparams, jc, as_jax(d))
        pairs.append((f"decode{i}", tl, jl))
    return pairs, tc, jc


# the VLM on both routes; MoE and Whisper have the reference attention only
# (as in the JAX package)
ROUTES = [(a, "reference", "reference") for a in NEW] \
    + [("qwen2-vl-2b", "hopper", "pallas")]


@pytest.mark.parametrize("arch,t_impl,j_impl", ROUTES)
def test_model_matches_jax(arch, t_impl, j_impl):
    """loss, prefill logits and cache (pos_map exactly), three decode
    steps' logits and the cache they leave, against JAX."""
    pairs, tc, jc = run_both(bridge(arch), t_impl, j_impl, seed=1)
    for name, got, want in pairs:
        assert torch.isfinite(got).all(), name
        close(got, want)
    assert set(tc) == set(jc)
    for k in tc:
        if k == "pos_map":
            assert np.array_equal(tc[k].numpy(), np.asarray(jc[k]))
        else:
            close(tc[k], jc[k])


@pytest.mark.parametrize("t_impl,j_impl", [("reference", "reference"),
                                            ("hopper", "pallas")])
def test_vlm_prefill_chunk_matches_jax(t_impl, j_impl):
    """The VLM's chunked prefill: a 32-token chunk at offset 32 with its
    own (t, h, w) positions, against a prefilled 64-slot cache."""
    from repro.models import dense as jdense
    from repro_torch.models import dense
    jcfg, jparams, tcfg, tparams = bridge("qwen2-vl-2b")
    jcfg, tcfg = jcfg.replace(attn_impl=j_impl), tcfg.replace(
        attn_impl=t_impl)
    batch, _ = batches(tcfg, 9)
    _, jc = jax_build(jcfg).prefill(jparams, as_jax(batch), C)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    x = np.random.default_rng(10).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    mpos = batch["positions"] + S
    jl, jc = jdense.prefill_chunk(jcfg, jparams, jc, jnp.asarray(x), S,
                                  mrope_positions=jnp.asarray(mpos))
    tl, tc = dense.prefill_chunk(tcfg, tparams, tc, torch.from_numpy(x), S,
                                 mrope_positions=torch.from_numpy(mpos))
    close(tl, jl)
    close(tc["k"], jc["k"])
    assert np.array_equal(tc["pos_map"].numpy(), np.asarray(jc["pos_map"]))


def moe_inputs(arch, seed, **moe_kw):
    jcfg, jparams, tcfg, tparams = bridge(arch, seed=seed)
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe_kw))
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])
    tp = weights.layer(tparams, 0, "layers/moe/")
    x = np.random.default_rng(seed).standard_normal(
        (B, 24, tcfg.d_model)).astype(np.float32)
    return jcfg, jp, tcfg, tp, x


def moe_pair(jcfg, jp, tcfg, tp, x):
    jy, jaux = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x))
    ty, taux = moe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    close(ty, jy)
    close(taux, jaux, rtol=1e-5, atol=1e-6)
    return ty


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "dbrx-132b"])
def test_moe_ffn_matches_jax(arch, groups):
    """The expert FFN and its load-balance term, with the tokens in one
    group or packed per group of two."""
    jcfg, jp, tcfg, tp, x = moe_inputs(arch, seed=2)
    moe_pair(jcfg.replace(moe_groups=groups), jp,
             tcfg.replace(moe_groups=groups), tp, x)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "dbrx-132b"])
def test_moe_capacity_overflow_drops_like_jax(arch):
    """capacity_factor 0.25: some expert gets more tokens than its slots,
    and the dropped (token, expert) pairs contribute nothing, as in JAX."""
    jcfg, jp, tcfg, tp, x = moe_inputs(arch, seed=3, capacity_factor=0.25)
    _, _, top_e = moe.route(tcfg, tp, torch.from_numpy(x))
    counts = torch.bincount(top_e.flatten(), minlength=tcfg.moe.n_experts)
    assert int(counts.max()) > moe.capacity(tcfg, B * 24)
    moe_pair(jcfg, jp, tcfg, tp, x)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "dbrx-132b"])
def test_moe_tied_router_picks_lowest_experts(arch):
    """A zero router ties every expert: each token takes experts 0..K-1,
    lax.top_k's order, and the outputs match JAX's."""
    jcfg, jp, tcfg, tp, x = moe_inputs(arch, seed=4)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    K, E = tcfg.moe.top_k, tcfg.moe.n_experts
    _, j_top = lax.top_k(jax.nn.softmax(jnp.zeros((B * 24, E))), K)
    assert np.array_equal(np.asarray(j_top),
                          np.broadcast_to(np.arange(K), (B * 24, K)))
    _, _, t_top = moe.route(tcfg, tp, torch.from_numpy(x))
    assert torch.equal(t_top.reshape(-1, K),
                       torch.arange(K).expand(B * 24, K))
    moe_pair(jcfg, jp, tcfg, tp, x)


def test_moe_expert_parallel_matches_jax():
    """moe_ffn with expert parallelism (moe_ep_axis "model", two groups)
    on DTensors over a 1x1 gloo mesh: the group -> expert reshard, the
    experts' products on their shards and the reshard back give JAX's
    moe_ffn of the same groups (the 8-rank case is
    test_torch_distributed's)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import destroy, make_local_mesh
    jcfg, jp, tcfg, tp, x = moe_inputs("olmoe-1b-7b", seed=5)
    ep = tcfg.replace(moe_ep_axis="model", moe_groups=2,
                      act_batch_axes=("data",))
    mesh = make_local_mesh("cpu")
    try:
        dp = {k: shd.distribute(v, shd.param_spec(f"layers/moe/{k}",
                                                  v.shape, 1), mesh)
              for k, v in tp.items()}
        dx = shd.distribute(torch.from_numpy(x), ("data", None, None), mesh)
        with implicit_replication():
            ty, taux = moe.moe_ffn(ep, dp, dx)
        ty, taux = ty.full_tensor(), taux.full_tensor()
    finally:
        destroy()
    jy, jaux = jmoe.moe_ffn(jcfg.replace(moe_groups=2), jp, jnp.asarray(x))
    close(ty, jy)
    close(taux, jaux, rtol=1e-5, atol=1e-6)


def test_encdec_prefill_needs_whole_prefix():
    _, _, tcfg, tparams = bridge("whisper-medium")
    batch, _ = batches(tcfg, 6)
    with pytest.raises(ValueError, match="whole prefix"):
        build_model(tcfg).prefill(tparams, as_torch(batch), S - 1)


def test_vlm_text_positions_equal_standard_rope():
    """With t = h = w (text), M-RoPE rotates as standard RoPE does."""
    from repro_torch.models import common as cm
    tcfg = get_smoke_config("qwen2-vl-2b")
    pos = torch.arange(S)
    cos, sin, rd = cm.rope_for(tcfg, pos, pos[None, None].expand(B, 3, S))
    cos2, sin2, rd2 = cm.rope_for(tcfg.replace(rope="standard"), pos)
    assert rd == rd2
    assert torch.allclose(cos, cos2.expand_as(cos))
    assert torch.allclose(sin, sin2.expand_as(sin))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_model_serves_every_arch_like_jax(arch):
    """Every preset of the zoo through build_model: loss, prefill and one
    decode step against the JAX package's."""
    pairs, _, _ = run_both(bridge(arch, seed=7), "reference", "reference",
                           seed=8)
    for name, got, want in pairs[:3]:
        assert torch.isfinite(got).all(), name
        close(got, want)
