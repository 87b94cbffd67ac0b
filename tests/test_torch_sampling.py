"""Sampler parity of the PyTorch port: its threefry keys equal JAX's
``PRNGKey``/``fold_in`` bit for bit, its Gumbel noise agrees with JAX's,
and ``sample_tokens`` picks JAX's token ids for greedy rows and for
temperature 0.9 / top-p 0.9 rows.

The JAX side runs in the non-partitionable threefry mode the engine's
golden sampled streams were recorded under; a fixture sets the flag and
restores it afterwards.

Gumbel tolerance: each float32 ``log`` within 1 ulp of XLA's on the same
input, and the noise within 2 ulp of max(|g|, 1). The uniforms are
bit-identical; torch's and XLA's float32 ``log`` differ by up to 1 ulp, and
the outer log of ``-log(-log(u))`` turns the inner one's ulp into a fixed
absolute error that is many ulps of g only where g is near 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.engine import fused_step as jfs  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.engine import fused_step as tfs  # noqa: E402
from repro_torch.engine import prng  # noqa: E402

SEEDS = [0, 1, 7, 77, 2**31 - 1]


@pytest.fixture(scope="module", autouse=True)
def non_partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def bits(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bits(seed):
    k = jax.random.PRNGKey(seed)
    tk = prng.prng_key(seed)
    assert np.array_equal(bits(k), tk.numpy())
    for rid, pos in [(0, 0), (5, 19), (2**31 - 1, 4095)]:
        jk = jax.random.fold_in(jax.random.fold_in(k, rid), pos)
        got = prng.fold_in(prng.fold_in(tk, rid), pos)
        assert np.array_equal(bits(jk), got.numpy()), (rid, pos)


def test_batched_keys_match_scalar_keys():
    seeds = np.array(SEEDS, np.int64)
    rids = np.arange(len(SEEDS)) * 3
    got = prng.fold_in(prng.prng_key(seeds), torch.from_numpy(rids))
    for i, s in enumerate(SEEDS):
        assert np.array_equal(
            got[i].numpy(),
            bits(jax.random.fold_in(jax.random.PRNGKey(s), int(rids[i]))))


@pytest.mark.parametrize("n", [7, 512, 151936])
@pytest.mark.parametrize("seed", [0, 2**31 - 1])
def test_gumbel_matches_jax(seed, n):
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                               3), 11)
    tk = prng.fold_in(prng.fold_in(prng.prng_key(seed), 3), 11)
    ju = np.asarray(jax.random.uniform(jk, (n,), jnp.float32,
                                       minval=np.finfo(np.float32).tiny))
    assert np.array_equal(prng.uniform(tk, n, minval=prng._TINY_F32)
                          .numpy(), ju)
    want = np.asarray(jax.random.gumbel(jk, (n,), jnp.float32))
    got = prng.gumbel(tk, n).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert np.all(np.abs(got - want) <= 2 * ulp)
    # each of the two float32 logs of -log(-log(u)) is within 1 ulp of JAX's
    # on the same input
    for x in (ju, np.asarray(-jnp.log(ju))):
        jl = np.asarray(-jnp.log(jnp.asarray(x)))
        tl = (-torch.log(torch.from_numpy(x.copy()))).numpy()
        assert np.all(np.abs(tl - jl) <= np.spacing(np.abs(jl)))


@pytest.mark.parametrize("temp,top_p", [(0.0, 1.0), (0.9, 0.9), (1.3, 0.5)])
def test_sample_tokens_match_jax(temp, top_p):
    """Ids equal JAX's over 16 rows of random logits (padded vocab), with
    one greedy row mixed into every sampled batch."""
    jcfg = jax_smoke("qwen3-1.7b")
    tcfg = get_smoke_config("qwen3-1.7b")
    rng = np.random.default_rng(4)
    B = 16
    logits = (rng.standard_normal((B, tcfg.padded_vocab)) * 3) \
        .astype(np.float32)
    temps = np.full((B,), temp, np.float32)
    temps[0] = 0.0
    tops = np.full((B,), top_p, np.float32)
    seeds = rng.integers(0, 2**31 - 1, size=B).astype(np.int32)
    rids = rng.integers(0, 1000, size=B).astype(np.int32)
    pos = rng.integers(0, 4096, size=B).astype(np.int32)
    want = np.asarray(jfs.sample_tokens(
        jcfg, jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(tops),
        jnp.asarray(seeds), jnp.asarray(rids), jnp.asarray(pos)))
    got = tfs.sample_tokens(tcfg, torch.from_numpy(logits), temps, tops,
                            seeds, rids, pos).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert got[0] == np.argmax(logits[0, :tcfg.vocab_size])
