"""The port's training path against the JAX package's, on the CPU: AdamW
(float32 moments whatever the parameter dtype), one train step's loss and
gradients at the smoke configs in float32, rematerialisation, the msgpack
checkpoint in both directions (bf16 included), the synthetic token
pipeline, and the trainer's CLI for every arch.

Tolerances: AdamW 1e-6 relative (float32 arithmetic in the same order;
the bias corrections' powers may round apart by an ulp), bf16 parameters
one bf16 ulp (2**-8 relative); loss and gradients 1e-4 absolute and
relative (float32 forward and backward summed in other orders);
rematerialised gradients and checkpoints bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as jax_load  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import SyntheticTokenPipeline as JaxPipeline  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.checkpoint import (load_checkpoint,  # noqa: E402
                                    read_checkpoint, save_checkpoint)
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticTokenPipeline  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import (AdamWState, adamw_init,  # noqa: E402
                               adamw_update)

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def f32(t):
    return t.detach().float().numpy()


def bits(t):
    """A tensor's raw bits as a numpy array (bf16 viewed as int16)."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(dtype):
    """Three steps on a two-leaf tree, with the default hyper-parameters
    and with others; the moments stay float32 for bf16 parameters."""
    rng = np.random.default_rng(0)
    shapes = {"a/w": (4, 8), "b": (16,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in
          shapes.items()}
    jp = {k: jnp.asarray(v, dtype) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(weights.torch_dtype(dtype))
          for k, v in p0.items()}
    js, ts = jax_adamw_init(jp), adamw_init(tp)
    kw = [{}, {"lr": 1e-2, "b1": 0.8, "b2": 0.99, "weight_decay": 0.1}, {}]
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in
             shapes.items()}
        jp, js = jax_adamw_update(jp, {k: jnp.asarray(v, dtype)
                                       for k, v in g.items()}, js, **kw[step])
        tp, ts = adamw_update(tp, {k: torch.from_numpy(v).to(
            weights.torch_dtype(dtype)) for k, v in g.items()}, ts,
            **kw[step])
    assert int(ts.step) == int(js.step) == 3
    ulp = 2.0 ** -8 if dtype == "bfloat16" else 1e-6
    for k in shapes:
        assert tp[k].dtype == weights.torch_dtype(dtype)
        assert ts.mu[k].dtype == ts.nu[k].dtype == torch.float32
        np.testing.assert_allclose(f32(ts.mu[k]), np.asarray(js.mu[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(f32(ts.nu[k]), np.asarray(js.nu[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(f32(tp[k]),
                                   np.asarray(jp[k], np.float32),
                                   rtol=ulp, atol=1e-7)


def train_batch(cfg, seed=0, B=2, S=16):
    toks = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return toks


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_train_step_matches_jax_value_and_grad(arch):
    """Model.loss and loss.backward() against jax.value_and_grad on the
    same parameters and tokens; then one AdamW step on each."""
    jcfg = jax_smoke(arch)
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config(arch)
    tm = build_model(tcfg)
    tparams = weights.from_jax_params(jax.device_get(jparams), tcfg, "cpu")
    toks = train_batch(tcfg)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jparams, {"tokens": jnp.asarray(toks)})
    for p in tparams.values():
        p.requires_grad_(True)
    tloss = tm.loss(tparams, {"tokens": torch.from_numpy(toks)})
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **GRAD_TOL)
    jflat = dict(weights.flatten(jax.device_get(jgrads)))
    assert set(jflat) == set(tparams)
    for k, g in jflat.items():
        np.testing.assert_allclose(f32(tparams[k].grad), g, err_msg=k,
                                   **GRAD_TOL)
    jnew, _ = jax_adamw_update(jparams, jgrads, jax_adamw_init(jparams))
    tnew, _ = adamw_update({k: p.detach() for k, p in tparams.items()},
                           {k: p.grad for k, p in tparams.items()},
                           adamw_init(tparams))
    for k, v in weights.flatten(jax.device_get(jnew)):
        np.testing.assert_allclose(f32(tnew[k]), v, err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b",
                                  "whisper-medium", "qwen2-vl-2b",
                                  "mamba2-370m", "recurrentgemma-9b"])
def test_remat_gives_the_same_gradients(arch):
    """remat=True recomputes each layer in the backward pass: the loss and
    every gradient are those of remat=False, bit for bit."""
    cfg = get_smoke_config(arch)
    m = build_model(cfg)
    toks = torch.from_numpy(train_batch(cfg, seed=1, S=32))
    batch = train.make_batch_for(cfg, toks)
    out = []
    for remat in (False, True):
        params = m.init(torch.Generator().manual_seed(0), "cpu")
        for p in params.values():
            p.requires_grad_(True)
        loss = m.loss(params, batch, remat=remat)
        loss.backward()
        out.append((loss.detach(), {k: p.grad for k, p in params.items()}))
    assert torch.equal(out[0][0], out[1][0])
    for k, g in out[0][1].items():
        assert torch.equal(g, out[1][1][k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages(tmp_path, dtype):
    """A trainer-style {"params": ...} file from either package reads back
    in the other bit for bit, and the port's optimizer state round-trips
    through its own files."""
    jcfg = jax_smoke("olmoe-1b-7b").replace(dtype=dtype)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config("olmoe-1b-7b").replace(dtype=dtype)
    tparams = weights.init_params(tcfg, torch.Generator().manual_seed(1),
                                  "cpu")
    # JAX writes, the port reads (both readers)
    jpath = str(tmp_path / "jax.msgpack")
    jax_save(jpath, {"params": jparams})
    want = dict(weights.flatten(jax.device_get(jparams)))
    got = weights.load_jax_checkpoint(jpath, tcfg, "cpu")
    like = load_checkpoint(jpath, {"params": tparams})["params"]
    for k, v in want.items():
        ref = bits(weights._to_tensor(v))
        assert np.array_equal(bits(got[k]), ref), k
        assert np.array_equal(bits(like[k]), ref), k
    # the port writes, JAX reads
    tpath = str(tmp_path / "torch.msgpack")
    save_checkpoint(tpath, {"params": tparams})
    back = jax_load(tpath, {"params": jparams})["params"]
    for k, v in weights.flatten(jax.device_get(back)):
        assert str(v.dtype) == dtype
        assert np.array_equal(bits(weights._to_tensor(v)),
                              bits(tparams[k])), k
    # optimizer state (a NamedTuple with a 0-d step) in the port's files
    opt = adamw_update(tparams, {k: torch.ones_like(p) for k, p in
                                 tparams.items()}, adamw_init(tparams))[1]
    opath = str(tmp_path / "opt.msgpack")
    save_checkpoint(opath, {"opt": opt})
    opt2 = load_checkpoint(opath, {"opt": adamw_init(tparams)})["opt"]
    assert isinstance(opt2, AdamWState) and int(opt2.step) == 1
    for k in tparams:
        assert torch.equal(opt2.mu[k], opt.mu[k])
        assert torch.equal(opt2.nu[k], opt.nu[k])
    assert set(read_checkpoint(opath)) == {f"opt/{f}/{k}" for f in
                                           ("mu", "nu") for k in tparams} \
        | {"opt/step"}


def test_pipeline_gives_jax_arrays():
    j = iter(JaxPipeline(512, 64, 4, seed=1))
    t = iter(SyntheticTokenPipeline(512, 64, 4, seed=1))
    for _ in range(3):
        a, b = next(j)["tokens"], next(t)["tokens"]
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_trainer_cli_runs_on_cpu(arch, tmp_path, capsys):
    """main(--smoke --steps 3 --device cpu) trains every arch: finite
    losses, the JAX trainer's lines, and a checkpoint the JAX package's
    loader reads."""
    ck = str(tmp_path / "ck.msgpack")
    out = train.main(["--arch", arch, "--smoke", "--steps", "3", "--batch",
                      "2", "--seq", "32", "--device", "cpu", "--log-every",
                      "1", "--ckpt", ck])
    text = capsys.readouterr().out
    assert f"[train] {arch} (smoke)" in text
    assert text.count("  step ") == 3 and "tok/s)" in text
    assert "[train] loss " in text and f"checkpoint -> {ck}" in text
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))
    jcfg = jax_smoke(arch)
    like = {"params": jax_build(jcfg).init(jax.random.PRNGKey(0))}
    back = jax_load(ck, like)["params"]
    for k, v in weights.flatten(jax.device_get(back)):
        assert np.array_equal(bits(weights._to_tensor(v)),
                              bits(out["params"][k])), k


def test_trainer_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train.main(["--smoke", "--steps", "1"])


def test_refuse_grad_guards_only_where_autograd_would_need_a_backward():
    """The kernel wrappers' guard (card route only): inputs that require
    grad raise while grad mode is on, and pass under torch.no_grad() or
    when no input requires grad."""
    from repro_torch.kernels import _build
    a, b = torch.zeros(2, requires_grad=True), torch.zeros(2)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("flash_seq_op", b, a)
    _build.refuse_grad("flash_seq_op", b, b)
    with torch.no_grad():
        _build.refuse_grad("flash_seq_op", a, b)
