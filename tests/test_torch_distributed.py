"""The port's distribution layer against the JAX package's, on the CPU.

The sharding rules are pure and are held to JAX's with ``==``: every
parameter leaf of the ten presets at model size 16 (the specs as plain
tuples, ``tuple(PartitionSpec)`` on the JAX side), each family's cache
leaves with and without the sequence split, and the dry-run's input specs,
support matrix, cache capacities and windows over the 40 combos.

The numerics run over gloo on a 2x4 ("data", "model") mesh of 8 spawned
ranks, float32 smoke configs with the JAX package's seeded weights, each
case held to the JAX package **unsharded** at 2e-5 (its variants are
sharding-only: JAX's own act_shard + seq_attn prefill equals its baseline
on an 8-device mesh of Auto axes): qwen3-1.7b's prefill step (baseline,
act_shard + seq_attn, the kernels' route, whose wrappers run their plain
versions on each rank's shards on the CPU), a decode step on a cache
placed by the cache rules (baseline, kv_seq_shard, the kernels' route), a
train step (loss and updated parameters),
olmoe-1b-7b's ``moe_ffn`` with expert parallelism and mamba2-370m's train
step (the train steps' loss, gradients and update; see
``test_sharded_train_step_matches_jax_unsharded``). The ranks spawn once
for the module; each case is its own test.

Last, ``build_dryrun`` and ``launch.dryrun._measure`` trace two steps at 2
layers on a fake 4x2 mesh, whose argument bytes must equal the per-device
bytes that JAX's specs give JAX's shapes, and the launcher's command line
writes an ok record for qwen3-1.7b x train_4k on the 16x16 fake mesh.
"""
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, InputShape,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed import steps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)
MESH = (2, 4)                     # ("data", "model"), 8 ranks
B, S, C = 4, 32, 48


def jax_mesh(data, model):
    """What the JAX rules read of a mesh: its axis names and sizes."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": data, "model": model})


def jflat(tree):
    from repro_torch.weights import flatten
    return dict(flatten(tree))


# ------------------------------------------------------------ pure rules


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch):
    """param_spec of every leaf of the full preset at model size 16, and of
    the optimizer state's moments, equals the JAX rule's."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jget
    from repro.distributed import sharding as jshd
    from repro.models import build_model as jbuild
    from repro.optim import adamw_init as jinit
    from repro_torch.optim import AdamWState
    from repro_torch.weights import param_shapes
    jshapes = jax.eval_shape(jbuild(jget(arch)).init, jax.random.PRNGKey(0))
    want = {p: (tuple(a.shape), tuple(jshd.param_spec(p, a.shape, 16)))
            for p, a in jflat(jshapes).items()}
    got = {p: (s, shd.param_spec(p, s, 16))
           for p, s, _ in param_shapes(get_config(arch))}
    assert got == want
    jopt = jax.eval_shape(jinit, jshapes)
    want_opt = {p: tuple(jshd.param_spec(p, a.shape, 16))
                for p, a in jflat({"mu": jopt.mu, "nu": jopt.nu}).items()}
    moments = {p: torch.empty(s, device="meta")
               for p, s, _ in param_shapes(get_config(arch))}
    specs = shd.param_specs(
        AdamWState(torch.zeros((), dtype=torch.int32), moments, moments),
        {"data": 16, "model": 16})
    assert specs.step == ()
    assert {f"{m}/{p}": spec for m in ("mu", "nu")
            for p, spec in getattr(specs, m).items()} == want_opt


CACHE_ARCHS = ["qwen3-1.7b", "qwen2-vl-2b", "olmoe-1b-7b", "mamba2-370m",
               "recurrentgemma-9b", "whisper-medium"]


def _zeros_batch(specs, lib):
    if lib == "jax":
        import jax.numpy as jnp
        return {k: jnp.zeros(v.shape, v.dtype) for k, v in specs.items()}
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in specs.items()}


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_equal_jax(arch):
    """Each family's cache leaves (a smoke prefill's, both packages) have
    the same paths and shapes, and cache_spec equals JAX's on meshes of
    model size 2 and 4, with and without the sequence split."""
    jax = pytest.importorskip("jax")
    from repro.configs import InputShape as JShape
    from repro.configs import get_smoke_config as jsmoke
    from repro.distributed import sharding as jshd
    from repro.distributed import steps as jsteps
    from repro.models import build_model as jbuild
    from repro_torch.models import build_model
    from repro_torch.weights import init_params
    shape = InputShape("t", 64, B, "decode")
    jcfg = jsmoke(arch)
    jm = jbuild(jcfg)
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jb = _zeros_batch(jsteps.prefill_like_specs_for_decode(
        jcfg, JShape("t", 64, B, "decode")), "jax")
    jcache = jflat(jax.eval_shape(
        lambda p, b: jm.prefill(p, b, cache_capacity=64)[1], jp, jb))
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tb = _zeros_batch(steps.prefill_like_specs_for_decode(cfg, shape), "torch")
    with torch.no_grad():
        _, cache = build_model(cfg).prefill(params, tb, 64)
    cache = jflat(cache)
    assert {p: tuple(t.shape) for p, t in cache.items()} == \
        {p: tuple(a.shape) for p, a in jcache.items()}
    for model in (2, 4):
        for seq in (False, True):
            mesh = {"data": 2, "model": model}
            for path, t in cache.items():
                assert shd.cache_spec(path, t.shape, mesh, seq_shard=seq) == \
                    tuple(jshd.cache_spec(path, t.shape, jax_mesh(2, model),
                                          seq_shard=seq)), (path, model, seq)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_jax(arch):
    """batch_specs, supports, cache_capacity, window_for and the batch
    rule over the four input shapes (40 combos, 39 supported)."""
    pytest.importorskip("jax")
    from repro.configs import INPUT_SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.distributed import sharding as jshd
    from repro.distributed import steps as jsteps
    cfg, jcfg = get_config(arch), jget(arch)
    for name, shape in INPUT_SHAPES.items():
        jshape = JSHAPES[name]
        assert steps.supports(cfg, shape) == jsteps.supports(jcfg, jshape)
        assert steps.cache_capacity(cfg, shape) == \
            jsteps.cache_capacity(jcfg, jshape)
        try:
            want = jsteps.window_for(jcfg, jshape)
        except ValueError:
            with pytest.raises(ValueError):
                steps.window_for(cfg, shape)
        else:
            assert steps.window_for(cfg, shape) == want
        got = steps.batch_specs(cfg, shape)
        want = jsteps.batch_specs(jcfg, jshape)
        assert {k: (v.shape, str(v.dtype).replace("torch.", ""))
                for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        for k, v in got.items():
            assert shd.batch_spec(v.shape, {"data": 16, "model": 16}) == \
                tuple(jshd.batch_spec(v.shape, jax_mesh(16, 16)))
    assert sum(steps.supports(get_config(a), s) for a in ARCH_IDS
               for s in INPUT_SHAPES.values()) == 39


def test_placements_follow_the_spec():
    """A tuple entry shards one dim over several mesh dims, major to
    minor; unnamed mesh dims replicate."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert shd.placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert shd.placements((None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements((("data", "pod"),), mesh)


# --------------------------------------------------------------- numerics


def _worker():
    """One rank of the 2x4 gloo mesh: runs every case on DTensors from the
    inputs in DIST_DIR/in.npz; rank 0 writes the whole results to
    DIST_DIR/out.pt."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import moe
    from repro_torch.optim import adamw_init
    from repro_torch.weights import from_tensors
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{os.environ['PORT']}",
        rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    d = Path(os.environ["DIST_DIR"])
    inp = {k: torch.from_numpy(v) for k, v in np.load(d / "in.npz").items()}

    def part(prefix):
        n = len(prefix)
        return {k[n:]: v for k, v in inp.items() if k.startswith(prefix)}

    def whole(tree):
        if isinstance(tree, dict):
            return {k: whole(v) for k, v in tree.items()}
        return tree.full_tensor() if isinstance(tree, DTensor) else tree

    out = {}
    qcfg = get_smoke_config("qwen3-1.7b")
    qp = shd.distribute_params(from_tensors(part("qwen/"), qcfg, "cpu"),
                               mesh)
    toks = steps.shard_batch({"tokens": inp["tokens"]}, mesh)
    pshape = InputShape("t", C, B, "prefill")
    variants = {"base": qcfg,
                "act_seq": qcfg.replace(act_batch_axes=("data",),
                                        attn_seq_axis="model"),
                "hopper": qcfg.replace(attn_impl="hopper")}
    for label, c in variants.items():
        _, prefill = steps.make_prefill_step(c, pshape)
        last, cache = prefill(qp, toks)
        out[f"prefill_{label}"] = {"last": whole(last), **whole(cache)}
        if label == "base":
            base_cache = whole(cache)
    dec = steps.shard_batch({"token": inp["token"], "pos": inp["pos"]}, mesh)
    for label, seq, impl in (("base", False, "reference"),
                             ("kv_seq", True, "reference"),
                             ("hopper", False, "hopper")):
        _, decode = steps.make_decode_step(qcfg.replace(attn_impl=impl),
                                           pshape)
        cache = shd.distribute_cache(
            {k: v.clone() for k, v in base_cache.items()}, mesh,
            seq_shard=seq)
        if seq:
            assert cache["k"].placements[1] == shd.placements(
                (None, None, "model", None, None), mesh)[1]
        logits, cache = decode(qp, cache, dec)
        out[f"decode_{label}"] = {"logits": whole(logits), **whole(cache)}
    tshape = InputShape("t", S, B, "train")
    for arch, key in (("qwen3-1.7b", "qwen"), ("mamba2-370m", "mamba")):
        cfg = get_smoke_config(arch)
        params = shd.distribute_params(
            from_tensors(part(f"{key}/"), cfg, "cpu"), mesh)
        _, train = steps.make_train_step(cfg, tshape)
        new, opt, loss = train(params, adamw_init(params),
                               steps.shard_batch(
                                   {"tokens": inp[f"{key}_train"]}, mesh))
        out[f"train_{key}"] = {"loss": whole(loss), "params": whole(new),
                               "mu": whole(opt.mu), "nu": whole(opt.nu)}
    ocfg = get_smoke_config("olmoe-1b-7b").replace(
        moe_ep_axis="model", moe_groups=MESH[0], act_batch_axes=("data",))
    lp = {k: shd.distribute(v, shd.param_spec(f"layers/moe/{k}", v.shape,
                                              MESH[1]), mesh)
          for k, v in part("moe/").items()}
    x = shd.distribute(inp["moe_x"], shd.batch_spec(inp["moe_x"].shape, mesh),
                       mesh)
    with implicit_replication():
        y, aux = moe.moe_ffn(ocfg, lp, x)
    out["moe_ep"] = {"y": whole(y), "aux": whole(aux)}
    if rank == 0:
        torch.save(out, d / "out.pt")
    dist.barrier()
    dist.destroy_process_group()


def _jax_refs(jp, inputs):
    """The JAX package's unsharded results of every case."""
    import jax
    import jax.numpy as jnp
    from repro.configs import InputShape as JShape
    from repro.configs import get_smoke_config as jsmoke
    from repro.distributed import steps as jsteps
    from repro.models import moe as jmoe
    from repro.optim import adamw_init as jinit
    refs = {}
    qcfg = jsmoke("qwen3-1.7b").replace(dtype="float32")
    _, prefill = jsteps.make_prefill_step(qcfg, JShape("t", C, B, "prefill"))
    last, cache = prefill(jp["qwen"], {"tokens": jnp.asarray(inputs["tokens"])})
    refs["prefill"] = {"last": last, **cache}
    _, decode = jsteps.make_decode_step(qcfg, JShape("t", C, B, "prefill"))
    logits, cache = decode(jp["qwen"], cache,
                           {"token": jnp.asarray(inputs["token"]),
                            "pos": jnp.asarray(inputs["pos"])})
    refs["decode"] = {"logits": logits, **cache}
    for arch, key in (("qwen3-1.7b", "qwen"), ("mamba2-370m", "mamba")):
        cfg = jsmoke(arch).replace(dtype="float32")
        _, train = jsteps.make_train_step(cfg, JShape("t", S, B, "train"))
        _, opt, loss = train(jp[key], jinit(jp[key]),
                             {"tokens": jnp.asarray(inputs[f"{key}_train"])})
        refs[f"train_{key}"] = {"loss": loss, "mu": jflat(opt.mu),
                                "nu": jflat(opt.nu), "params": jflat(jp[key])}
    ocfg = jsmoke("olmoe-1b-7b").replace(dtype="float32", moe_groups=MESH[0])
    y, aux = jmoe.moe_ffn(ocfg, jax.tree.map(lambda a: a[0],
                                             jp["olmoe"]["layers"]["moe"]),
                          jnp.asarray(inputs["moe_x"]))
    refs["moe_ep"] = {"y": y, "aux": aux}
    return jax.tree.map(np.asarray, refs)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(the 8 ranks' results, JAX's): the JAX package's seeded weights and
    numpy-seeded inputs go to the ranks through a file."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import build_model as jbuild
    jp = {key: jbuild(jsmoke(arch).replace(dtype="float32")).init(
        jax.random.PRNGKey(seed)) for key, arch, seed in (
        ("qwen", "qwen3-1.7b", 0), ("mamba", "mamba2-370m", 1),
        ("olmoe", "olmoe-1b-7b", 2))}
    rng = np.random.default_rng(5)
    vocab = get_smoke_config("qwen3-1.7b").vocab_size
    inputs = {
        "tokens": rng.integers(1, vocab, (B, S)).astype(np.int32),
        "token": rng.integers(1, vocab, (B, 1)).astype(np.int32),
        "pos": np.full((B,), S, np.int32),
        "qwen_train": rng.integers(1, vocab, (B, S)).astype(np.int32),
        "mamba_train": rng.integers(1, vocab, (B, S)).astype(np.int32),
        "moe_x": rng.standard_normal((B, 24, 128)).astype(np.float32)}
    arrays = dict(inputs)
    for key in ("qwen", "mamba"):
        arrays.update({f"{key}/{p}": np.asarray(a)
                       for p, a in jflat(jax.device_get(jp[key])).items()})
    arrays.update({f"moe/{p}": np.asarray(a[0]) for p, a in jflat(
        jax.device_get(jp["olmoe"]["layers"]["moe"])).items()})
    d = tmp_path_factory.mktemp("dist")
    np.savez(d / "in.npz", **arrays)
    world = MESH[0] * MESH[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "DIST_DIR": str(d),
           "PORT": str(_free_port()), "WORLD_SIZE": str(world),
           "OMP_NUM_THREADS": "1"}
    code = ("import sys; sys.path.insert(0, %r); "
            "import test_torch_distributed as t; t._worker()"
            % str(Path(__file__).parent))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, errs[0]
    return torch.load(d / "out.pt"), _jax_refs(jp, inputs)


CASES = {"prefill_base": "prefill", "prefill_act_seq": "prefill",
         "prefill_hopper": "prefill", "decode_base": "decode",
         "decode_kv_seq": "decode", "decode_hopper": "decode",
         "moe_ep": "moe_ep"}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_steps_match_jax_unsharded(sharded, case):
    """Every output of the case on the 2x4 mesh (logits, caches, loss,
    updated parameters, MoE output and load-balance term) equals the JAX
    package's unsharded one; positions exactly."""
    got, refs = sharded
    got, want = got[case], refs[CASES[case]]
    assert set(got) == set(want)
    for k, v in got.items():
        if k == "pos_map":
            assert np.array_equal(v.numpy(), want[k])
        else:
            np.testing.assert_allclose(v.detach().float().numpy(), want[k],
                                       err_msg=f"{case}/{k}", **TOL)


@pytest.mark.parametrize("arch", ["qwen", "mamba"])
def test_sharded_train_step_matches_jax_unsharded(sharded, arch):
    """One make_train_step step on the 2x4 mesh: the loss and the updated
    moments (the gradients, mu = 0.1 g and nu = 0.05 g^2 after one step)
    equal JAX's unsharded step's, and the updated parameters equal JAX's
    adamw_update of the same gradients. (Held to JAX's updated parameters
    directly, one element in ~10^5 can differ by more than 2e-5: the first
    AdamW step moves each weight by lr * g / (|g| + eps), so where |g| is
    near the float32 noise of a sum taken in another order, that noise
    moves the weight by up to lr.)"""
    import jax.numpy as jnp
    from repro.optim import adamw_init as jinit
    from repro.optim import adamw_update as jupdate
    got, refs = sharded
    got, want = got[f"train_{arch}"], refs[f"train_{arch}"]
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **TOL)
    for m in ("mu", "nu"):
        assert set(got[m]) == set(want[m])
        for k, v in got[m].items():
            np.testing.assert_allclose(v.numpy(), want[m][k],
                                       err_msg=f"{m}/{k}", **TOL)
    params = {k: jnp.asarray(v) for k, v in want["params"].items()}
    grads = {k: jnp.asarray(v.numpy() / np.float32(1 - 0.9))
             for k, v in got["mu"].items()}
    new, _ = jupdate(params, grads, jinit(params))
    assert set(got["params"]) == set(new)
    for k, v in got["params"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(new[k]),
                                   err_msg=f"params/{k}", **TOL)


# ---------------------------------------------------------------- dry-run


@pytest.fixture(scope="module")
def fake_mesh():
    """A 4x2 mesh over a fake process group of 8 ranks in this process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _local_bytes(shape, spec, itemsize, sizes) -> int:
    """Bytes of rank 0's shard of ``shape`` under a JAX spec."""
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        parts = 1
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            parts *= sizes[a]
        n *= -(-dim // parts)
    return n * itemsize


def _jax_argument_bytes(arch, shape_name, sizes) -> int:
    """Per-device argument bytes of JAX's dry-run step at 2 layers: its
    params (and optimizer state), cache and batch shapes under its specs."""
    jax = pytest.importorskip("jax")
    from repro.configs import INPUT_SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.distributed import sharding as jshd
    from repro.distributed import steps as jsteps
    from repro.models import build_model as jbuild
    from repro.optim import adamw_init as jinit
    mesh = jax_mesh(sizes["data"], sizes["model"])
    cfg = jget(arch).replace(n_layers=2)
    shape = JSHAPES[shape_name]
    m = jbuild(cfg)
    params = jflat(jax.eval_shape(m.init, jax.random.PRNGKey(0)))
    total = sum(_local_bytes(a.shape, jshd.param_spec(p, a.shape,
                                                      sizes["model"]),
                             a.dtype.itemsize, sizes)
                for p, a in params.items())
    if shape.kind == "train":
        opt = jax.eval_shape(jinit, jax.eval_shape(m.init,
                                                   jax.random.PRNGKey(0)))
        total += 2 * sum(_local_bytes(a.shape, jshd.param_spec(
            p, a.shape, sizes["model"]), 4, sizes) for p, a in params.items())
        total += opt.step.dtype.itemsize
    else:
        cache = jax.eval_shape(
            lambda p, b: m.prefill(p, b, cache_capacity=jsteps.cache_capacity(
                cfg, shape), window=jsteps.window_for(cfg, shape))[1],
            jax.eval_shape(m.init, jax.random.PRNGKey(0)),
            jsteps.prefill_like_specs_for_decode(cfg, shape))
        total += sum(_local_bytes(a.shape, jshd.cache_spec(p, a.shape, mesh),
                                  a.dtype.itemsize, sizes)
                     for p, a in jflat(cache).items())
    for v in jsteps.batch_specs(cfg, shape).values():
        total += _local_bytes(v.shape, jshd.batch_spec(v.shape, mesh),
                              v.dtype.itemsize, sizes)
    return total


@pytest.mark.parametrize("arch,shape", [("qwen3-1.7b", "decode_32k"),
                                        ("mamba2-370m", "train_4k")])
def test_dryrun_small_fake_mesh(fake_mesh, arch, shape):
    """The step traced once at 2 layers on fake tensors: per-device flops
    counted, and argument bytes those of JAX's specs over JAX's shapes."""
    from repro_torch.launch.dryrun import _measure
    rec = _measure(get_config(arch).replace(n_layers=2), INPUT_SHAPES[shape],
                   fake_mesh)
    assert rec["flops"] > 0
    assert rec["bytes_accessed"] > 0
    assert rec["memory"]["argument_bytes"] == _jax_argument_bytes(
        arch, shape, {"data": 4, "model": 2})


def test_dryrun_launcher_writes_ok_record(tmp_path):
    """The command line on the 16x16 fake mesh at the full config."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "train_4k", "--single-pod"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("[dryrun-record] ")][-1]
    import json
    rec = json.loads(Path(line.split(" ", 1)[1]).read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["flops"] > 0 and rec["memory"]["argument_bytes"] > 0
    assert rec["collective_bytes"].get("all-reduce", 0) > 0
    assert "flops_scanned_hlo" not in rec


def test_local_mesh_refuses_without_a_card(monkeypatch):
    from repro_torch.launch import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_local_mesh()
