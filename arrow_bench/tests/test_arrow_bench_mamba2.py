"""Mamba-2 as published in the benchmark (``families/mamba2.py``,
``configs/mamba2-370m.published.json``): the family loads with the cell and
gives the program the published norm eps and float32 residual; a program
without those fields is refused as the family loads, and one that runs
either the JAX package's eps or a bf16 stream is refused by the family's
probe; the configuration holds the published widths and cuts nothing; and
a small Mamba-2 cell through ``run_cell`` on the CPU is correct."""
import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from arrow_bench.bench import load_cell, load_module
from arrow_bench.harness import run_cell
from arrow_bench.tests.conftest import TINY_SSM, make_bench

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 27
CELL = "mamba2-370m.conv"
# the decode-heavy cells' metrics, and the scan kernel's roofline
METRICS = ("sched.migrated_mb_per_req.decode", "engine.pass_ms.decode",
           "model.step_mfu.decode", "device.idle_frac.decode",
           "ssd_scan_roofline")


def test_the_family_loads_with_the_cell():
    cell = load_cell(ROOT, CELL)
    assert cell.conf["family"] == "mamba2" and cell.mix["name"] == "conv"
    assert cell.family.REFERENCE == "ssm"
    assert cell.family.KERNELS == ("ssd_scan",)
    cfg = cell.family.model_config(cell.conf)
    assert (cfg.family, cfg.norm_eps, cfg.residual_in_fp32) == \
        ("ssm", 1e-5, True)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.dtype,
            cfg.attn_impl) == (48, 1024, 50277, "bfloat16", "hopper")
    assert cfg.ssm.n_heads(cfg.d_model) == 32 and cfg.ssm.chunk == 128
    assert [m["name"] for m in cell.metrics(True)] == list(METRICS)
    assert {m["name"] for m in cell.metrics(False)} == {"output_tok_s",
                                                        "setup_s"}


@pytest.mark.parametrize("fault", [{"residual_in_fp32": False},
                                   {"norm_eps": 1e-6}],
                         ids=["bf16_stream", "jax_eps"])
def test_the_probe_refuses_a_program_off_the_published_model(fault):
    """On the CPU at the published widths (the probe's depth and
    vocabulary): the fault's property reads beyond its limit, and the
    other property's reading stays within its own."""
    cell = load_cell(ROOT, CELL)
    cfg = cell.family.ssm.model_config(cell.conf).replace(
        **{"norm_eps": 1e-5, "residual_in_fp32": True, **fault})
    prop = "residual_in_fp32" if "residual_in_fp32" in fault else "norm_eps"
    other = ({"residual_in_fp32", "norm_eps"} - {prop}).pop()
    with pytest.raises(RuntimeError, match=prop) as e:
        cell.family.check(cell.conf, cfg, "cpu")
    assert other not in str(e.value)


def test_a_program_without_the_fields_is_refused(monkeypatch):
    from repro_torch.configs import base
    fields = [(f.name, f.type, f) for f in dataclasses.fields(base.ModelConfig)
              if f.name not in ("norm_eps", "residual_in_fp32")]
    monkeypatch.setattr(base, "ModelConfig",
                        dataclasses.make_dataclass("ModelConfig", fields))
    with pytest.raises(ImportError, match="norm_eps"):
        load_module(ROOT / "arrow_bench" / "families" / "mamba2.py",
                    "arrow_bench_family_mamba2_old")


def test_the_configuration_has_the_published_widths():
    conf = json.loads((ROOT / "arrow_bench" / "configs"
                       / "mamba2-370m.published.json").read_text())
    assert conf["ssm_cfg"] == {"layer": "Mamba2", "d_state": 128,
                               "d_conv": 4, "expand": 2, "headdim": 64,
                               "ngroups": 1}
    assert (conf["d_model"], conf["n_layer"], conf["vocab_size"]) == \
        (1024, 48, 50277)
    assert (conf["norm_epsilon"], conf["residual_in_fp32"],
            conf["tie_embeddings"], conf["torch_dtype"]) == \
        (1e-5, True, True, "bfloat16")
    assert conf["reduced"] == [] and conf["ssm_chunk"] == 128
    limit = conf["correct"]["max_logit_gap"]
    assert limit is not None and 0 < limit
    assert set(conf["correct"]["probe_rel_rms"]) == {"norm_eps",
                                                    "residual_in_fp32"}


def test_a_small_published_cell_is_correct(tmp_path):
    """The tiny ssm configuration under the mamba2 family with the
    published eps and stream, in float32 at the tiny cells' limit. In
    float32 the stream's dtype changes nothing and the probe of a sound
    program reads rounding (under 1e-6), the JAX eps 0.019: both limits
    1e-3."""
    root, bench = make_bench(tmp_path)
    conf = dict(TINY_SSM, name="tiny-mamba2", family="mamba2",
                norm_epsilon=1e-5, residual_in_fp32=True,
                correct={**TINY_SSM["correct"], "probe_rel_rms": {
                    "norm_eps": 1e-3, "residual_in_fp32": 1e-3}})
    (bench / "configs" / "tiny-mamba2.json").write_text(json.dumps(conf))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny-mamba2", "source": "test",
                         "file": "arrow_bench/configs/tiny-mamba2.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tiny-mamba2.tiny",
                           "config": "tiny-mamba2", "traffic": "tiny",
                           "chips": 1, "why": "test"})
    for metric in m["per_layer"]:
        if metric["name"] in METRICS:
            metric["workloads"].append("tiny-mamba2.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    (bench / "cells" / "tiny-mamba2.tiny.json").write_text(
        json.dumps({"rate_req_s": 6.0}))
    cell = load_cell(root, "tiny-mamba2.tiny", bench)
    assert cell.family.model_config(cell.conf).residual_in_fp32
    torch.set_num_threads(2)
    out = run_cell(cell, SEED, 1.5, True, "cpu", time.perf_counter())
    assert out["correct"], out["info"]
    assert out["info"]["sample"]["served_tokens"] >= 24
    assert out["info"]["migrations_in_window"] > 0
    # host readers need no device trace; the slice's readers need the card
    assert "engine.pass_ms.decode" in out["metrics"]
