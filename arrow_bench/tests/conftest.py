"""A small copy of the benchmark for the CPU tests: the harness's files
copied into a temporary root, with small configurations (``tiny-dense``,
``tiny-ssm``), a small mix (``tiny``) and their cells added as new files
beside the real ones, and a manifest that names them."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# At the published widths a layer's update to the residual stream is of
# order one (0.02^2 x 2048 = 0.8) and the context decides the next token;
# at these widths the same holds with matrices drawn at 0.08
# (0.08^2 x 128 = 0.8). At 0.02 the tied embedding would decide it, and a
# fault in the context would go unseen.
TINY_DENSE = {
    "name": "tiny-dense", "source": "test", "family": "dense",
    "head_dim": 32, "hidden_size": 128, "intermediate_size": 256,
    "max_position_embeddings": 4096, "num_attention_heads": 4,
    "num_hidden_layers": 2, "num_key_value_heads": 2, "rms_norm_eps": 1e-6,
    "rope_theta": 1000000, "tie_word_embeddings": True,
    "torch_dtype": "float32", "vocab_size": 512, "reduced": [],
    "init_std": 0.08, "correct": {"max_logit_gap": 1e-3}}
TINY_SSM = {
    "name": "tiny-ssm", "source": "test", "family": "ssm", "d_model": 128,
    "n_layer": 2, "vocab_size": 512,
    "ssm_cfg": {"layer": "Mamba2", "d_state": 16, "d_conv": 4, "expand": 2,
                "headdim": 32, "ngroups": 1},
    "norm_epsilon": 1e-6, "tie_embeddings": True, "torch_dtype": "float32",
    "ssm_chunk": 16, "reduced": [], "init_std": 0.08,
    "correct": {"max_logit_gap": 1e-3}}
TINY_MIX = {
    "name": "tiny", "in_median": 48, "in_sigma": 0.8, "out_median": 5,
    "out_sigma": 0.5, "in_out_corr": 0.5, "min_input": 4,
    "max_input": 512, "max_output": 16, "schedule_seed": 0,
    "preroll_s": 0.3, "preroll_burst": 2, "slo_ttft_s": 30.0,
    "slo_tpot_s": 30.0, "policy": "arrow", "n_instances": 2,
    "n_prefill": 1, "n_slots": 4, "capacity": 128, "chunk_tokens": 32,
    "warmup": [[100, 2], [20, 2]], "sample_tokens": 80,
    "profile_slice_s": 0.5}


def make_bench(dst: Path, dtype: str = "float32", rate: float = 6.0,
               limit: float = 1e-3):
    """``dst`` holds BENCHMARK.json and ``arrow_bench/`` (a copy with the
    tiny files added), the configurations in ``dtype`` with ``limit`` as
    their ``max_logit_gap``. Returns (root, bench_dir)."""
    bench = dst / "arrow_bench"
    shutil.copytree(ROOT / "arrow_bench", bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for conf in (TINY_DENSE, TINY_SSM):
        c = dict(conf, torch_dtype=dtype,
                 correct={"max_logit_gap": limit})
        (bench / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
        manifest["configs"].append({
            "name": c["name"], "source": "test",
            "file": f"arrow_bench/configs/{c['name']}.json", "reduced": [],
            "why": "test"})
        w = f"{c['name']}.tiny"
        manifest["workloads"].append({"name": w, "config": c["name"],
                                      "traffic": "tiny", "chips": 1,
                                      "why": "test"})
        (bench / "cells" / f"{w}.json").write_text(
            json.dumps({"rate_req_s": rate}))
        kernel = ("ssd_scan_roofline",) if c["family"] == "ssm" else (
            "flash_attn_roofline", "paged_attention_roofline")
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if "workloads" in m and (not m["name"].endswith("_roofline")
                                     or m["name"] in kernel):
                m["workloads"].append(w)
    (bench / "mixes" / "tiny.json").write_text(json.dumps(TINY_MIX))
    (dst / "BENCHMARK.json").write_text(json.dumps(manifest))
    return dst, bench


@pytest.fixture
def tiny_bench(tmp_path):
    return make_bench(tmp_path)
