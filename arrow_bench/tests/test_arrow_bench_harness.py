"""The harness end to end on the CPU at a small size: it finds cells,
configurations, mixes and metrics added as files; a sound run is correct;
each fault a serving cell can have, planted in the program, makes
``correct`` false; no JAX module is loaded; and ``run.py`` gives no result
without a card or without the program."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from arrow_bench.bench import load_cell
from arrow_bench.harness import forbidden_modules, run_cell

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 11


def run_tiny(root_bench, workload, trace=False, seconds=1.5):
    root, bench = root_bench
    cell = load_cell(root, workload, bench)
    torch.set_num_threads(2)
    return run_cell(cell, SEED, seconds, trace, "cpu", time.perf_counter())


def test_a_cell_mix_config_and_metric_added_as_files(tiny_bench):
    root, bench = tiny_bench
    (bench / "metrics" / "extra.finished.py").write_text(
        '"""Requests that finished."""\n\n\ndef read(run):\n'
        '    return sum(r.finished for r in run.requests)\n')
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["end_to_end"].append({"name": "extra.finished", "unit": "req",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["tiny-dense.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = load_cell(root, "tiny-dense.tiny", bench)
    assert cell.conf["name"] == "tiny-dense" and cell.mix["name"] == "tiny"
    assert cell.rate["rate_req_s"] == 6.0
    out = run_tiny(tiny_bench, "tiny-dense.tiny")
    assert out["correct"], out["info"]
    assert out["metrics"]["extra.finished"]["value"] > 0
    assert set(out["metrics"]) == {"ttft_p90_ms", "itl_p95_ms",
                                   "output_tok_s", "setup_s",
                                   "extra.finished"}
    assert list(out)[-2:] == ["compared", "info"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload", ["tiny-dense.tiny", "tiny-ssm.tiny"])
def test_sound_runs_are_correct_and_traced_runs_read_their_layers(
        tiny_bench, workload):
    out = run_tiny(tiny_bench, workload, trace=True)
    assert out["correct"], out["info"]
    assert out["info"]["sample"]["served_tokens"] >= 24
    # host readers need no device trace; the slice's readers need the card
    assert {"sched.migrated_mb_per_req", "engine.pass_ms"} <= \
        set(out["metrics"])
    assert out["info"]["migrations_in_window"] > 0


def _patch_token(monkeypatch):
    from repro_torch.engine import fused_step
    orig = fused_step.sample_tokens

    def altered(cfg, logits, *a):
        return (orig(cfg, logits, *a) + 1) % cfg.vocab_size
    monkeypatch.setattr(fused_step, "sample_tokens", altered)


def _patch_exchange(monkeypatch):
    """The migrated state never reaches the decode instance's slot."""
    from repro_torch.engine import kv_slots, state_slots

    def place_nothing(self, rid, payload, length):
        self.len_of[rid] = length
    monkeypatch.setattr(kv_slots.SlotKVCache, "place_state", place_nothing)
    monkeypatch.setattr(state_slots._FixedStateSlots, "place_state",
                        place_nothing)


def _patch_state(monkeypatch):
    """A decode step hands back its state unchanged."""
    from repro_torch.models import common
    monkeypatch.setattr(common, "write_slots", lambda *a: None)
    monkeypatch.setattr(common, "write_rows", lambda *a: None)


@pytest.mark.parametrize("workload", ["tiny-dense.tiny", "tiny-ssm.tiny"])
@pytest.mark.parametrize("fault", [_patch_token, _patch_exchange,
                                   _patch_state])
def test_each_fault_makes_the_run_incorrect(tiny_bench, monkeypatch,
                                            workload, fault):
    fault(monkeypatch)
    out = run_tiny(tiny_bench, workload)
    assert not out["correct"], out["info"]
    assert out["compared"]["logit_gap"]["value"] > \
        out["compared"]["logit_gap"]["limit"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    fake = type(sys)("repro")
    monkeypatch.setitem(sys.modules, "repro_torch_x", fake)
    assert "repro_torch_x" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", fake)
    monkeypatch.setitem(sys.modules, "jaxlib", fake)
    assert {"repro.core", "jaxlib"} <= set(forbidden_modules())


def test_a_run_loads_no_jax_module(tmp_path):
    """A whole small run in a fresh process, then the check ``run.py``
    makes: no top-level ``jax``, ``jaxlib``, ``flax`` or ``repro``."""
    code = (
        "import sys, time; sys.path[:0] = [%r, %r, %r]\n"
        "from pathlib import Path\n"
        "from conftest import make_bench\n"
        "from arrow_bench.bench import load_cell\n"
        "from arrow_bench.harness import run_cell, forbidden_modules\n"
        "root, bench = make_bench(Path(%r))\n"
        "out = run_cell(load_cell(root, 'tiny-dense.tiny', bench), 5, 1.0,"
        " False, 'cpu', time.perf_counter())\n"
        "print(out['correct'], forbidden_modules())\n"
        % (str(ROOT), str(ROOT / "src"), str(Path(__file__).parent),
           str(tmp_path)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "True []"


def test_run_py_gives_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py measures instead")
    r = subprocess.run([sys.executable, str(ROOT / "arrow_bench" / "run.py"),
                        "--workload", "qwen3-1.7b.code", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0 and r.stdout == ""


def test_run_py_gives_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "arrow_bench", tmp_path / "arrow_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "arrow_bench/run.py", "--workload",
                        "qwen3-1.7b.code", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert r.returncode != 0 and r.stdout == ""
    assert not (tmp_path / ".arrow_bench_cache").exists()



def test_the_knee_sweep_runs_the_cells_own_window(tiny_bench, capsys):
    """Two rates on one cluster through the harness's window: each reports
    its own requests, numbered apart, and lets them finish."""
    from arrow_bench import calibrate
    root, bench = tiny_bench
    torch.set_num_threads(2)
    calibrate.sweep(load_cell(root, "tiny-dense.tiny", bench), [3.0, 6.0],
                    1.0, SEED, 120.0, device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["rate"] for x in lines[1:]] == [3.0, 6.0]
    for x in lines[1:]:
        assert x["due"] > 0 and x["met_share"] == 1.0
        assert x["unfinished_after_drain"] == 0
        assert {"itl_p95_ms", "output_tok_s"} <= set(x["metrics"])
