"""``BENCHMARK.json`` against the rules its readers hold it to, and every
name in it against a file of its own."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "arrow_bench"
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection", "head",
          "expand")


def test_top_level_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["arrow_bench"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    n = len(M["workloads"])
    # a full check, with the cells a later PR may add, fits its budget
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= n <= 24 and 1 <= len(M["configs"]) <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(not w.startswith("/") and ".." not in w
               for w in M["command"])


def test_configs():
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("arrow_bench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert not any(k.endswith(("_dim", "_rank")) or any(
            w in k for w in WIDTHS) for k in c["reduced"])
        assert (BENCH / "families" / f"{conf['family']}.py").exists()
        assert 1 <= len(c["why"]) <= 200


def test_cells():
    names = [w["name"] for w in M["workloads"]]
    assert len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in M["workloads"]}
    assert len(pairs) == len(names)
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (BENCH / "mixes" / f"{w['traffic']}.json").exists()
        rate = json.loads((BENCH / "cells" / f"{w['name']}.json").read_text())
        assert rate["rate_req_s"] > 0
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= 1


def reported(cell, kind):
    return {m["name"] for m in M[kind]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in M["workloads"]}
    keys = {"name", "unit", "better", "source", "workloads"}
    keys |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
    for m in M[kind]:
        assert set(m) <= keys and set(m) >= keys - {"workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            for c in m.get("workloads", cells):
                assert m["moves"] in reported(c, "end_to_end")
            if m["name"].endswith("_roofline") or "mfu" in m["name"]:
                assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    layers = {m["layer"] for m in M["per_layer"]}
    text = (ROOT / "PERF.md").read_text()
    assert all(layer in text for layer in layers)
    for w in M["workloads"]:
        e2e = reported(w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reported(w["name"], "per_layer")
    assert [m["bound"] for m in M["end_to_end"]
            if m["name"] == "setup_s"] == [0.25]
