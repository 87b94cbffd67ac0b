"""The control at a size a test run holds: put in the program's place, the
plain reference in float8 makes ``correct`` false, on three seeds, where
the bf16 program's own served tokens of the same run lie within the
limit."""
import time

import pytest
import torch

from arrow_bench.bench import load_cell
from arrow_bench.harness import run_cell
from arrow_bench.tests.conftest import make_bench

# bf16 at these widths, 3 s windows, ~80 served tokens compared: sound
# runs read 0 to 0.030, the float8 control 0.195 to 0.311 (seeds 1-5,
# both families)
LIMIT = 0.08


@pytest.mark.parametrize("workload", ["tiny-dense.tiny", "tiny-ssm.tiny"])
def test_float8_control_fails_where_bf16_passes(tmp_path, workload):
    root, bench = make_bench(tmp_path, dtype="bfloat16", limit=LIMIT)
    cell = load_cell(root, workload, bench)
    torch.set_num_threads(2)
    for seed in (1, 2, 3):
        out = run_cell(cell, seed, 3.0, False, "cpu", time.perf_counter(),
                       control=True)
        s = out["info"]["sample"]
        assert out["correct"] is False, s
        assert out["compared"]["logit_gap"]["value"] == s["control_gap"]
        assert s["control_gap"] > LIMIT >= s["logit_gap"]
