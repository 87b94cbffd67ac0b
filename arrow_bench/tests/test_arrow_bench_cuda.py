"""A short run of each cell on the card through ``run.py``: the last line
is the result, with the keys the contract names, on the card it ran on."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "arrow_bench/run.py", "--workload",
                        workload, "--seed", str(2**31 + 3), "--seconds", "5",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    assert "setup_s" in line["metrics"]
