"""The port's ``bench_kernels`` and ``roofline``.

On the CPU ``bench_kernels`` times only the plain versions, one row per
kernel and shape (crc32's at 1/1024 of its migration payloads); ``--device cuda`` without a card refuses. ``roofline``
reads a ``decode_32k`` record that the port's dry-run writes into a
temporary directory (under a time limit of its own) and finds decode not
compute-bound. ``model_flops`` equals the JAX package's
(``benchmarks/roofline.py``) wherever ``supports`` admits a shape, and
``analyse`` gives the JAX ``analyse``'s terms, ``dominant`` and
``useful_flops_ratio`` on the same records, the JAX module's peaks set to
the H100's. The card's case (every kernel within its tolerance at both shape
sets) is marked ``cuda`` and skips here. Results go to ``tmp_path``.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))          # the JAX benchmarks live at the root

from repro_torch.bench import bench_kernels, common, roofline  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.distributed.steps import supports  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

KERNELS = ("flash_prefill", "flash_prefill_dyn", "paged_attention",
           "ssd_scan", "rglru_scan")
# each set's rows: the five at the bench's and the main paths' shapes,
# crc32 at three migration payloads
ROWS = {"bench": KERNELS, "main": KERNELS, "migration": ("crc32",) * 3}


@pytest.fixture
def results(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path)
    return tmp_path


@pytest.fixture
def jax_roofline(monkeypatch):
    """The JAX package's roofline with its peaks set to the port's."""
    from benchmarks import roofline as jax_roofline
    monkeypatch.setattr(jax_roofline, "PEAK_FLOPS", roofline.H100.peak_flops)
    monkeypatch.setattr(jax_roofline, "HBM_BW", roofline.H100.hbm_bw)
    monkeypatch.setattr(jax_roofline, "ICI_BW", roofline.NVLINK_BW)
    return jax_roofline


def assert_analyse_matches(jax_roofline, rec):
    got, want = roofline.analyse(rec), jax_roofline.analyse(rec)
    for key in ("arch", "shape", "mesh", "compute_s", "memory_s",
                "collective_s", "dominant", "model_flops",
                "useful_flops_ratio", "collective_breakdown",
                "memory_per_device_gb"):
        assert got[key] == want[key], (rec["arch"], rec["shape"], key)
    assert got["flops_total"] == want["hlo_flops_total"]


@pytest.fixture
def one_thread():
    """The plain versions on one intra-op thread (a busy host stalls
    torch's pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def capture(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().strip().splitlines()


def test_bench_kernels_cpu_emits_one_plain_row_per_kernel_and_shape(
        results, one_thread):
    rows, lines = capture(bench_kernels.main, ["--device", "cpu"])
    assert tuple(ROWS) == bench_kernels.SETS
    assert len(lines) == sum(len(v) for v in ROWS.values())
    seen = set()
    for line in lines:
        name, us, derived = line.split(",", 2)
        _, kernel, label = name.split(".", 2)
        seen.add((kernel, label.split("_", 1)[0]))
        assert float(us) > 0
        assert derived.startswith("plain version only (cpu")
    assert seen == {(k, s) for s, ks in ROWS.items() for k in ks}
    assert all(r["plain_only"] for r in rows)
    saved = json.loads((results / "kernels.json").read_text())
    assert saved["device"] == "cpu" and len(saved["rows"]) == len(lines)


def test_bench_kernels_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_kernels.main([])


def test_bench_kernels_bounds():
    """The bound is the larger of bytes over the memory rate and
    operations over the peak, at the main path's flash shape."""
    case = bench_kernels.cases("main", torch.device("cpu"))[0]
    assert case.name == "flash_prefill"
    S, H, Hk, D = 128, 16, 8, 128
    assert case.bytes == 2 * (2 * S * H * D + 2 * S * Hk * D)
    assert case.flops == 4.0 * D * H * S * (S + 1) // 2
    ms, by = common.bound(case.bytes, case.flops, case.peak)
    assert by == "bytes" and ms == case.bytes / common.HBM_BYTES_PER_S * 1e3


@pytest.mark.cuda
def test_bench_kernels_on_the_card(results):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows = bench_kernels.main(["--device", "cuda"])
    assert len(rows) == sum(len(v) for v in ROWS.values())
    assert all(r["within_tol"] for r in rows)


def test_roofline_reads_a_decode_32k_record(monkeypatch, results, tmp_path,
                                            jax_roofline):
    """The port's dry-run writes a real decode_32k record; decode is never
    compute-bound, and the JAX ``analyse`` reads the record the same."""
    records = tmp_path / "dryrun_torch"
    code = ("import pathlib, sys\n"
            "from repro_torch.launch import dryrun\n"
            "dryrun.RESULTS_DIR = pathlib.Path(sys.argv[1])\n"
            "sys.exit(dryrun.main(['--arch', 'qwen3-1.7b', '--shape', "
            "'decode_32k', '--single-pod']))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code, str(records)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    monkeypatch.setattr(dryrun, "RESULTS_DIR", records)
    rows, lines = capture(roofline.main, [])
    assert len(rows) == len(lines) == 1
    row = rows[0]
    assert (row["arch"], row["shape"], row["mesh"]) == \
        ("qwen3-1.7b", "decode_32k", "16x16")
    assert row["n_dev"] == 256
    assert row["dominant"] != "compute"
    assert row["memory_s"] > row["compute_s"]
    name, us, derived = lines[0].split(",", 2)
    assert name == "roofline.qwen3-1.7b.decode_32k"
    assert "dominant=compute" not in derived
    assert "(unfused bytes)" in derived
    assert float(us) == pytest.approx(
        max(row["compute_s"], row["memory_s"], row["collective_s"]) * 1e6,
        rel=1e-3)
    recs = dryrun.load_results()
    assert len(recs) == 1
    assert_analyse_matches(jax_roofline, recs[0])


def test_roofline_terms_use_the_h100_constants():
    rec = {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "2x16x16",
           "flops": 989e12, "bytes_accessed": 3.35e12,
           "collective_bytes": {"all-reduce": 300e9, "all-gather": 150e9},
           "memory": {"argument_bytes": 2**30, "temp_bytes": 2**30}}
    a = roofline.analyse(rec)
    assert a["n_dev"] == 512
    assert (a["compute_s"], a["memory_s"], a["collective_s"]) == (1.0, 1.0,
                                                                  1.0)
    assert a["memory_per_device_gb"] == 2.0


def supported():
    return [(arch, sname) for arch in ARCH_IDS
            for sname, shape in INPUT_SHAPES.items()
            if supports(get_config(arch), shape)]


def test_model_flops_analytics_positive(jax_roofline):
    """Positive, and equal to the JAX package's, for every pair."""
    for arch, sname in supported():
        got = roofline.model_flops(arch, sname)
        assert got > 0, (arch, sname)
        assert got == jax_roofline.model_flops(arch, sname), (arch, sname)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_analyse_matches_the_jax_analyse(jax_roofline, mesh):
    """On seeded records of every supported pair, at scales that make each
    of the three terms the dominant one in turn."""
    rng = np.random.default_rng(0)
    scales = ((1e15, 1e9, 1e6), (1e12, 1e13, 1e6), (1e12, 1e9, 1e12))
    dominant = set()
    for i, (arch, sname) in enumerate(supported()):
        flops, bytes_, coll = (float(s * rng.uniform(0.5, 2.0))
                               for s in scales[i % 3])
        rec = {"arch": arch, "shape": sname, "mesh": mesh,
               "flops": flops, "bytes_accessed": bytes_,
               "collective_bytes": {"all-reduce": coll,
                                    "all-gather": coll / 3},
               "memory": {"argument_bytes": int(rng.integers(1, 2**34)),
                          "temp_bytes": int(rng.integers(1, 2**34))}}
        assert_analyse_matches(jax_roofline, rec)
        dominant.add(roofline.analyse(rec)["dominant"])
    assert dominant == {"compute", "memory", "collective"}
