"""Build and load the hand-written Hopper kernels.

Each ``csrc/<name>.cu`` under a kernel package has a plain C interface. At
first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library in
the build directory (``REPRO_TORCH_BUILD_DIR``, else ``kernels/build/``
beside this file; both are git-ignored) and loaded with ``ctypes``. The
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a stale library is never loaded.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_HERE = Path(__file__).resolve().parent
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
SOURCES = {
    "flash_prefill": _HERE / "flash_prefill" / "csrc" / "flash_prefill.cu",
    "paged_attention": (_HERE / "paged_attention" / "csrc"
                        / "paged_attention.cu"),
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR", _HERE / "build"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the Hopper kernels are built "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return cand


def _lib_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = tuple(SOURCES), verbose: bool = False
          ) -> Dict[str, Path]:
    """Compile every missing library of ``names``, one ``nvcc`` per source,
    all started together. Returns name -> library path. Raises with the
    compiler's output if any build fails."""
    names = list(names)
    out = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else []) \
            + ["-o", str(tmp), str(SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc {SOURCES[n].name} failed:\n{log}")
            continue
        if verbose and log:
            print(f"[build {n}]\n{log}", flush=True)
        os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name`` (built at first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
