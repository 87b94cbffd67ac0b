"""Build and load the hand-written Hopper kernels.

Each ``csrc/<name>.cu`` under a kernel package has a plain C interface. At
first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library in
the build directory (``REPRO_TORCH_BUILD_DIR``, else ``kernels/build/``
beside this file; both are git-ignored) and loaded with ``ctypes``. The
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a stale library is never loaded. The wrappers reach
their entry points through ``fn`` (the ctypes signature set once) and keep
their float32 scratch through ``scratch``, since the serving paths are
host-bound and a signature or a fresh ``torch.empty`` a call costs host time.

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
from typing import Dict, Iterable, Sequence, Tuple

import torch

_HERE = Path(__file__).resolve().parent
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
SOURCES = {
    "flash_prefill": _HERE / "flash_prefill" / "csrc" / "flash_prefill.cu",
    "paged_attention": (_HERE / "paged_attention" / "csrc"
                        / "paged_attention.cu"),
    "ssd_scan": _HERE / "ssd_scan" / "csrc" / "ssd_scan.cu",
    "rglru_scan": _HERE / "rglru_scan" / "csrc" / "rglru_scan.cu",
    "crc32": _HERE / "crc32" / "csrc" / "crc32.cu",
}
SM_COUNT = 132           # H100 SXM: the grids the launch plans aim to fill
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_SCRATCH: Dict[Tuple[str, int], torch.Tensor] = {}


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


def refuse_grad(what: str, *tensors) -> None:
    """The kernels have no backward: raise where autograd would want one,
    rather than hand back an output detached from its inputs (whose
    gradients would then be silently zero). Training runs the reference
    attention (``attn_impl="reference"``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no backward; an input "
                           "requires grad (train with "
                           "attn_impl='reference', or call under "
                           "torch.no_grad())")


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def fn(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel ``name``, returning a
    ``cudaError_t``, its ctypes signature set at the first call only."""
    f = _FNS.get((name, symbol))
    if f is None:
        f = getattr(load(name), symbol)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _FNS[(name, symbol)] = f
    return f


def scratch(name: str, device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` float32 values of kernel ``name``'s scratch on
    ``device``, kept between calls (grown when a call needs more). A kernel
    reads its scratch back before the next launch on the stream writes it
    again."""
    t = _SCRATCH.get((name, device.index))
    if t is None or t.numel() < n:
        t = torch.empty(n, dtype=torch.float32, device=device)
        _SCRATCH[(name, device.index)] = t
    return t


def stream(device: torch.device) -> int:
    """The current stream of ``device`` as a raw handle (the
    ``torch.cuda.current_stream`` object costs host time a call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
