"""Wrapper of the RG-LRU scan kernel.

``rglru_scan_op(log_a, gated, h0=None)`` takes log_a and gated (B,S,W) and
an optional initial state h0 (B,W), and returns (h (B,S,W), h_final (B,W))
in float32, for any S >= 1 and any W (the TPU kernel's VMEM tile sizes
``bs``/``bw`` have no counterpart). On a CUDA tensor it launches the Hopper
kernel of ``csrc/rglru_scan.cu`` (or raises); on a CPU tensor it runs the
plain-torch version in ``ref.py``. ``plan`` says how a call is cut (route,
cluster of S segments, rounds), from the static shapes alone, in Python so
the CPU tests reach it. Launches are counted in ``rglru_scan_op.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import SM_COUNT
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

TILE = 32                # channels of a cluster-route block (128 bytes)
WARPS = 4                # runs of a segment, one a warp (the kernel's)
SEG_MAX = 64             # steps a block stages a round
MIN_SEG = 16             # a segment gets at least this many steps
MAX_CLUSTER = 8          # the portable thread block cluster size
BLOCKS_PER_SM = 4        # the grid the plan aims for
CH_THREADS = 64          # the channel route's block
ROUTES = {"channel": 0, "cluster": 1}


class RglruPlan(NamedTuple):
    """How the kernel cuts one call. ``route``: "cluster" (W a multiple of
    32): each (b, 32-channel tile) is one thread block cluster of
    ``cluster`` blocks, block k staging steps [(r * cluster + k) * seg,
    + seg) of round r in shared memory and walking them as ``WARPS`` runs
    of ``run`` steps; ``rounds`` rounds cover S. "channel" (any other W):
    one thread walks each channel through all of S."""
    route: str
    cluster: int
    seg: int
    run: int
    rounds: int
    blocks: int
    smem: int


def layout(S: int, cluster: int) -> Tuple[int, int, int, int]:
    """(cluster, seg, run, rounds) of the cluster route for S steps split
    over at most ``cluster`` segments: segments of at most ``SEG_MAX``
    steps, no block of the first round without a step."""
    seg = min(SEG_MAX, -(-S // cluster))
    cluster = min(cluster, -(-S // seg))
    return cluster, seg, -(-seg // WARPS), -(-S // (cluster * seg))


def segment(pl: RglruPlan, S: int, r: int, k: int) -> Tuple[int, int]:
    """Steps [t0, t1) that block k stages in round r (the kernel's ``t0``
    and ``n``); empty past S."""
    t0 = (r * pl.cluster + k) * pl.seg
    return min(t0, S), min(t0 + pl.seg, S)


@functools.lru_cache(maxsize=1024)
def plan(B: int, S: int, W: int, sm_count: int = SM_COUNT) -> RglruPlan:
    """The launch plan of one call (pure arithmetic on the shapes). Splits
    S over a cluster of blocks until ``B * W / 32 * cluster`` fills
    ``BLOCKS_PER_SM`` blocks on every SM, keeping ``MIN_SEG`` steps a
    segment; ``cluster`` is 1 when the tiles alone fill the card. Cached:
    the engine repeats a few chunk lengths."""
    if B < 1 or S < 1 or W < 1:
        raise ValueError(f"no rglru_scan plan for B={B}, S={S}, W={W}")
    if W % TILE:
        return RglruPlan("channel", 1, S, S, 1, B * -(-W // CH_THREADS), 0)
    tiles = B * (W // TILE)
    want = BLOCKS_PER_SM * sm_count // tiles
    K, seg, run, rounds = layout(
        S, max(1, min(MAX_CLUSTER, want, -(-S // MIN_SEG))))
    # dynamic shared memory: log_a and gated for seg steps of TILE channels,
    # twice when the next round is staged while one is computed
    smem = (2 if rounds > 1 else 1) * 2 * seg * TILE * 4
    return RglruPlan("cluster", K, seg, run, rounds, tiles * K, smem)


def _check(log_a, gated, h0):
    if log_a.dim() != 3 or log_a.shape != gated.shape:
        raise ValueError(f"want log_a, gated (B,S,W); got "
                         f"{tuple(log_a.shape)}, {tuple(gated.shape)}")
    B, S, W = log_a.shape
    if S < 1:
        raise ValueError("rglru_scan needs at least one step (S >= 1)")
    if h0 is not None and tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 {tuple(h0.shape)} is not (B,W) = {(B, W)}")
    ts = (log_a, gated) + ((h0,) if h0 is not None else ())
    if len({t.device for t in ts}) != 1:
        raise ValueError("all inputs must be on one device")


# the C entry points: log_a, gated, h0, h, h_final, B, S, W, route,
# cluster, seg, run, rounds, stream; and route, cluster, seg, rounds, then
# five int outputs
LAUNCH = ("rglru_scan", "rglru_scan_launch",
          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
ATTRS = ("rglru_scan", "rglru_scan_attrs",
         [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 5)


def kernel_attrs(pl: RglruPlan) -> dict:
    """Registers, local-memory (spill) bytes, shared memory, resident
    blocks an SM and (cluster route) the clusters of ``pl.cluster`` blocks
    the card holds at once, of ``pl``'s route, as the CUDA runtime reports
    them (card only)."""
    r, lo, sm, bl, mc = (ctypes.c_int() for _ in range(5))
    err = _build.fn(*ATTRS)(ROUTES[pl.route], pl.cluster, pl.seg, pl.rounds,
                            ctypes.byref(r), ctypes.byref(lo),
                            ctypes.byref(sm), ctypes.byref(bl),
                            ctypes.byref(mc))
    _build.check(err, "rglru_scan_attrs")
    return {"kernel": f"rglru_{pl.route}", "registers": r.value,
            "local_bytes": lo.value, "smem_bytes": sm.value,
            "blocks_per_sm": bl.value, "cluster": pl.cluster,
            "max_active_clusters": mc.value}


def _f32(t, align: bool = False):
    """``t`` as contiguous float32, copied only when it is not already (or,
    with ``align``, when its data is not 16-byte aligned, as the cluster
    route's 16-byte copies need)."""
    if t.dtype != torch.float32:
        t = t.float()
    t = t if t.is_contiguous() else t.contiguous()
    return t.clone() if align and t.data_ptr() % 16 else t


def _rglru_cuda(log_a, gated, h0):
    B, S, W = log_a.shape
    pl = plan(B, S, W)
    vec = pl.route == "cluster"
    la, g = _f32(log_a, vec), _f32(gated, vec)
    h0 = None if h0 is None else _f32(h0)
    h = torch.empty((B, S, W), dtype=torch.float32, device=la.device)
    hT = torch.empty((B, W), dtype=torch.float32, device=la.device)
    err = _build.fn(*LAUNCH)(la.data_ptr(), g.data_ptr(),
                             None if h0 is None else h0.data_ptr(),
                             h.data_ptr(), hT.data_ptr(), B, S, W,
                             ROUTES[pl.route], pl.cluster, pl.seg, pl.run,
                             pl.rounds, _build.stream(la.device))
    _build.check(err, "rglru_scan_launch")
    return h, hT


def rglru_scan_op(log_a, gated, h0=None):
    """h_t = exp(log_a_t) * h_{t-1} + gated_t over (B,S,W), seeded from h0
    (B,W) or zeros. Returns (h (B,S,W), h_final (B,W)), float32."""
    _check(log_a, gated, h0)
    if log_a.is_cuda:
        _build.refuse_grad("rglru_scan_op", log_a, gated,
                           *([] if h0 is None else [h0]))
        rglru_scan_op.launches += 1
        return _rglru_cuda(log_a, gated, h0)
    if log_a.device.type != "cpu":
        raise RuntimeError(f"no rglru_scan kernel for device {log_a.device}")
    return rglru_scan_ref(log_a, gated, h0)


rglru_scan_op.launches = 0
