"""The timed path: an ``ArrowEngineCluster`` built from a cell's files,
warmed up on the cell's own shapes, then driven open-loop through its
``ServingSystem`` API (``submit`` each request when it is due, ``step``
in a loop), with every request's tokens and their landing times recorded
by the harness.

Times are the cluster's clock (``WallClock``: seconds since its first
reading). Traffic starts at ``t0``, the clock's value once warm-up is over;
a request due at offset ``o`` has arrival ``t0 + o`` and is timed from
there, so a stall that delays its submission counts in its latency.

With a trace (``Recorder``) the harness also wraps, from this file, the
instance's ``dispatch_step`` and ``finalize_step`` and the cluster's
``_begin_transfer``: the host time of each, and, inside the profiled
slice, each dispatched step's work (its chunks and its decode rows with
their context lengths, from the harness's own request records), as host
integers without a device sync.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from arrow_bench import work
from arrow_bench.traffic import Arrival


@dataclass
class Req:
    """The harness's record of one request."""
    rid: int
    due: float                      # arrival on the cluster clock
    prompt: np.ndarray
    output_len: int
    submitted: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    times: List[float] = field(default_factory=list)
    handle: object = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def finished(self) -> bool:
        return self.handle is not None and self.handle.done

    @property
    def rejected(self) -> bool:
        return self.handle is not None and self.handle.rejected


@dataclass
class Dispatch:
    """One instance step dispatched inside the profiled slice."""
    n_slots: int
    capacity: int
    decode_ctx: List[int]                      # keys each decode row reads
    chunks: List[Tuple[int, int, int, bool]]   # (offset, length, width,
    #                                            final chunk of its prompt)


class Recorder:
    """Host spans around the program's calls and, while ``recording``, the
    work of each dispatched step."""

    def __init__(self, clock, reqs: Dict[int, Req]):
        self.clock = clock
        self.reqs = reqs
        self.recording = False
        self.worked = False
        self.spans: List[Tuple[float, float, str]] = []
        self.dispatches: List[Dispatch] = []
        self._undo = []

    def _wrap(self, owner, name: str, label: str, note=None):
        orig = getattr(owner, name)
        rec = self

        def wrapped(obj, *args, **kw):
            t0 = rec.clock.now()
            out = orig(obj, *args, **kw)
            rec.spans.append((t0, rec.clock.now(), label))
            rec.worked = True
            if note is not None and rec.recording:
                note(obj, out, *args)
            return out

        setattr(owner, name, wrapped)
        self._undo.append((owner, name, orig))

    def install(self):
        from repro_torch.engine.cluster import ArrowEngineCluster
        from repro_torch.engine.instance import EngineInstance
        self._wrap(EngineInstance, "dispatch_step", "dispatch_step",
                   self._note_dispatch)
        self._wrap(EngineInstance, "finalize_step", "finalize_step")
        self._wrap(ArrowEngineCluster, "_begin_transfer", "migration")
        return self

    def remove(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()

    def _note_dispatch(self, inst, out, decode_rids, chunks):
        if out is None:
            return
        ctx = [self.reqs[r].prompt_len + len(self.reqs[r].tokens)
               for r in decode_rids]
        cap = inst.capacity
        ch = [(cw.offset, cw.length,
               min(work.bucket32(cw.length, cap), cap - cw.offset),
               cw.offset + cw.length >= cw.total_len) for cw in chunks]
        self.dispatches.append(Dispatch(inst.kv.n_slots, cap, ctx, ch))


def build_cluster(cell, params, device, seed: int):
    from repro_torch.core.slo import SLO
    from repro_torch.engine.cluster import ArrowEngineCluster
    m = cell.mix
    return ArrowEngineCluster(
        cell.family.model_config(cell.conf), n_instances=m["n_instances"],
        n_prefill=m["n_prefill"], n_slots=m["n_slots"],
        capacity=m["capacity"], slo=SLO(m["slo_ttft_s"], m["slo_tpot_s"]),
        seed=seed, params=params, chunk_tokens=m["chunk_tokens"],
        policy=m["policy"], device=device)


def warm_up(cluster, cell, seed: int, vocab: int) -> None:
    """Serve the mix's warm-up requests ((prompt, output) lengths: the
    longest prompt a slot takes, so the largest chunk offsets, the largest
    migration and the scratch they need, and shorter ones) to the end, so
    that nothing is built, allocated or chosen for the first time inside
    the window."""
    from repro_torch.core.request import Request
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x3A7])
    handles = []
    for i, (n_in, n_out) in enumerate(cell.mix["warmup"]):
        prompt = rng.integers(1, vocab, size=n_in, dtype=np.int32)
        handles.append(cluster.submit(
            Request(-1 - i, arrival=0.0, input_len=n_in, output_len=n_out),
            prompt=prompt))
    cluster.drain(timeout=600.0)
    if not all(h.done for h in handles):
        raise RuntimeError("warm-up requests did not finish")
    if cluster.device.type == "cuda":
        torch.cuda.synchronize(cluster.device)


def serve(cluster, arrivals: List[Arrival], t0: float, until: float,
          reqs: Dict[int, Req], recorder: Optional[Recorder] = None,
          passes: Optional[list] = None, on_time=None) -> None:
    """Drive the cluster open-loop until its clock reads ``until``: submit
    each request at its due time ``t0 + due``, step, and sleep only while
    nothing is in flight. ``passes`` collects (start, end, worked) of each
    ``step()``; ``on_time(now)`` runs before each step (the window's
    marks, the profiler's start)."""
    from repro_torch.core.request import Request
    clock = cluster.clock
    todo = sorted(arrivals, key=lambda a: a.due)
    i = len([a for a in todo if a.rid in reqs])      # already submitted
    while True:
        now = clock.now()
        if now >= until:
            return
        if on_time is not None:
            on_time(now)
        while i < len(todo) and t0 + todo[i].due <= now:
            a = todo[i]
            r = Req(a.rid, t0 + a.due, a.prompt, a.output_len,
                    submitted=clock.now())

            def on_token(h, tok, t, r=r):
                r.tokens.append(int(tok))
                r.times.append(t)

            r.handle = cluster.submit(
                Request(a.rid, arrival=r.due, input_len=r.prompt_len,
                        output_len=a.output_len),
                prompt=a.prompt, on_token=on_token)
            reqs[a.rid] = r
            i += 1
        if recorder is not None:
            recorder.worked = False
        ta = clock.now()
        busy = cluster.step()
        if passes is not None:
            passes.append((ta, clock.now(),
                           recorder is not None and recorder.worked))
        if not busy:
            nxt = t0 + todo[i].due if i < len(todo) else until
            time.sleep(max(0.0, min(nxt, until) - clock.now()))
