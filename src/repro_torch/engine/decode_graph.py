"""The constant-state (ssm) family's greedy decode step, captured once in a
CUDA graph and replayed on every decode dispatch it fits.

An eager Mamba-2 decode step enqueues some 60 kernels a layer from the
host; the replay enqueues the step as one graph launch. It fits because
the step has one shape whatever the rows: the batch is always every slot,
the parked rows masked on the device (``ssm.decode_step`` with a bool
mask), and the state slabs are written in place and never reallocated.

The graph reads device buffers this object owns: ``inp`` (2, B) int32, the
step's tokens in row 0 and its active-row mask in row 1, uploaded before
each replay from a pinned staging buffer; the slabs and the weights, read
where they lie; and it writes the argmax tokens into ``out``, which each
replay clones on the stream, so a step not yet fetched keeps its tokens
when the next replay overwrites ``out``. Positions are not read by the
recurrence, so nothing of them is uploaded.

Which steps replay is decided by what the instance observes (``fits``):
a graph is built for an ``ssm`` instance whose slabs are CUDA tensors and
not DTensors, and a step replays it when every decoding row is greedy.
Every other step runs the eager fused step unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine import fused_step as fs
from repro_torch.models import common as cm

# eager runs on the capture's side stream before the capture (the side
# stream's cuBLAS handle and workspace are made outside the graph)
WARMUP_RUNS = 2


def fits(cfg, slabs) -> bool:
    """A graph is built for this instance: the ssm family, on CUDA tensors
    that are not DTensors."""
    return cfg.family == "ssm" and all(
        t.is_cuda and not isinstance(t, cm.DTensor) for t in slabs)


class SSMDecodeGraph:
    """One instance's captured greedy decode step over its slots' slabs.
    ``captures`` and ``replays`` count since construction."""

    def __init__(self, cfg, params, slots):
        self.cfg, self.params, self.slots = cfg, params, slots
        B = slots.n_slots
        dev = slots.conv.device
        self.device = dev
        self.inp = torch.zeros((2, B), dtype=torch.int32, device=dev)
        self.staged = torch.zeros((2, B), dtype=torch.int32,
                                  pin_memory=True)
        self.uploaded = torch.cuda.Event()     # staged's last upload
        self.graph = None
        self.out = None
        self.ptrs = None
        self.captures = 0
        self.replays = 0
        self.capture()

    def _slab_ptrs(self):
        return tuple(t.data_ptr() for t in self.slots.slabs())

    def _step(self) -> torch.Tensor:
        return fs.ssm_decode_greedy(self.cfg, self.params,
                                    *self.slots.slabs(),
                                    self.inp[0].view(-1, 1),
                                    self.inp[1] != 0)

    def capture(self) -> None:
        """(Re)capture over the slabs as they are now. Every row is parked
        while the warm-up runs, so they change no state."""
        cur = torch.cuda.current_stream(self.device)
        self.inp.zero_()
        if self.graph is not None:
            self.graph.reset()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.device(self.device):
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    self._step()
            cur.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.out = self._step()
        self.graph = graph
        self.ptrs = self._slab_ptrs()
        self.captures += 1

    def replay(self, tokens: np.ndarray, active: np.ndarray
               ) -> torch.Tensor:
        """Enqueue one decode step of host ``tokens`` (B, 1) over the rows
        ``active`` (B,) bool -> (B,) int32 tokens on the device, a tensor
        of its own."""
        if self._slab_ptrs() != self.ptrs:
            self.capture()
        # the staging buffer is rewritten only once its last upload ran
        self.uploaded.synchronize()
        st = self.staged.numpy()
        st[0] = tokens[:, 0]
        st[1] = active
        self.inp.copy_(self.staged, non_blocking=True)
        self.uploaded.record(torch.cuda.current_stream(self.device))
        self.graph.replay()
        self.replays += 1
        return self.out.clone()
