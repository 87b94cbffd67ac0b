"""Per-architecture decode-state slots: the engine's cache contract.

The engine's unit of admission is a *slot*; what a slot holds depends on the
model family. This slice ports the dense family (``SlotKVCache``: per-token
KV rings, state O(L) in context, block-granular prefix reuse, migration
moves tokens x per-token-KV bytes). The constant-state families (Mamba-2,
RecurrentGemma) come with their slices.

Every implementation keeps the host bookkeeping (free list, rid -> slot /
context length / sampling params) and the device invariants the fused step
relies on: slot operations write the preallocated slabs in place, and
``extract_state``/``place_state`` give the cluster a family-agnostic
migration transfer (the payload's ``nbytes`` is the real wire cost that
``RuntimeCore`` records).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig


class StateSlotsBase:
    """Host bookkeeping shared by every decode-state implementation, plus
    the per-architecture capability flags the scheduling layer reads."""

    #: "block" — per-token KV, any block-aligned prefix is reusable;
    #: "exact" — constant-size recurrent state, only a full-length match.
    prefix_reuse: str = "exact"

    def __init__(self, n_slots: int, capacity: int):
        self.n_slots = n_slots
        self.capacity = capacity
        self.free = list(range(n_slots))
        self.slot_of: Dict[int, int] = {}       # rid -> slot
        self.len_of: Dict[int, int] = {}        # rid -> context length
        # rid -> (temperature, top_p, seed): sampling state is part of the
        # slot's serving state so it travels with the state on migration and
        # crash recovery; absent rid == greedy
        self.samp_of: Dict[int, Tuple[float, float, int]] = {}

    # ------------------------------------------------------------- alloc
    def alloc(self, rid: int) -> Optional[int]:
        if not self.free:
            return None
        s = self.free.pop()
        self.slot_of[rid] = s
        return s

    def release(self, rid: int) -> None:
        s = self.slot_of.pop(rid)
        self.len_of.pop(rid, None)
        self.samp_of.pop(rid, None)
        self._clear_slot(s)
        self.free.append(s)

    def advance(self, rid: int, n: int = 1) -> None:
        self.len_of[rid] += n

    # ----------------------------------------------------- device contract
    def slabs(self) -> tuple:
        """The device tensors a fused step updates in place, in the order
        the family's fused-step entry points expect them."""
        raise NotImplementedError

    def _clear_slot(self, slot: int) -> None:
        """Restore the released slot to the freshly-initialized state (zero
        recurrent state / invalid positions) so the next occupant's chunked
        prefill starts clean."""
        raise NotImplementedError

    # --------------------------------------------------------- migration
    def extract_state(self, rid: int) -> Tuple[List[torch.Tensor], int]:
        """(payload host tensors, context length) — the family-agnostic
        migration export; ``sum(p.nbytes for p in payload)`` is the real
        transfer size."""
        raise NotImplementedError

    def place_state(self, rid: int, payload: List[torch.Tensor],
                    length: int) -> None:
        """Inverse of :meth:`extract_state` into ``rid``'s allocated slot."""
        raise NotImplementedError

    def copy_prefix(self, src_rid: int, dst_rid: int, length: int) -> None:
        raise NotImplementedError


def make_state_slots(cfg: ModelConfig, n_slots: int, capacity: int,
                     device) -> StateSlotsBase:
    """Decode-state slots for ``cfg.family`` (the engine's cache seam)."""
    if cfg.family == "dense":
        from repro_torch.engine.kv_slots import SlotKVCache
        from repro_torch.weights import torch_dtype
        return SlotKVCache(cfg.n_layers, n_slots, capacity, cfg.n_kv_heads,
                           cfg.head_dim_, torch_dtype(cfg.dtype), device)
    if cfg.family == "ssm":
        raise NotImplementedError(
            "SSMStateSlots (Mamba-2) is not ported yet: it comes with the "
            "ssd_scan slice")
    if cfg.family == "hybrid":
        raise NotImplementedError(
            "RecurrentStateSlots (RecurrentGemma) is not ported yet: it "
            "comes with the rglru_scan slice")
    raise NotImplementedError(f"no decode-state slots for family "
                              f"{cfg.family!r}")
