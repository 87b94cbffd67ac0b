"""Per-architecture decode-state slots: the engine's cache contract.

The engine's unit of admission is a *slot*; what a slot holds depends on the
model family:

  dense   — per-token KV rings (``SlotKVCache``): state grows O(L) with
            context, prefix reuse works at block granularity, migration
            moves tokens x per-token-KV bytes.
  ssm     — Mamba-2 ``{"conv", "ssm"}`` slabs (``SSMStateSlots``): state is
            O(1) in context, so migration is constant-cost and "prefix"
            reuse only makes sense for an exact full-length match (the
            recurrent state is a lossy summary — there is no per-position
            KV to truncate).
  hybrid  — RecurrentGemma conv/h recurrences plus fixed local-attention
            rings (``RecurrentStateSlots``): same O(1) economics as ssm.

Every implementation keeps the host bookkeeping (free list, rid -> slot /
context length / sampling params) and the device invariants the fused step
relies on: slot operations write the preallocated slabs in place, a
released slot's recurrent state is zeroed (so the next occupant chunks from
a zero state), and ``extract_state``/``place_state`` give the cluster a
family-agnostic migration transfer (the payload's ``nbytes`` is the real
wire cost that ``RuntimeCore`` records) whose bytes ``state_image`` holds
as one tensor on the device before their single copy to the host.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig



def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``t``, never a view of it. A card tensor
    is copied into pinned (page-locked) memory, whose copy runs at the
    link's rate whatever the host's load; PyTorch's caching host allocator
    hands freed pinned blocks out again, so each payload still gets a
    buffer of its own. A host tensor is copied into ordinary memory."""
    return torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.is_cuda).copy_(t)


def byte_image(parts, device) -> torch.Tensor:
    """``parts``' raw bytes back to back in one uint8 tensor on
    ``device``: a payload of any number of tensors lands as one image, so
    it is checksummed once."""
    flat = [p.contiguous().reshape(-1).view(torch.uint8) for p in parts]
    out = torch.empty(sum(f.numel() for f in flat), dtype=torch.uint8,
                      device=device)
    off = 0
    for f in flat:
        # blocking: the upload ends here, so the checksum that follows
        # times the checksum alone
        out[off:off + f.numel()].copy_(f)
        off += f.numel()
    return out


def split_image(image: torch.Tensor, like) -> List[torch.Tensor]:
    """Views of ``image``'s bytes as the tensors of ``like``'s (shape,
    dtype) pairs, in order (each tensor's byte offset a multiple of its
    item size, as the slots' payloads have them)."""
    out, off = [], 0
    for shape, dtype in like:
        n = math.prod(shape) * dtype.itemsize
        out.append(image[off:off + n].view(dtype).view(shape))
        off += n
    return out


class StateSlotsBase:
    """Host bookkeeping shared by every decode-state implementation, plus
    the per-architecture capability flags the scheduling layer reads."""

    #: "block" — per-token KV, any block-aligned prefix is reusable;
    #: "exact" — constant-size recurrent state, only a full-length match.
    prefix_reuse: str = "exact"
    #: recurrent updates are irreversible, so rejected speculation cannot
    #: roll the state back (and parked slots are masked out of the fused
    #: decode instead of receiving dummy writes).
    supports_speculation: bool = False

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

    def counters(self) -> Dict[str, int]:
        """What the slots hold, for a traced dispatch: ``kv_tokens``
        (positions held by the occupied slots) and ``kv_reserved`` (slots
        x capacity)."""
        return {"kv_tokens": sum(self.len_of.get(r, 0) for r in self.slot_of),
                "kv_reserved": self.n_slots * self.capacity}

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
    def state_image(self, rid: int) -> Tuple[torch.Tensor, int]:
        """(one contiguous tensor on the slots' device whose bytes are the
        migration payload's, in order; context length): what the export
        checksums and :meth:`to_payload` copies to the host."""
        raise NotImplementedError

    def to_payload(self, image: torch.Tensor) -> List[torch.Tensor]:
        """The payload's host tensors over one host copy of
        :meth:`state_image`'s tensor."""
        raise NotImplementedError

    def extract_state(self, rid: int) -> Tuple[List[torch.Tensor], int]:
        """(payload host tensors, context length) — the family-agnostic
        migration export; ``sum(p.nbytes for p in payload)`` is the real
        transfer size."""
        image, L = self.state_image(rid)
        return self.to_payload(image), L

    def place_state(self, rid: int, payload: List[torch.Tensor],
                    length: int) -> None:
        """Inverse of :meth:`extract_state` into ``rid``'s allocated slot."""
        raise NotImplementedError

    def state_bytes(self, rid: int) -> int:
        """Bytes a migration of ``rid`` moves right now."""
        raise NotImplementedError

    def copy_prefix(self, src_rid: int, dst_rid: int, length: int) -> None:
        raise NotImplementedError


class _FixedStateSlots(StateSlotsBase):
    """Constant-size per-slot state held as named slabs, each with its slot
    axis; ``_leaves`` walks them in the migration payload's order."""

    def _leaves(self):
        """(tensor, slot axis) of every slab, in payload order."""
        raise NotImplementedError

    def _clear_slot(self, slot: int) -> None:
        for a, axis in self._leaves():
            a.select(axis, slot).zero_()

    def state_image(self, rid: int):
        # every slab row's bytes in one tensor: one checksum, one copy out
        s = self.slot_of[rid]
        rows = [a.select(axis, s) for a, axis in self._leaves()]
        return byte_image(rows, rows[0].device), self.len_of[rid]

    def to_payload(self, image):
        return split_image(host_copy(image),
                           [(a.select(axis, 0).shape, a.dtype)
                            for a, axis in self._leaves()])

    def place_state(self, rid: int, payload, length: int) -> None:
        s = self.slot_of[rid]
        for (a, axis), row in zip(self._leaves(), payload):
            a.select(axis, s).copy_(torch.as_tensor(row))
        self.len_of[rid] = length

    def reserved_bytes(self) -> int:
        """Bytes of the slabs: every slot's state, held or free."""
        return sum(a.numel() * a.element_size() for a, _ in self._leaves())

    def state_bytes(self, rid: int) -> int:
        return self.reserved_bytes() // self.n_slots

    def counters(self) -> Dict[str, int]:
        """The base's, plus ``state_bytes`` (the bytes of the slab rows the
        occupied slots hold) and ``state_reserved_bytes`` (the slabs')."""
        return {**super().counters(),
                "state_bytes": sum(self.state_bytes(r) for r in self.slot_of),
                "state_reserved_bytes": self.reserved_bytes()}

    def copy_prefix(self, src_rid: int, dst_rid: int, length: int) -> None:
        # exact-prefix only: the recurrent state *is* the whole context
        if length != self.len_of[src_rid]:
            raise ValueError(f"a recurrent state copies whole contexts "
                             f"only: length {length} != "
                             f"{self.len_of[src_rid]}")
        s, d = self.slot_of[src_rid], self.slot_of[dst_rid]
        for a, axis in self._leaves():
            a.select(axis, d).copy_(a.select(axis, s))
        self.len_of[dst_rid] = length


class SSMStateSlots(_FixedStateSlots):
    """Fixed-size ``{"conv": (L, B, W-1, Ch), "ssm": (L, B, H, P, N)}``
    slabs — O(1) bytes per slot regardless of context length."""

    def __init__(self, cfg: ModelConfig, n_slots: int, capacity: int,
                 device="cuda"):
        super().__init__(n_slots, capacity)
        from repro_torch.models import ssm
        cache = ssm.init_cache(cfg, n_slots, device=device)
        self.conv = cache["conv"]
        self.ssm = cache["ssm"]

    def slabs(self):
        return self.conv, self.ssm

    def _leaves(self):
        return ((self.conv, 1), (self.ssm, 1))


class RecurrentStateSlots(_FixedStateSlots):
    """The whole hybrid decode cache with batch == ``n_slots``: conv/h
    recurrences plus the fixed-size local-attention k/v rings and their
    ``pos_map``. Rings are bounded by the local window, so state is O(1) in
    context length, same as ssm."""

    def __init__(self, cfg: ModelConfig, n_slots: int, capacity: int,
                 device="cuda"):
        super().__init__(n_slots, capacity)
        from repro_torch.models import hybrid
        self.cache = hybrid.init_cache(cfg, n_slots, capacity, device=device)

    def slabs(self):
        return (self.cache,)

    def _leaves(self):
        """The JAX package's walk: sorted group keys, pos_map, sorted tail
        keys — so a payload's bytes (and CRC) match the JAX instance's."""
        c = self.cache
        out = [(c["groups"][k], 1) for k in sorted(c["groups"])]
        out.append((c["pos_map"], 0))
        out += [(c["tail"][k], 1) for k in sorted(c.get("tail", {}))]
        return out

    def _clear_slot(self, slot: int) -> None:
        super()._clear_slot(slot)
        self.cache["pos_map"][slot] = -1


def make_state_slots(cfg: ModelConfig, n_slots: int, capacity: int,
                     device) -> StateSlotsBase:
    """Decode-state slots for ``cfg.family`` (the engine's cache seam)."""
    if cfg.family == "dense":
        from repro_torch.engine.kv_slots import SlotKVCache
        from repro_torch.weights import torch_dtype
        return SlotKVCache(cfg.n_layers, n_slots, capacity, cfg.n_kv_heads,
                           cfg.head_dim_, torch_dtype(cfg.dtype), device)
    if cfg.family == "ssm":
        return SSMStateSlots(cfg, n_slots, capacity, device)
    if cfg.family == "hybrid":
        return RecurrentStateSlots(cfg, n_slots, capacity, device)
    raise NotImplementedError(f"no decode-state slots for family "
                              f"{cfg.family!r}")
