"""Slot-granular batched KV cache for the real engine.

Layout mirrors the model cache ({"k","v": (L, B_slots, C, Hk, D), "pos_map":
(B_slots, C)}), so ``dense.decode_step`` runs directly on it. Slots are the
engine's unit of admission; the decode kernel views a slot's capacity as
contiguous pages of the paged-attention pool.

The slabs are allocated once and every slot operation (place / copy_prefix /
release) and every fused step writes them **in place**, where the JAX
package donated them to jitted functions. A KV export stacks k and v into
one device tensor (``state_image``), so it costs a single device-to-host
copy and a single checksum launch.
"""
from __future__ import annotations

import torch

from repro_torch.engine.state_slots import StateSlotsBase, host_copy


class SlotKVCache(StateSlotsBase):
    """Dense-family decode state: per-token KV rings. State grows O(L) with
    context, so block-granular prefix reuse and token-proportional migration
    sizing both apply."""

    prefix_reuse = "block"
    supports_speculation = True

    def __init__(self, n_layers: int, n_slots: int, capacity: int,
                 n_kv_heads: int, head_dim: int, dtype=torch.float32,
                 device="cuda"):
        super().__init__(n_slots, capacity)
        self.device = torch.device(device)
        self.k = torch.zeros((n_layers, n_slots, capacity, n_kv_heads,
                              head_dim), dtype=dtype, device=self.device)
        self.v = torch.zeros_like(self.k)
        self.pos_map = torch.full((n_slots, capacity), -1, dtype=torch.int32,
                                  device=self.device)
        self._idx = torch.arange(capacity, dtype=torch.int32,
                                 device=self.device)

    def _clear_slot(self, slot: int) -> None:
        # invalidating the pos_map row is enough — the k/v bytes are never
        # attended without a valid position, and the next occupant's
        # prefill overwrites them wholesale
        self.pos_map[slot] = -1

    def _set_row(self, slot: int, length: int) -> None:
        """Positions [0, length) of ``slot`` valid, the rest invalid."""
        self.pos_map[slot] = torch.where(self._idx < length, self._idx, -1)

    # -------------------------------------------------------------- slabs
    def slabs(self):
        return self.k, self.v, self.pos_map

    # ------------------------------------------------------------- write
    def place(self, rid: int, k_seq, v_seq, length: int) -> None:
        """k_seq/v_seq (L, S, Hk, D) (S >= length, any device) into rid's
        slot; positions [length, C) are marked invalid."""
        s = self.slot_of[rid]
        S = min(k_seq.shape[1], self.capacity)
        self.k[:, s, :S] = k_seq[:, :S].to(self.device)
        self.v[:, s, :S] = v_seq[:, :S].to(self.device)
        self._set_row(s, min(length, self.capacity))
        self.len_of[rid] = length

    def copy_prefix(self, src_rid: int, dst_rid: int, length: int) -> None:
        """Copy-on-extend: duplicate the first ``length`` cached positions
        of ``src_rid``'s slot into ``dst_rid``'s freshly allocated slot, so
        the new request prefills only its suffix. The copy is the new
        request's own KV — the source stays untouched."""
        s = self.slot_of[src_rid]
        d = self.slot_of[dst_rid]
        L = min(length, self.len_of[src_rid], self.capacity)
        self.k[:, d] = self.k[:, s]
        self.v[:, d] = self.v[:, s]
        self._set_row(d, L)
        self.len_of[dst_rid] = L

    def extract(self, rid: int):
        """For KV transfer to another instance: (k (L,S,Hk,D), v, length)
        as host tensors — one stacked device-to-host copy (into pinned
        memory when the slabs are on the card)."""
        (k, v), L = self.extract_state(rid)
        return k, v, L

    # ---------------------------------------- family-agnostic migration
    def state_image(self, rid: int):
        # k then v stacked: one tensor, so one copy to the host
        s = self.slot_of[rid]
        L = self.len_of[rid]
        return torch.stack([self.k[:, s, :L], self.v[:, s, :L]]), L

    def to_payload(self, image):
        kv = host_copy(image)
        return [kv[0], kv[1]]

    def place_state(self, rid: int, payload, length: int) -> None:
        k, v = payload
        self.place(rid, torch.as_tensor(k), torch.as_tensor(v), length)

    def state_bytes(self, rid: int) -> int:
        # O(L) in context: tokens x per-token KV bytes (k and v rows)
        n_layers, _, _, hk, d = self.k.shape
        return 2 * n_layers * hk * d * self.k.element_size() \
            * self.len_of[rid]

