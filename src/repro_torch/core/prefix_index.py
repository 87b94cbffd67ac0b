"""Prefix-aware KV reuse (DESIGN.md §7): a token-block radix index over the
cluster's *retained* KV caches.

Multi-turn traffic re-prefills a growing shared history every turn — pure
recomputation. This module tracks which instance already holds the KV of a
prompt prefix so the global scheduler can route the follow-up turn there and
prefill only the uncached suffix (the Eq. (2) accounting then charges
``TTFTPredictor.predict_chunk(cached, L - cached)`` instead of the full
quadratic).

Structure
---------
Prompts are abstracted to chains of **block keys** (one key per
``block_size`` tokens). Two key schemes share the index:

* **lineage keys** — ``(namespace, block_idx)`` for requests that carry a
  ``session_id``: turn *N*'s prompt literally extends the session's token
  stream, so block *b* of any turn denotes the same content. The simulator
  (which models timing, not content) relies on these; the engine uses them
  too for session requests, after constructing the prompt from the real
  session transcript so the claim is true in compute.
* **content keys** — a rolling hash chain over real token blocks, for
  engine requests without a session (generic prefix caching: identical
  system prompts hit even across unrelated requests).

The index itself is a radix trie over block keys. Each node holds the set
of (instance, rid) entries whose retained KV covers the prefix ending at
that node; a lookup walks the query chain to the deepest non-empty node and
returns one candidate per instance there (all with the same cached depth).

Entries are **ref-count pinned** while a new request is copying/extending
from them (eviction and invalidation must not free KV mid-copy — an
invalidated-but-pinned entry is *doomed*: it leaves the trie immediately
and its KV is freed on the last unpin). Per-instance eviction is LRU over
unpinned entries, driven by the backends when memory pressure blocks
admission (sim: migration admission; engine: slot exhaustion).

The manager never touches KV itself: freeing goes through a release
callback the runtime supplies (sim: ``LocalScheduler.release_retained``;
engine: additionally drops the real slot).
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

DEFAULT_BLOCK = 32


# ------------------------------------------------------------------ keys
def lineage_keys(namespace, n_tokens: int, block: int = DEFAULT_BLOCK
                 ) -> Tuple:
    """Logical block keys for the first ``n_tokens`` of a session stream.
    ``namespace`` identifies the stream (``session_id``, or ``(session_id,
    epoch)`` when a backend forks a session, e.g. after truncation)."""
    return tuple((namespace, b) for b in range(n_tokens // block))


def content_keys(tokens: Sequence[int], block: int = DEFAULT_BLOCK) -> Tuple:
    """Rolling-hash chain over real token blocks: block b's key commits to
    the whole prefix [0, (b+1)·block) — every token's full 4-byte id feeds
    the hash, so distinct prefixes get distinct chains up to genuine crc32
    collisions (~2⁻³² per block pair; acceptable for a reproduction — a
    production engine would byte-compare the tokens on hit)."""
    keys = []
    h = 0
    n = len(tokens) // block
    for b in range(n):
        chunk = b"".join(int(t).to_bytes(4, "little", signed=True)
                         for t in tokens[b * block:(b + 1) * block])
        h = zlib.crc32(chunk, h)
        keys.append(("c", h, b))
    return tuple(keys)


# --------------------------------------------------------------- entries
@dataclass
class PrefixEntry:
    iid: int
    rid: int
    keys: Tuple                 # full chain this entry's KV covers
    kv_tokens: int              # resident KV size (for eviction accounting)
    pins: int = 0
    doomed: bool = False        # invalidated while pinned: free on last unpin
    last_used: int = 0          # logical LRU clock


@dataclass(frozen=True)
class PrefixHit:
    """One lookup candidate: ``iid`` holds ``cached_len`` prefix tokens of
    the query in ``rid``'s retained KV."""

    iid: int
    rid: int
    cached_len: int


class _Node:
    __slots__ = ("children", "entries")

    def __init__(self):
        self.children: Dict[object, _Node] = {}
        self.entries: set = set()        # (iid, rid) whose chain passes here


class PrefixIndex:
    """Radix trie over block keys; see module docstring."""

    def __init__(self, block: int = DEFAULT_BLOCK):
        self.block = block
        self.root = _Node()
        self.entries: Dict[Tuple[int, int], PrefixEntry] = {}  # (iid,rid)->

    def __len__(self) -> int:
        return len(self.entries)

    # ------------------------------------------------------------ insert
    def insert(self, entry: PrefixEntry) -> None:
        key = (entry.iid, entry.rid)
        if key in self.entries:            # re-insert: refresh in place
            self.remove(entry.iid, entry.rid)
        self.entries[key] = entry
        node = self.root
        for k in entry.keys:
            node = node.children.setdefault(k, _Node())
            node.entries.add(key)

    def remove(self, iid: int, rid: int) -> Optional[PrefixEntry]:
        entry = self.entries.pop((iid, rid), None)
        if entry is None:
            return None
        node, path = self.root, []
        for k in entry.keys:
            nxt = node.children.get(k)
            if nxt is None:
                break
            path.append((node, k, nxt))
            nxt.entries.discard((iid, rid))
            node = nxt
        for parent, k, child in reversed(path):   # prune empty branches
            if not child.entries and not child.children:
                del parent.children[k]
        return entry

    # ------------------------------------------------------------ lookup
    def lookup(self, keys: Sequence) -> List[PrefixHit]:
        """Walk ``keys`` to the deepest non-empty node; return one hit per
        instance there (deepest = longest cached prefix), longest first."""
        node, depth = self.root, 0
        best: Optional[Tuple[int, set]] = None
        for k in keys:
            node = node.children.get(k)
            if node is None:
                break
            depth += 1
            if node.entries:
                best = (depth, node.entries)
        if best is None:
            return []
        depth, members = best
        per_iid: Dict[int, int] = {}
        for iid, rid in members:
            e = self.entries[(iid, rid)]
            # prefer the most recently used rid per instance (ties broken
            # deterministically by rid)
            cur = per_iid.get(iid)
            if cur is None or (e.last_used, rid) > \
                    (self.entries[(iid, cur)].last_used, cur):
                per_iid[iid] = rid
        return [PrefixHit(iid, rid, depth * self.block)
                for iid, rid in sorted(per_iid.items())]


# ---------------------------------------------------------------- manager
class PrefixCacheManager:
    """Index + per-instance LRU + pin/doom lifecycle + stats.

    ``release`` is called exactly once per entry whose KV is actually freed
    (evicted, invalidated-unpinned, or doomed at last unpin) with
    ``(iid, rid, kv_tokens)``; the runtime routes it to the owning backend.
    """

    def __init__(self, block: int = DEFAULT_BLOCK,
                 release: Optional[Callable[[int, int, int], None]] = None):
        self.index = PrefixIndex(block)
        self.block = block
        self._release = release or (lambda iid, rid, kv: None)
        # per-instance LRU order: OrderedDict rid -> PrefixEntry
        self._lru: Dict[int, "OrderedDict[int, PrefixEntry]"] = {}
        self._clock = 0
        self.stats: Dict[str, float] = {
            "lookups": 0, "hits": 0, "cached_tokens": 0,
            "retained": 0, "evictions": 0, "invalidations": 0}

    # ------------------------------------------------------------ queries
    def lookup(self, keys: Optional[Sequence]) -> List[PrefixHit]:
        if not keys:
            return []
        self.stats["lookups"] += 1
        return self.index.lookup(keys)

    def entries_on(self, iid: int) -> List[PrefixEntry]:
        return list(self._lru.get(iid, {}).values())

    def retained_tokens(self, iid: int) -> int:
        return sum(e.kv_tokens for e in self._lru.get(iid, {}).values())

    # ---------------------------------------------------------- lifecycle
    def retain(self, iid: int, rid: int, keys: Sequence,
               kv_tokens: int) -> bool:
        """Register ``rid``'s resident KV on ``iid`` as a reusable prefix.
        Returns False (no-op) for empty chains — nothing to reuse."""
        keys = tuple(keys)
        if not keys:
            return False
        self._clock += 1
        entry = PrefixEntry(iid, rid, keys, kv_tokens, last_used=self._clock)
        self.index.insert(entry)
        self._lru.setdefault(iid, OrderedDict())[rid] = entry
        self._lru[iid].move_to_end(rid)
        self.stats["retained"] += 1
        return True

    def record_hit(self, hit: PrefixHit) -> None:
        self.stats["hits"] += 1
        self.stats["cached_tokens"] += hit.cached_len
        entry = self.index.entries.get((hit.iid, hit.rid))
        if entry is not None:
            self._clock += 1
            entry.last_used = self._clock
            lru = self._lru.get(hit.iid)
            if lru is not None and hit.rid in lru:
                lru.move_to_end(hit.rid)

    def pin(self, iid: int, rid: int) -> None:
        entry = self.index.entries.get((iid, rid))
        if entry is not None:
            entry.pins += 1

    def unpin(self, iid: int, rid: int) -> None:
        # the entry may already be doomed (removed from the trie); look in
        # the LRU map, which keeps doomed entries until their KV is freed
        entry = self.index.entries.get((iid, rid))
        if entry is None:
            lru = self._lru.get(iid, {})
            entry = lru.get(rid)
        if entry is None:
            return
        entry.pins = max(entry.pins - 1, 0)
        if entry.doomed and entry.pins == 0:
            self._drop(entry)

    # ---------------------------------------------------------- eviction
    def make_room(self, iid: int, tokens_needed: int) -> int:
        """Evict unpinned LRU entries on ``iid`` until ``tokens_needed``
        worth of KV has been freed (or nothing evictable remains). Returns
        the number of tokens actually freed."""
        freed = 0
        lru = self._lru.get(iid)
        if not lru:
            return 0
        for rid in list(lru):
            if freed >= tokens_needed:
                break
            entry = lru[rid]
            if entry.pins > 0 or entry.doomed:
                continue
            self.index.remove(iid, rid)
            freed += entry.kv_tokens
            self.stats["evictions"] += 1
            self._drop(entry)
        return freed

    def evict_one(self, iid: int) -> Optional[int]:
        """Evict the single LRU unpinned entry on ``iid`` (engine slot
        reclamation). Returns the evicted rid, or None."""
        lru = self._lru.get(iid)
        if not lru:
            return None
        for rid in list(lru):
            entry = lru[rid]
            if entry.pins > 0 or entry.doomed:
                continue
            self.index.remove(iid, rid)
            self.stats["evictions"] += 1
            self._drop(entry)
            return rid
        return None

    # ------------------------------------------------------- invalidation
    def invalidate_instance(self, iid: int) -> int:
        """Drop every entry on ``iid`` (pool flip / retirement — DESIGN.md
        §7). Pinned entries are doomed: out of the trie now, KV freed on the
        last unpin (a copy-on-extend may be mid-flight). Returns the number
        of entries invalidated."""
        lru = self._lru.get(iid)
        if not lru:
            return 0
        n = 0
        for rid in list(lru):
            entry = lru[rid]
            if entry.doomed:
                continue
            self.index.remove(iid, rid)
            n += 1
            if entry.pins > 0:
                entry.doomed = True
            else:
                self._drop(entry)
        if n:
            self.stats["invalidations"] += n
        return n

    # ------------------------------------------------------------ internal
    def _drop(self, entry: PrefixEntry) -> None:
        lru = self._lru.get(entry.iid)
        if lru is not None:
            lru.pop(entry.rid, None)
            if not lru:
                self._lru.pop(entry.iid, None)
        self._release(entry.iid, entry.rid, entry.kv_tokens)
