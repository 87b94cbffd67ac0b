"""Local (per-instance) scheduler (§5.4): FCFS KV-migration queue + chunked
prefill continuous batching. Decode requests are packed into the running batch
first; remaining token budget is filled with prefill chunks, so instances in
P→D / D→P pools start serving their new role immediately (no drain stall).
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class PrefillWork:
    rid: int
    input_len: int
    done: int = 0                 # chunked progress (starts at the cached
    #                               prefix length under prefix reuse, §7)
    cached: int = 0               # tokens served from a cached prefix
    tenant: Optional[str] = None  # submitting tenant (§10); None = implicit
    weight: float = 1.0           # tenant share weight for WDRR dispatch
    deflected: bool = False       # cross-pool deflected prefill (§11):
    #                               rate-limited by the deflect_ratio knob

    @property
    def remaining(self) -> int:
        return self.input_len - self.done


@dataclass
class DecodeWork:
    rid: int
    context_len: int              # tokens currently in KV (grows by 1/iter)
    remaining_out: int            # sim ground truth; engine: max-new-tokens


@dataclass
class IterationPlan:
    decode_rids: List[int] = field(default_factory=list)
    prefill_chunks: List[Tuple[int, int, int]] = field(default_factory=list)
    # (rid, chunk_start, chunk_len)

    @property
    def is_empty(self) -> bool:
        return not self.decode_rids and not self.prefill_chunks


class LocalScheduler:
    """One per instance."""

    def __init__(self, iid: int, *, token_budget: int = 8192,
                 max_batch: int = 256, kv_capacity_tokens: int = 1 << 20,
                 mixed_chunk_budget: int = 2048, deflect_ratio: float = 0.0):
        self.iid = iid
        self.token_budget = token_budget       # tokens per iteration batch
        # Sarathi-style: when decode requests share the batch, cap prefill
        # chunk tokens so decode token intervals stay near the TPOT target.
        self.mixed_chunk_budget = mixed_chunk_budget
        # §11 micro-batch ratio knob: max deflected prefill tokens per step
        # = deflect_ratio × mixed_chunk_budget, deficit-tracked so a large
        # deflected prefill drains over several steps instead of starving
        # the host's native work.
        self.deflect_ratio = deflect_ratio
        self._deflect_deficit = 0.0
        self.deflected_chunks = 0          # executed (not merely planned)
        self.deflected_chunk_tokens = 0
        self.max_batch = max_batch
        self.kv_capacity = kv_capacity_tokens
        self.migration_queue: deque = deque()  # FCFS: (rid, kv_tokens)
        self.prefill_queue: "OrderedDict[int, PrefillWork]" = OrderedDict()
        self.decode_running: "OrderedDict[int, DecodeWork]" = OrderedDict()
        # finished requests whose KV is retained as a reusable prefix (§7):
        # rid -> resident kv tokens. Counts toward kv_used, not decode load.
        self.retained: Dict[int, int] = {}
        self.kv_used = 0
        # WDRR deficit counters (§10): tenant -> unspent token allowance,
        # carried across iterations so long-run prefill dispatch converges
        # to the tenants' share weights. Only populated while requests of
        # more than one tenant share the queue.
        self._drr_deficit: Dict[Optional[str], float] = {}

    # ------------------------------------------------------------ enqueues
    def enqueue_prefill(self, rid: int, input_len: int, cached: int = 0,
                        tenant: Optional[str] = None,
                        weight: float = 1.0, deflected: bool = False) -> None:
        """``cached`` prefix tokens come from a retained KV (copy-on-extend)
        — chunking starts at ``cached``, but the request's KV footprint is
        the full ``input_len`` (the copy is its own). ``tenant``/``weight``
        feed the WDRR dispatch order (§10) when several tenants share the
        queue. ``deflected`` marks cross-pool deflected prefill (§11),
        dispatched after native work under the deflect_ratio budget."""
        self.prefill_queue[rid] = PrefillWork(rid, input_len, done=cached,
                                              cached=cached, tenant=tenant,
                                              weight=weight,
                                              deflected=deflected)
        self.kv_used += input_len

    def enqueue_migration(self, rid: int, kv_tokens: int, remaining_out: int) -> None:
        self.migration_queue.append((rid, kv_tokens, remaining_out))

    def admit_migrated(self, rid: int, kv_tokens: int, remaining_out: int) -> None:
        """Migration finished: request joins the decode set."""
        self.decode_running[rid] = DecodeWork(rid, kv_tokens, remaining_out)
        self.kv_used += kv_tokens

    def start_local_decode(self, rid: int, kv_tokens: int, remaining_out: int) -> None:
        """Decode stays on the prefill instance (no transfer): KV already here."""
        self.decode_running[rid] = DecodeWork(rid, kv_tokens, remaining_out)

    # ------------------------------------------------------------- queries
    def has_pending_prefill(self) -> bool:
        return bool(self.prefill_queue)

    def has_pending_decode(self) -> bool:
        return bool(self.decode_running) or bool(self.migration_queue)

    @property
    def running_tokens(self) -> int:
        return sum(w.context_len for w in self.decode_running.values())

    @property
    def prefill_backlog_tokens(self) -> int:
        return sum(w.remaining for w in self.prefill_queue.values())

    def can_accept_migration(self, kv_tokens: int) -> bool:
        return self.kv_used + kv_tokens <= self.kv_capacity

    # ------------------------------------------------------ iteration plan
    def next_migration(self) -> Optional[Tuple[int, int, int]]:
        """FCFS migration admission (§5.4), gated on free KV memory."""
        if not self.migration_queue:
            return None
        rid, kv, rem = self.migration_queue[0]
        if self.kv_used + kv > self.kv_capacity:
            return None               # q2: blocked on memory — unpredictable
        self.migration_queue.popleft()
        return rid, kv, rem

    def plan_iteration(self) -> IterationPlan:
        """Chunked-prefill continuous batching: decode first, then prefill
        chunks up to the token budget (Sarathi-style stall-free batching).

        When requests of more than one tenant share the prefill queue, the
        chunk order runs weighted deficit round-robin across per-tenant
        FIFO groups (§10) — each round a tenant's deficit grows by
        ``mixed_chunk_budget × weight`` and its head-of-line chunks are
        served while the deficit covers them, so a starved tenant's
        head-of-line beats a flooder's backlog at exactly its share ratio.
        With zero or one tenant present the plan is the plain FIFO scan
        (identical to the pre-tenancy scheduler).

        Deflected prefill (§11) never competes with native work: it is
        planned last, from whatever budget remains, and rate-limited to
        ``deflect_ratio × mixed_chunk_budget`` tokens per step through its
        own deficit counter — so deflection composes with (and cannot
        starve) the WDRR tenant queues above."""
        plan = IterationPlan()
        budget = self.token_budget
        slots = self.max_batch
        for rid in self.decode_running:
            if slots == 0 or budget == 0:
                break
            plan.decode_rids.append(rid)
            slots -= 1
            budget -= 1
        if plan.decode_rids:
            budget = min(budget, self.mixed_chunk_budget)

        native = [w for w in self.prefill_queue.values() if not w.deflected]
        deflected = [w for w in self.prefill_queue.values() if w.deflected]

        groups: "OrderedDict[Optional[str], List[PrefillWork]]" = OrderedDict()
        for w in native:
            groups.setdefault(w.tenant, []).append(w)
        if len(groups) <= 1:
            self._drr_deficit.clear()
            for w in native:
                if slots == 0 or budget <= 0:
                    break
                chunk = min(w.remaining, budget)
                if chunk <= 0:
                    continue
                plan.prefill_chunks.append((w.rid, w.done, chunk))
                budget -= chunk
                slots -= 1
            return self._plan_deflected(plan, deflected, budget, slots)

        # ---- WDRR across per-tenant groups (one chunk per rid per plan)
        for t in list(self._drr_deficit):
            if t not in groups:
                del self._drr_deficit[t]       # departed tenant: reset
        heads = {t: 0 for t in groups}
        active = list(groups)
        quantum = self.mixed_chunk_budget
        rounds = 0
        while budget > 0 and slots > 0 and active and rounds < 64:
            rounds += 1
            for t in list(active):
                if budget <= 0 or slots <= 0:
                    break
                wl = groups[t]
                weight = max(wl[0].weight, 1e-3)
                # accrue, capped so an absent-then-returning tenant cannot
                # hoard more than one full iteration's worth of allowance
                self._drr_deficit[t] = min(
                    self._drr_deficit.get(t, 0.0) + quantum * weight,
                    float(max(self.token_budget, quantum)))
                while heads[t] < len(wl) and budget > 0 and slots > 0:
                    w = wl[heads[t]]
                    chunk = min(w.remaining, budget)
                    if chunk <= 0:
                        heads[t] += 1
                        continue
                    if self._drr_deficit[t] < chunk:
                        break              # wait for the next round's quantum
                    plan.prefill_chunks.append((w.rid, w.done, chunk))
                    self._drr_deficit[t] -= chunk
                    budget -= chunk
                    slots -= 1
                    heads[t] += 1
                if heads[t] >= len(wl):
                    active.remove(t)
        return self._plan_deflected(plan, deflected, budget, slots)

    def _plan_deflected(self, plan: IterationPlan,
                        deflected: List[PrefillWork],
                        budget: int, slots: int) -> IterationPlan:
        """§11: fill leftover budget with deflected chunks, at most
        ``deflect_ratio × mixed_chunk_budget`` tokens per step (deficit-
        tracked across steps so a big deflected prefill drains steadily)."""
        if not deflected:
            self._deflect_deficit = 0.0
            return plan
        if self.deflect_ratio <= 0:
            # Deflected work on an unarmed instance (knob lowered after
            # placement): serve it like native work so it cannot hang.
            for w in deflected:
                if slots == 0 or budget <= 0:
                    break
                chunk = min(w.remaining, budget)
                if chunk <= 0:
                    continue
                plan.prefill_chunks.append((w.rid, w.done, chunk))
                budget -= chunk
                slots -= 1
            return plan
        # allowance floor of one token per step: progress is guaranteed even
        # at tiny ratios (an empty plan would never be re-kicked by the sim)
        self._deflect_deficit = min(
            self._deflect_deficit
            + max(1.0, self.deflect_ratio * self.mixed_chunk_budget),
            float(self.mixed_chunk_budget))
        for w in deflected:
            if slots == 0 or budget <= 0:
                break
            chunk = min(w.remaining, budget, int(self._deflect_deficit))
            if chunk <= 0:
                break                  # deficit spent: wait for next step
            plan.prefill_chunks.append((w.rid, w.done, chunk))
            self._deflect_deficit -= chunk
            budget -= chunk
            slots -= 1
        return plan

    # ------------------------------------------------------ state advance
    def complete_prefill_chunk(self, rid: int, chunk_len: int) -> bool:
        """Returns True when the request's prefill is now complete."""
        w = self.prefill_queue[rid]
        w.done += chunk_len
        if w.deflected:
            # counted at completion, not plan time: the engine may plan a
            # chunk, fail slot allocation, and replan — completion is the
            # only point each executed chunk passes exactly once.
            self.deflected_chunks += 1
            self.deflected_chunk_tokens += chunk_len
        if w.remaining <= 0:
            del self.prefill_queue[rid]
            return True
        return False

    def complete_decode_iteration(self, rid: int) -> bool:
        """One token produced. Returns True when the request finished."""
        w = self.decode_running[rid]
        w.context_len += 1
        self.kv_used += 1             # decode grows the KV cache one token/iter
        w.remaining_out -= 1
        if w.remaining_out <= 0:
            self.kv_used -= w.context_len
            del self.decode_running[rid]
            return True
        return False

    def release_prefill_kv(self, rid: int, kv_tokens: int) -> None:
        """KV handed off to another instance (after migration completes)."""
        self.kv_used = max(0, self.kv_used - kv_tokens)

    # ----------------------------------------------- retained prefixes (§7)
    def retain_kv(self, rid: int, kv_tokens: int) -> None:
        """A finished request's KV stays resident as a reusable prefix. The
        decode path already released its tokens from ``kv_used``; re-add
        them under the retained account."""
        self.retained[rid] = kv_tokens
        self.kv_used += kv_tokens

    def release_retained(self, rid: int) -> int:
        """Evict/invalidate a retained prefix; returns the tokens freed."""
        kv = self.retained.pop(rid, 0)
        self.kv_used = max(0, self.kv_used - kv)
        return kv
