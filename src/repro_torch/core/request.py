"""Request model: a request is split into PREFILL and DECODE *sub-requests*
(the paper's key reframing — phase is a property of the request, §5.2)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class Phase(enum.Enum):
    PREFILL = "prefill"
    DECODE = "decode"


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    MIGRATING = "migrating"          # waiting for / doing KV-cache transfer
    DECODING = "decoding"
    FINISHED = "finished"
    REJECTED = "rejected"            # admission turned it away (§10): the
    #                                  request never entered scheduling or
    #                                  KV accounting and never will


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding controls (DESIGN.md §12). ``temperature<=0`` is
    exact greedy argmax — provably the pre-sampling token path. ``seed``
    overrides the run seed recorded in ``ServeReport`` for this request
    only; the effective key stream is derived statelessly from
    ``(seed, rid, absolute position)``, which is what makes sampled streams
    replayable bit-for-bit across runs, migration and crash recovery."""

    temperature: float = 0.0
    top_p: float = 1.0
    seed: Optional[int] = None

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


@dataclass
class Request:
    rid: int
    arrival: float                   # seconds
    input_len: int
    output_len: int                  # trace ground truth (sim) / max tokens (engine)
    state: RequestState = RequestState.QUEUED

    # decoding controls (DESIGN.md §12); None ≡ greedy argmax (the pre-PR-8
    # behavior, byte-identical)
    sampling: Optional[SamplingParams] = None

    # multi-turn lineage (DESIGN.md §7): a follow-up turn extends its
    # session's token stream; dispatch is gated on the parent finishing and
    # the prefix cache can reuse the parent's retained KV.
    session_id: Optional[int] = None
    parent_rid: Optional[int] = None
    history_len: int = 0             # tokens shared with the parent's context

    # multi-tenancy (DESIGN.md §10): which client submitted this request;
    # None means the implicit single tenant (admission treats it as
    # "anonymous")
    tenant_id: Optional[str] = None

    # scheduling bookkeeping
    prefill_instance: Optional[int] = None
    decode_instance: Optional[int] = None
    cached_len: int = 0              # prefix tokens served from cache (§7)

    # crash recovery (DESIGN.md §8): a request whose KV was lost re-prefills
    # its prompt plus the already-streamed tokens (minus the last, which
    # seeds the next decode step) — ``input_len`` absorbs those tokens so
    # the recovery prefill is costed and scheduled like any other, and
    # ``resumed_tokens`` (the stream length at recovery) tells the runtime
    # not to re-emit anything the user already saw.
    resumed_tokens: int = 0
    recoveries: int = 0              # times this request was crash-recovered

    # measured outcomes
    first_token_time: Optional[float] = None      # absolute time of o_1
    finish_time: Optional[float] = None
    token_times: list = field(default_factory=list)  # absolute times of o_2..o_m

    # progress
    prefill_done_tokens: int = 0     # chunked-prefill progress
    decoded_tokens: int = 0          # output tokens produced so far (incl. o_1)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Eq. (3): decode-phase time / (m-1); 0 when m == 1."""
        if self.finish_time is None or self.first_token_time is None:
            return None
        if self.output_len <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) / (self.output_len - 1)

    def meets_slo(self, slo) -> bool:
        t1 = self.ttft
        t2 = self.tpot
        if t1 is None or t2 is None:
            return False
        return t1 <= slo.ttft and t2 <= slo.tpot
