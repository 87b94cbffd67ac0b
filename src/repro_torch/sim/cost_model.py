"""Analytic instance cost model of one NVIDIA H100 serving instance
(DESIGN.md §3).

The paper profiles H800 GPUs; iteration costs here come from the card's
constants, carried by :class:`InstanceProfile`, and the architecture
config. Structure matches the paper's §4 analysis: prefill compute is
quadratic in input length (attention) + linear (MLP); decode iterations are
linear in batch tokens and typically memory-bandwidth bound (weights + KV
reads).

The TTFT predictor does NOT read these constants — it fits its quadratic from
profiled samples produced by this model (sim) or wall-clock timing (engine),
exactly as the paper's profiler does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class SpeculationModel:
    """Analytic model of self-speculative decoding (DESIGN.md §12) for the
    simulator's cost model: ``k`` drafts per round through the first
    ``draft_frac`` of the layer stack, verified by one full pass over the
    ``k + 1`` candidate positions, with per-draft acceptance probability
    ``accept`` (independent-trial approximation of the paper-style
    acceptance curve)."""

    k: int = 4
    draft_frac: float = 0.5       # fraction of layers used for drafting
    accept: float = 0.8           # P(draft j accepted | j-1 accepted)

    @property
    def expected_emitted(self) -> float:
        """E[tokens emitted per round] = sum_{i=0..k} accept^i — the
        geometric-series acceptance of the longest agreeing prefix, plus
        the always-emitted verify token."""
        b = min(max(self.accept, 0.0), 1.0)
        if b >= 1.0:
            return float(self.k + 1)
        return (1.0 - b ** (self.k + 1)) / (1.0 - b)

    @property
    def cost_factor(self) -> float:
        """Per-round *compute* relative to one sequential decode step: k
        truncated-layer draft steps plus a (k+1)-wide full verify pass.
        (The memory-bound round cost is lower — weights are read once per
        pass, not per position — which is where the modeled speedup comes
        from; see CostModel.spec_iteration_time.)"""
        return self.draft_frac * self.k + (self.k + 1)


@dataclass(frozen=True)
class InstanceProfile:
    """One serving instance = a TP slice of `chips` cards. The per-card
    fields default to one NVIDIA H100 80GB HBM3 at a 700.00 W power limit
    (``nvidia-smi --query-gpu=name,power.limit`` on the card they were
    measured on): the two peaks from the SXM data sheet, the rest the
    medians of three runs of ``chip_smoke.py``'s sim phase, which measures
    them in the engine's process after its paths have served, and fails
    if a measured rate exceeds its coded peak by more than 5% or a
    measured constant leaves its band around the default."""
    chips: int = 4
    # bf16 GEMM x(256, 2048) @ (2048, 6144) (qwen3-1.7b's MLP, a prefill
    # chunk) in a CUDA graph: 0.01384 and 0.01437 ms, 466 and 448 TFLOP/s
    # over peak_flops (two runs; the third timed it eagerly), their mean
    flop_eff: float = 0.462
    # eager device-to-device copy of 1 GiB: 2 GiB read + written in
    # 0.7135 ms, 3.01 TB/s over hbm_bw
    mem_eff: float = 0.898
    # a full-width qwen3-1.7b decode step (batch 8, contexts 133-595 of a
    # 1024-slot cache, the paged kernel): 3.415 ms of device time
    # (torch.profiler), less this model's rate terms for it at the two
    # efficiencies above (1.256 ms)
    overhead: float = 0.00216
    peak_flops: float = 989e12   # dense bf16 tensor-core peak
    hbm_bw: float = 3.35e12      # bytes/s
    # torch.cuda.get_device_properties(0).total_memory
    hbm_bytes: int = 85_017_493_504
    # migrations moved as export_state / import_state move them (device to
    # pinned host memory, then back): least-squares slope of the round
    # trips of qwen3 (13.4, 66.4, 117.4 MB), mamba2 (51.0 MB) and
    # recurrentgemma (13.7 MB) payloads above link_latency; the median of
    # chip_smoke.py's sim phase in three runs on an H100 80GB HBM3 at
    # 700 W (2.40e10, 2.52e10, 2.41e10; PERF.md section 5)
    link_bw: float = 2.41e10
    # the round trip of a 114,688-byte payload (one qwen3 token): the same
    # three runs' median (0.281, 0.327, 0.189 ms)
    link_latency: float = 2.81e-4

    @property
    def flops(self) -> float:
        return self.chips * self.peak_flops * self.flop_eff

    @property
    def bw(self) -> float:
        return self.chips * self.hbm_bw * self.mem_eff

    @property
    def hbm(self) -> float:
        return self.chips * self.hbm_bytes


class CostModel:
    def __init__(self, cfg: ModelConfig, prof: InstanceProfile = InstanceProfile()):
        self.cfg = cfg
        self.prof = prof
        self.n_active = cfg.param_count(active_only=True)
        self.param_bytes = cfg.param_count() * 2          # bf16
        c = cfg
        if c.family == "ssm":
            s = c.ssm
            self.kv_bytes_per_token = 0.0
            self.state_bytes_per_seq = c.n_layers * (
                s.n_heads(c.d_model) * s.head_dim * s.d_state * 4
                + (s.d_conv - 1) * (s.d_inner(c.d_model) + 2 * s.n_groups * s.d_state) * 2)
        elif c.family == "hybrid":
            pat = c.hybrid.pattern
            frac_attn = pat.count("attn") / len(pat)
            self.kv_bytes_per_token = c.n_layers * frac_attn * 2 * c.kv_dim * 2
            lw = c.hybrid.lru_width or c.d_model
            self.state_bytes_per_seq = c.n_layers * (1 - frac_attn) * lw * 4
            self.attn_window = c.hybrid.local_window
        else:
            self.kv_bytes_per_token = c.n_layers * 2 * c.kv_dim * 2
            self.state_bytes_per_seq = 0.0
        self.attn_window = getattr(self, "attn_window", None) or c.sliding_window

    # ------------------------------------------------------------- pieces
    def _attn_flops(self, new_tokens: float, ctx: float) -> float:
        """score+value flops for new_tokens attending to ctx positions."""
        c = self.cfg
        if c.family == "ssm":
            s = c.ssm
            # SSD: O(1) state ops per token
            return 2 * new_tokens * c.n_layers * s.n_heads(c.d_model) * \
                s.head_dim * s.d_state * 2
        if self.attn_window:
            ctx = min(ctx, self.attn_window)
        frac = 1.0
        if c.family == "hybrid":
            pat = c.hybrid.pattern
            frac = pat.count("attn") / len(pat)
        return 4 * c.n_layers * frac * c.q_dim * new_tokens * ctx

    def prefill_chunk(self, start: int, length: int) -> Tuple[float, float]:
        """(flops, bytes) for prefilling chunk [start, start+length)."""
        flops = 2 * self.n_active * length + \
            self._attn_flops(length, start + length / 2)
        bytes_ = self.kv_bytes_per_token * length
        return flops, bytes_

    def decode_tokens(self, context_lens: Sequence[int]) -> Tuple[float, float]:
        """(flops, bytes) for one decode iteration over the given requests."""
        b = len(context_lens)
        flops = 2 * self.n_active * b
        bytes_ = 0.0
        for ctx in context_lens:
            flops += self._attn_flops(1, ctx)
            eff_ctx = min(ctx, self.attn_window) if self.attn_window else ctx
            bytes_ += self.kv_bytes_per_token * eff_ctx + self.state_bytes_per_seq
        return flops, bytes_

    # ---------------------------------------------------------- iteration
    def iteration_time(self, prefill_chunks: List[Tuple[int, int]],
                       decode_ctx: Sequence[int]) -> float:
        """Mixed (chunked-prefill) batch iteration: chunks = [(start, len)]."""
        flops, bytes_ = 0.0, 0.0
        if decode_ctx:
            f, m = self.decode_tokens(decode_ctx)
            flops += f
            bytes_ += m
        for start, length in prefill_chunks:
            f, m = self.prefill_chunk(start, length)
            flops += f
            bytes_ += m
        if flops == 0 and bytes_ == 0:
            return 0.0
        bytes_ += self.param_bytes                      # weights read once/iter
        return max(flops / self.prof.flops, bytes_ / self.prof.bw) + \
            self.prof.overhead

    def prefill_time(self, input_len: int) -> float:
        """Whole-prompt prefill (used for profiling the TTFT predictor)."""
        return self.iteration_time([(0, input_len)], [])

    def spec_iteration_time(self, decode_ctx: Sequence[int],
                            spec: "SpeculationModel") -> float:
        """One self-speculative decode round (DESIGN.md §12): k truncated
        draft steps (``draft_frac`` of the layer stack → that fraction of
        the flops, KV traffic and weight bytes, weights re-read per step)
        plus one full verify pass over the k+1 candidate positions (flops
        scale with positions; KV and weights are read once). Emits
        ``spec.expected_emitted`` tokens on average, so per-token cost
        falls in the memory-bound regime — the speedup Eq.(1)/(2) and the
        autoscaler observe through shorter decode iterations."""
        if not decode_ctx:
            return 0.0
        fd, md = self.decode_tokens(decode_ctx)
        df = spec.draft_frac
        flops = spec.k * df * fd + (spec.k + 1) * fd
        bytes_ = spec.k * df * (md + self.param_bytes) \
            + md + self.param_bytes
        return max(flops / self.prof.flops, bytes_ / self.prof.bw) \
            + self.prof.overhead

    # ------------------------------------------------------------ capacity
    def kv_capacity_tokens(self) -> int:
        free = self.prof.hbm * 0.85 - self.param_bytes
        per = max(self.kv_bytes_per_token, 1.0)
        if self.cfg.family == "ssm":
            per = 64.0  # nominal bookkeeping unit; state is per-seq not per-token
        return max(int(free / per), 1024)

    def migration_bytes(self, kv_tokens: int) -> float:
        """Wire size of migrating a request holding ``kv_tokens`` of context
        (DESIGN.md §13): per-token KV for the attention layers plus the
        constant per-sequence recurrent state — O(1) in context length for
        ssm, window-bounded-plus-constant for hybrid."""
        return self.kv_bytes_per_token * kv_tokens + self.state_bytes_per_seq

    def transfer_time_bytes(self, bytes_: float, ici_links: int = 1) -> float:
        return self.prof.link_latency + \
            bytes_ / (self.prof.link_bw * ici_links)

    def transfer_time(self, kv_tokens: int, ici_links: int = 1) -> float:
        return self.transfer_time_bytes(self.migration_bytes(kv_tokens),
                                        ici_links)

    def max_running_tokens(self, tpot: float, batch_hint: int = 64) -> int:
        """Profile Max Running Tokens (§5.3): largest total context such that
        a decode iteration stays within the TPOT budget."""
        lo, hi = 1024, 64 * 1024 * 1024
        while lo < hi:
            mid = (lo + hi + 1) // 2
            ctx = [mid // batch_hint] * batch_hint
            if self.iteration_time([], ctx) <= tpot:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def profile_ttft_samples(self) -> List[Tuple[int, float]]:
        """Startup profiling sweep for the TTFT predictor fit."""
        return [(L, self.prefill_time(L))
                for L in (64, 256, 1024, 2048, 4096, 8192, 16384, 32768, 65536)]
