"""SLO settings and scheduler tunables."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SLO:
    ttft: float      # seconds
    tpot: float      # seconds per output token


@dataclass(frozen=True)
class SchedulerConfig:
    """Arrow scheduler knobs (§5). Thresholds are expressed against the SLO."""
    ttft_threshold_frac: float = 0.9   # schedule against 0.9×TTFT SLO (headroom)
    tpot_threshold_frac: float = 0.9
    max_running_tokens: int = 65536    # profiled at startup (Max Running Tokens)
    decode_low_load_frac: float = 0.5  # "decode load is low" test in Alg. 1
    monitor_interval: float = 1.0      # seconds between monitor scrapes
    token_interval_window: int = 32    # recent intervals averaged per instance
    idle_prefill_flip: bool = True     # §5.5(3): idle prefill joins decode
    min_prefill_instances: int = 1
    min_decode_instances: int = 1
    # ---- beyond-paper extension (EXPERIMENTS.md §Perf): proactive flipping.
    # The paper flips reactively when a *predicted TTFT violation* already
    # exists (Alg. 1). With burst detection on the arrival process itself
    # (short-window vs long-window request-token rate), capacity moves to
    # prefill one monitor period earlier, before the queue builds.
    proactive: bool = False
    proactive_ratio: float = 2.5       # short-rate > ratio x long-rate => burst
    proactive_window_s: float = 3.0    # short window (long = 10x)
