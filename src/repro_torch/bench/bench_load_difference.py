"""Paper Fig. 4 (Insight 5): prefill vs decode load over time under a rising
burst — prefill peaks earlier than decode."""
from __future__ import annotations

from repro_torch.bench.common import Timer, emit, save_json, sim_profile
from repro_torch.configs import get_config
from repro_torch.core.request import Request
from repro_torch.core.serving import replay_trace
from repro_torch.core.slo import SLO, SchedulerConfig
from repro_torch.sim import Simulator


def main() -> None:
    cfg = get_config("gemma-2b")
    burst = [Request(rid=i, arrival=0.02 * i, input_len=16384, output_len=400)
             for i in range(64)]
    sim = Simulator(cfg, n_instances=8, n_prefill=4, policy="minimal_load",
                    slo=SLO(2.0, 0.15),
                    sched_cfg=SchedulerConfig(monitor_interval=0.05),
                    profile=sim_profile())
    series = []
    orig = sim.policy.on_monitor_tick

    def tick(now):
        orig(now)
        series.append({
            "t": now,
            "prefill_queued": sum(len(sim.locals[i].prefill_queue)
                                  for i in range(8)),
            "decode_running": sum(len(sim.locals[i].decode_running)
                                  for i in range(8)),
        })

    sim.policy.on_monitor_tick = tick
    with Timer() as t:
        replay_trace(sim, burst)
        sim.drain()
    tp = max(series, key=lambda s: s["prefill_queued"])["t"]
    td = max(series, key=lambda s: s["decode_running"])["t"]
    emit("load_difference", t.us,
         f"prefill_peak_t={tp:.2f}s;decode_peak_t={td:.2f}s;lead={td - tp:.2f}s")
    save_json("load_difference", {"series": series, "prefill_peak": tp,
                                  "decode_peak": td})


if __name__ == "__main__":
    main()
