"""Mean host milliseconds of a ``step()`` of the cluster that dispatched
or finalized an instance step (its wait included, when it blocks on the
oldest inflight step), taken by the harness over the window (a traced run:
the profiler records device activity only). In the prefill-heavy cells,
where a pass lands in the token gaps."""
from arrow_bench import readers


def read(run):
    return readers.pass_ms(run)
