"""The whole step's share of the card's bf16 peak in the profiled slice:
the model operations of the work dispatched in the slice (each prompt and
decoded token through every layer, attention at the token's context, the
output head at each sampled position; from the configuration's widths)
over the slice's engine time (the harness's ``step()`` calls that
dispatched or finalized work) times 989e12, in percent."""
from arrow_bench import readers


def read(run):
    return readers.step_mfu(run)
