"""``model.step_mfu`` in the decode-heavy cells: the slice's model
operations, nearly all of them decoded tokens, over its engine time times
989e12, in percent."""
from arrow_bench import readers


def read(run):
    return readers.step_mfu(run)
