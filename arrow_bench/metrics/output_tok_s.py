"""Output tokens that landed in the window over the window's seconds."""
from arrow_bench import readers


def read(run):
    return readers.tokens_in_window(run) / (run.window[1] - run.window[0])
