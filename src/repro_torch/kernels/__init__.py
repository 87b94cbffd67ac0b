"""Hand-written Hopper (sm_90a) kernels of the serving engine's hot spots.

Each subpackage: ``csrc/<name>.cu`` (the CUDA kernel with a plain C entry
point, built by ``_build`` at first use), ``ops.py`` (the wrapper: checks,
allocation, launch counting; plain torch on CPU tensors) and ``ref.py``
(the plain-torch version):

  flash_prefill   — causal GQA flash attention for whole-prompt and chunked
                    prefill (runtime query offset, optional sliding window)
  paged_attention — single-query decode attention over a paged KV pool
"""
from repro_torch.kernels.flash_prefill import (flash_chunk_op,  # noqa: F401
                                               flash_seq_op)
from repro_torch.kernels.paged_attention import paged_attention_op  # noqa: F401

WRAPPERS = (flash_seq_op, flash_chunk_op, paged_attention_op)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
