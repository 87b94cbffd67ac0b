"""Hand-written Hopper (sm_90a) kernels of the serving engine's hot spots.

Each subpackage: ``csrc/<name>.cu`` (the CUDA kernel with a plain C entry
point, built by ``_build`` at first use), ``ops.py`` (the wrapper: checks,
allocation, launch counting; plain torch on CPU tensors) and ``ref.py``
(the plain-torch version):

  flash_prefill   — causal GQA flash attention for whole-prompt and chunked
                    prefill (runtime query offset, optional sliding window)
  paged_attention — single-query decode attention over a paged KV pool
                    (dense family)
  ssd_scan        — the Mamba-2 SSD chunked scan of every prefill chunk
                    (ssm family)
  rglru_scan      — the RG-LRU recurrence of every prefill chunk (hybrid
                    family)
  crc32           — zlib's CRC-32 of a migration payload where it lies
                    (every family; no TPU counterpart)

The kernels have no backward: on CUDA inputs that require grad a wrapper
raises (``_build.refuse_grad``) rather than return an output cut off from
autograd. The plain versions on the CPU are differentiable.
"""
from repro_torch.kernels.crc32 import crc32_op  # noqa: F401
from repro_torch.kernels.flash_prefill import (flash_chunk_op,  # noqa: F401
                                               flash_seq_op)
from repro_torch.kernels.paged_attention import paged_attention_op  # noqa: F401
from repro_torch.kernels.rglru_scan import rglru_scan_op  # noqa: F401
from repro_torch.kernels.ssd_scan import ssd_scan_op  # noqa: F401

WRAPPERS = (flash_seq_op, flash_chunk_op, paged_attention_op, ssd_scan_op,
            rglru_scan_op, crc32_op)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
