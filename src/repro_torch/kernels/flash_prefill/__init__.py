from repro_torch.kernels.flash_prefill.ops import (flash_chunk_op,  # noqa: F401
                                                   flash_seq_op)
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref  # noqa: F401
