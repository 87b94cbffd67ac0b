from repro_torch.kernels.paged_attention.ops import paged_attention_op  # noqa: F401
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: F401
