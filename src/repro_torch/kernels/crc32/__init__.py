from repro_torch.kernels.crc32.ops import crc32_host, crc32_op  # noqa: F401
from repro_torch.kernels.crc32.ref import crc32_ref  # noqa: F401
