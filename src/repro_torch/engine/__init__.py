from repro_torch.engine.cluster import ArrowEngineCluster, ServeRequest  # noqa: F401
from repro_torch.engine.instance import (ChunkWork, EngineInstance,  # noqa: F401
                                         NoFreeSlots)
from repro_torch.engine.kv_slots import SlotKVCache  # noqa: F401
