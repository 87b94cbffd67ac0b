"""Deprecated location: the policy registry moved to ``repro_torch.core.policies``
so the real engine can run the same baselines as the simulator through
the shared runtime (DESIGN.md §1). This shim keeps old imports working."""
from repro_torch.core.policies import (  # noqa: F401
    POLICIES, ArrowElasticPolicy, ArrowPolicy, BasePolicy, ColocatedPolicy,
    MinimalLoadPolicy, RoundRobinPolicy)
