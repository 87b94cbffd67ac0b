"""Arrow's core contribution: stateless instances, elastic instance pools and
SLO-aware adaptive request/instance scheduling (paper §5), plus the unified
``ServingSystem`` streaming front-end both backends implement (DESIGN.md §1)."""
from repro_torch.core.autoscaler import (AutoScaler, AutoScalerConfig,  # noqa: F401
                                   ScaleEvent, ScaleSignals)
from repro_torch.core.clock import Clock, VirtualClock, WallClock  # noqa: F401
from repro_torch.core.faults import (FaultEvent, FaultInjector,  # noqa: F401
                               FaultPlan)
from repro_torch.core.global_scheduler import (DeflectionConfig,  # noqa: F401
                                         DeflectionPolicy, GlobalScheduler,
                                         NoSchedulableInstance,
                                         ScheduleOutcome)
from repro_torch.core.health import HealthConfig, HealthMonitor  # noqa: F401
from repro_torch.core.local_scheduler import IterationPlan, LocalScheduler  # noqa: F401
from repro_torch.core.monitor import InstanceMonitor, InstanceStats  # noqa: F401
from repro_torch.core.policies import POLICIES  # noqa: F401
from repro_torch.core.pools import InstancePools, Lifecycle, Pool  # noqa: F401
from repro_torch.core.prefix_index import (PrefixCacheManager, PrefixHit,  # noqa: F401
                                     PrefixIndex, content_keys, lineage_keys)
from repro_torch.core.request import (Phase, Request, RequestState,  # noqa: F401
                                SamplingParams)
from repro_torch.core.runtime import DecodePlacement, RuntimeCore  # noqa: F401
from repro_torch.core.serving import (RequestHandle, ServeReport, ServingSystem,  # noqa: F401
                                SLOTier, TIERS, UndispatchableError,
                                replay_trace)
from repro_torch.core.slo import SLO, SchedulerConfig  # noqa: F401
from repro_torch.core.tenants import (AdmissionConfig,  # noqa: F401
                                AdmissionController, AdmissionDecision,
                                Admitted, CreditLedger, CreditLedgerConfig,
                                Deferred, Rejected, RetryQueue, Tenant,
                                TenantRegistry, default_registry)
from repro_torch.core.ttft_predictor import TTFTPredictor  # noqa: F401
