from repro_torch.sim.cost_model import (CostModel, InstanceProfile,  # noqa: F401
                                  SpeculationModel)
from repro_torch.sim.policies import POLICIES  # noqa: F401
from repro_torch.sim.simulator import SimResult, Simulator  # noqa: F401
