"""The port's distribution layer on ``torch.distributed`` / DTensor, as the
JAX package's ``repro.distributed``: the sharding rules (:mod:`.sharding`)
and the step builders of the dry-run and of the steps on a mesh
(:mod:`.steps`)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    act_batch_axes_for, batch_spec, cache_shardings, cache_spec,
    distribute_cache, distribute_params, param_shardings, param_spec,
    placements)
