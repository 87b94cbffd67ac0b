from repro_torch.optim.adamw import (AdamWState, adamw_init,  # noqa: F401
                                     adamw_update)
