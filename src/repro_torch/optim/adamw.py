"""AdamW over the port's flat parameter dict, as the JAX package's
``repro.optim.adamw``: the moments are float32 whatever the parameter
dtype, and the update is computed in float32 and cast back to each
parameter's dtype. ``torch.optim.AdamW`` differs on both counts (moments in
the parameter's dtype, decoupled decay applied before the step), so it is
not used.

``adamw_update`` is functional: it returns new parameters and a new state
and leaves its inputs as they were.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

Params = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor         # 0-d int32, on the CPU
    mu: Params
    nu: Params


def adamw_init(params: Params) -> AdamWState:
    def f32(p):
        # zeros_like: a DTensor parameter's moments are placed as it is
        return torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu={k: f32(p) for k, p in params.items()},
                      nu={k: f32(p) for k, p in params.items()})


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: AdamWState, *,
                 lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01):
    """One step. Returns (new_params, new_state)."""
    step = state.step + 1
    t = step.float()
    # the bias corrections in float32, as the reference computes them; 0-d
    # host tensors, read by no host sync (the dry-run traces this step on
    # fake tensors), that the card divides by as it does by Python floats
    f32 = torch.float32
    bc1 = 1.0 - torch.tensor(b1, dtype=f32) ** t
    bc2 = 1.0 - torch.tensor(b2, dtype=f32) ** t
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].float()
        m = b1 * state.mu[k] + (1 - b1) * g32
        v = b2 * state.nu[k] + (1 - b2) * torch.square(g32)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p32 = p.float()
        new_p[k] = (p32 - lr * (u + weight_decay * p32)).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v)
