"""How ``correct`` is decided: the served tokens of a sample of finished
requests against the plain float32 reference.

The sample is drawn from the seed among the requests the run finished,
and always holds the longest of them (prompt plus output); requests are
added until it holds ``sample_tokens`` served tokens. For each, the
reference runs once over the prompt and the served tokens, and at each
served position reads by how much the served token's logit lies below the
reference's best: the widest such gap over the sample is compared with the
configuration's ``max_logit_gap``. Greedy decoding serves the argmax, so a
sound run's gaps are rounding.

The control (``control=True``) is the reference in float8 e4m3 put in the
program's place: at the same positions, the gap of the token the float8
model puts first (``control_gap``), which the harness then judges against
the same limit instead of the program's.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def sample(reqs, seed: int, target_tokens: int) -> List:
    done = sorted((r for r in reqs if r.finished and r.tokens),
                  key=lambda r: r.rid)
    if not done:
        return []
    longest = max(done, key=lambda r: (r.prompt_len + len(r.tokens), -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0xC0])
    rng.shuffle(rest)
    chosen, n = [longest], len(longest.tokens)
    for r in rest:
        if n >= target_tokens:
            break
        chosen.append(r)
        n += len(r.tokens)
    return chosen


def gaps(cell, params, chosen, control: bool = False) -> Dict[str, float]:
    """The widest gap of the served tokens over ``chosen`` (and, with
    ``control``, of the float8 reference's first choices)."""
    ref, conf = cell.reference, cell.conf
    V = conf["vocab_size"]
    worst, worst8, tokens = 0.0, 0.0, 0
    for r in chosen:
        served = np.asarray(r.tokens, np.int64)
        if served.min() < 0 or served.max() >= V:
            return {"logit_gap": float("inf"), "served_tokens": len(served)}
        seq = np.concatenate([r.prompt, served[:-1]])
        pos = list(range(r.prompt_len - 1, len(seq)))
        logits = ref.logits_at(conf, params, seq, pos)
        best = logits.max(dim=-1).values
        idx = torch.arange(len(pos), device=logits.device)
        got = logits[idx, torch.as_tensor(served, device=logits.device)]
        worst = max(worst, float((best - got).max()))
        if control:
            low = ref.logits_at(conf, params, seq, pos, precision="fp8")
            pick = low.argmax(dim=-1)
            worst8 = max(worst8, float((best - logits[idx, pick]).max()))
        tokens += len(served)
        del logits
    out = {"logit_gap": worst, "served_tokens": tokens}
    if control:
        out["control_gap"] = worst8
    return out


def wrong_length(reqs) -> int:
    """Finished requests that did not serve exactly their output length."""
    return sum(1 for r in reqs if r.finished
               and len(r.tokens) != r.output_len)
