"""The frozen traffic generator: the preset's moments, and the same work
for every seed in an order the seed draws."""
import json
import math
from pathlib import Path

import numpy as np
import pytest

from arrow_bench import traffic

MIXES = Path(__file__).resolve().parents[1] / "mixes"


def mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("name,in_med,out_med", [("code", 2600, 28),
                                                 ("conv", 1024, 220)])
def test_lengths_follow_the_preset(name, in_med, out_med):
    m = mix(name)
    ins, outs = traffic.lengths(m, 4001)
    # the middle stratum is the median itself
    assert np.median(ins) == pytest.approx(in_med, rel=0.01)
    assert np.median(outs) == pytest.approx(out_med, rel=0.05)
    # quartiles of the lognormal (no clip reaches them)
    q = 0.6744897501960817
    for v, med, sd in ((ins, in_med, m["in_sigma"]),
                       (outs, out_med, m["out_sigma"])):
        lo_q, hi_q = np.percentile(v, [25, 75])
        assert lo_q == pytest.approx(med * math.exp(-q * sd), rel=0.04,
                                     abs=1.0)
        assert hi_q == pytest.approx(med * math.exp(q * sd), rel=0.04,
                                     abs=1.0)
    lo = np.log(outs)
    keep = (outs > 1) & (outs < m["max_output"]) & (ins > m["min_input"]) \
        & (ins < m["max_input"])
    r = np.corrcoef(np.log(ins[keep]), lo[keep])[0, 1]
    assert r == pytest.approx(m["in_out_corr"], abs=0.03)


def test_same_seed_same_requests():
    m = mix("code")
    a = traffic.requests(m, 1.5, 5.0, 40.0, 2**31 + 5, 1000)
    b = traffic.requests(m, 1.5, 5.0, 40.0, 2**31 + 5, 1000)
    assert [(x.due, x.output_len) for x in a] == \
        [(x.due, x.output_len) for x in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_every_seed_gets_the_same_schedule_with_its_own_tokens():
    m = mix("code")
    a = traffic.requests(m, 2.0, 5.0, 30.0, 1, 1000)
    b = traffic.requests(m, 2.0, 5.0, 30.0, 2, 1000)
    assert [(x.due, len(x.prompt), x.output_len) for x in a] == \
        [(x.due, len(x.prompt), x.output_len) for x in b]
    assert not np.array_equal(a[0].prompt[:8], b[0].prompt[:8])
    win = [x for x in a if x.due >= 5.0]
    gaps = np.diff([x.due for x in win] + [35.0])
    assert len(win) == 60 and gaps.sum() == pytest.approx(30.0)
    # a stratified set, not sorted by size
    sizes = [len(x.prompt) for x in win]
    assert sizes != sorted(sizes) and sizes != sorted(sizes, reverse=True)
    c = traffic.requests(dict(m, schedule_seed=1), 2.0, 5.0, 30.0, 1, 1000)
    assert [x.due for x in c] != [x.due for x in a]


def test_poisson_rate_clamp_and_burst():
    m = dict(mix("conv"), preroll_burst=5)
    reqs = traffic.requests(m, 2.0, 10.0, 100.0, 7, 50277)
    assert len(reqs) == 5 + 20 + 200
    assert [r.due for r in reqs[:5]] == [0.0] * 5
    win = [r.due for r in reqs if r.due >= 10.0]
    assert len(win) == 200 and win[0] == 10.0 and win[-1] < 110.0
    gaps = np.diff(win)
    assert gaps.mean() == pytest.approx(0.5, rel=0.01)
    # stratified exponential gaps: the spread of a Poisson stream's
    assert np.std(gaps) / gaps.mean() == pytest.approx(1.0, abs=0.1)
    assert all(len(r.prompt) + r.output_len <= m["capacity"] for r in reqs)
    assert all(0 < t < 50277 for r in reqs for t in r.prompt[:16])
