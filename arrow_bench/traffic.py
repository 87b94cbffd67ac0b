"""The benchmark's one traffic generator, driven by a mix's file.

Lengths follow the program's trace presets (``repro_torch/traces/synth.py``
at the time the benchmark was defined, frozen here): input and output
lengths lognormal around a median with a log-sd, their logs correlated by
``in_out_corr`` (``z_out = rho z_in + sqrt(1 - rho^2) z2``), inputs clipped
to [``min_input``, ``max_input``] and outputs to [1, ``max_output``]; the
engine's slot then clamps each input to ``capacity - output``. Arrivals
are open-loop Poisson at the cell's rate.

Every seed gets the same schedule. The pre-roll and the measured window
are each a segment of N = rate x its seconds requests: the segment's
log-lengths are the N stratified quantiles of the normal, paired, and put
in an order, by permutations that the mix's ``schedule_seed`` fixes, and
its gaps the N stratified quantiles of the exponential, in an order it
fixes too, scaled so the segment's arrivals fill its seconds. ``--seed``
draws every prompt's tokens (and the weights, and the correctness sample).
At these rates a window holds tens of requests, and which of them meet a
migration stall decides a tail: drawn per seed, the order moved a cell's
tails and output rate between seeds far more than between two runs of one
seed, so the order is the schedule's, not the seed's. ``preroll_burst`` more requests
are due at once when traffic starts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np


@dataclass
class Arrival:
    rid: int
    due: float                # seconds after traffic starts
    prompt: np.ndarray        # int32 token ids
    output_len: int


def stratified_normal(n: int) -> np.ndarray:
    nd = NormalDist()
    return np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])


def stratified_exponential(n: int, rate: float) -> np.ndarray:
    return -np.log1p(-(np.arange(n) + 0.5) / n) / rate


def lengths(mix: dict, n: int):
    """The mix's (input, output) lengths of ``n`` requests, as a fixed set
    (before the slot's clamp), in the pairing's order."""
    z_in = stratified_normal(n)
    pair = np.random.default_rng(mix["schedule_seed"]).permutation(n)
    z2 = stratified_normal(n)[pair]
    rho = mix["in_out_corr"]
    z_out = rho * z_in + math.sqrt(max(1 - rho * rho, 0.0)) * z2
    ins = np.clip(np.exp(math.log(mix["in_median"]) + mix["in_sigma"] * z_in),
                  mix["min_input"], mix["max_input"]).astype(int)
    outs = np.clip(np.exp(math.log(mix["out_median"])
                          + mix["out_sigma"] * z_out),
                   1, mix["max_output"]).astype(int)
    return ins, outs


def _segment(mix: dict, n: int, n_sizes: int, start: float, length: float,
             part: int):
    """``n_sizes`` requests of a stratified set (the first ``n_sizes - n``
    due at ``start``, the rest spread over [start, start + length) by a
    stratified set of ``n`` exponential gaps scaled to fill it), in the
    schedule's order: (due, input, output) each."""
    seed = mix["schedule_seed"] + part
    ins, outs = lengths(dict(mix, schedule_seed=seed), n_sizes)
    rng = np.random.default_rng([seed, 0x5C4E])
    order = rng.permutation(n_sizes)
    dues = [start] * (n_sizes - n)
    if n:
        g = stratified_exponential(n, 1.0)[rng.permutation(n)]
        c = np.concatenate([[0.0], np.cumsum(g)[:-1]])
        dues += list(start + length * c / g.sum())
    return [(d, int(ins[j]), int(outs[j])) for d, j in zip(dues, order)]


def requests(mix: dict, rate: float, preroll_s: float, seconds: float,
             seed: int, vocab: int) -> List[Arrival]:
    """The requests of one run, in arrival order: the pre-roll's (a
    backlog of ``preroll_burst`` due at 0, then ``rate x preroll_s`` over
    the pre-roll) and the window's (``rate x seconds``), each segment its
    own stratified set of sizes and gaps in the schedule's order, and the
    prompts' tokens drawn from ``seed``."""
    n_pre = int(round(rate * preroll_s))
    n_win = max(1, int(round(rate * seconds)))
    burst = int(mix.get("preroll_burst", 0))
    plan = (_segment(mix, n_pre, n_pre + burst, 0.0, preroll_s, 0)
            + _segment(mix, n_win, n_win, preroll_s, seconds, 1))
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0x7A11])
    cap = mix["capacity"]
    out = []
    for i, (due, n_in, n_out) in enumerate(plan):
        n_out = min(n_out, cap - mix["min_input"])
        n_in = max(min(n_in, cap - n_out), 1)
        prompt = rng.integers(1, vocab, size=n_in, dtype=np.int32)
        out.append(Arrival(i, float(due), prompt, n_out))
    return out
