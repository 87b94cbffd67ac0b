"""TTFT predictor (§5.3): profile each instance's prefill time as a quadratic
in input length (prefill compute is O(L²) attention + O(L) MLP), fit once at
cluster launch, then predict queueing + compute time for any queue state.

For SSM/hybrid architectures the quadratic coefficient fits ≈ 0 and the
predictor degrades gracefully to linear — no code change (DESIGN.md §4).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class TTFTPredictor:
    def __init__(self, coeffs: Sequence[float] = (0.0, 0.0, 0.0)):
        self.coeffs = np.asarray(coeffs, np.float64)   # (a, b, c): a L² + b L + c

    @classmethod
    def fit(cls, samples: Sequence[Tuple[int, float]]) -> "TTFTPredictor":
        """samples: (input_len, measured prefill seconds)."""
        L = np.asarray([s[0] for s in samples], np.float64)
        t = np.asarray([s[1] for s in samples], np.float64)
        # least squares on [L², L, 1]; clip to non-negative prediction later
        A = np.stack([L * L, L, np.ones_like(L)], axis=1)
        coeffs, *_ = np.linalg.lstsq(A, t, rcond=None)
        if coeffs[0] < 0.0:
            # noisy / short-context samples can fit a < 0, which makes
            # predict_chunk non-monotone (suffix chunks silently clamp to 0
            # and corrupt prefix-affinity and deflection charging) — prefill
            # compute can only be superlinear, so refit linear instead
            lin, *_ = np.linalg.lstsq(A[:, 1:], t, rcond=None)
            coeffs = np.concatenate([[0.0], lin])
        return cls(coeffs)

    def predict(self, input_len: int) -> float:
        a, b, c = self.coeffs
        return float(max(a * input_len * input_len + b * input_len + c, 0.0))

    def predict_chunk(self, start: int, length: int) -> float:
        """Time for a chunked-prefill slice [start, start+length) of a longer
        prompt: the attention term is quadratic, so a chunk's cost is the
        difference of the cumulative quadratic."""
        return max(self.predict(start + length) - self.predict(start), 0.0)


class PerInstancePredictor:
    """Heterogeneous clusters (paper §8): one fitted quadratic per instance.
    Exposes the same ``predict`` API with an optional instance id; the global
    scheduler passes the candidate instance when available."""

    def __init__(self, default: TTFTPredictor):
        self.default = default
        self.per_instance = {}

    @classmethod
    def fit_per_instance(cls, samples_by_iid) -> "PerInstancePredictor":
        if not samples_by_iid:
            raise ValueError(
                "fit_per_instance needs profiling samples for at least one "
                "instance; got an empty samples_by_iid mapping")
        fitted = {iid: TTFTPredictor.fit(s) for iid, s in samples_by_iid.items()}
        any_pred = next(iter(fitted.values()))
        obj = cls(any_pred)
        obj.per_instance = fitted
        return obj

    def for_instance(self, iid) -> TTFTPredictor:
        return self.per_instance.get(iid, self.default)

    def predict(self, input_len: int, iid=None) -> float:
        return self.for_instance(iid).predict(input_len)

    def predict_chunk(self, start: int, length: int, iid=None) -> float:
        return self.for_instance(iid).predict_chunk(start, length)
