"""Bayesian hyperparameter search: GP + expected improvement over a sweep grid.

The port's copy of the JAX package's `codebase_tpu/bayes.py` (numpy only,
no torch): a Gaussian process with an RBF kernel and expected-improvement
acquisition proposes the next configuration from the candidate set spanned
by the sweep spec instead of exhausting it. Given the seed it proposes what
the JAX module proposes.

- candidates are the discrete grid of the spec's axes (the set `locally`
  would exhaust); EI orders the visits and stops at the budget;
- numeric axes are normalised to [0, 1] (log-scale when positive and
  spanning >= 10x, the lr case); non-numeric axes are one-hot;
- exact GP inference (Cholesky): at a few hundred observations at most;
- deterministic given the seed.

Driven by `python -m codebase_tpu_torch.search run ... bayes --budget N`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np


def encode_axes(axes: Dict[str, Sequence]) -> "AxisEncoder":
    return AxisEncoder(axes)


class AxisEncoder:
    """Map {axis: value} dicts to normalised feature vectors."""

    def __init__(self, axes: Dict[str, Sequence]):
        self.axes = {k: list(v) for k, v in axes.items()}
        self._spec = {}
        for name, values in self.axes.items():
            numeric = all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in values)
            if numeric and len(set(values)) > 1:
                vals = np.asarray(values, np.float64)
                log = bool(np.all(vals > 0) and vals.max() / vals.min() >= 10.0)
                x = np.log(vals) if log else vals
                self._spec[name] = ("numeric", log, float(x.min()), float(x.max()))
            else:
                self._spec[name] = ("categorical", None, None, None)

    @property
    def dim(self) -> int:
        d = 0
        for name, (kind, *_rest) in self._spec.items():
            d += 1 if kind == "numeric" else len(self.axes[name])
        return d

    def encode(self, combo: Dict) -> np.ndarray:
        feats: List[float] = []
        for name, (kind, log, lo, hi) in self._spec.items():
            v = combo[name]
            if kind == "numeric":
                x = math.log(v) if log else float(v)
                feats.append((x - lo) / (hi - lo) if hi > lo else 0.0)
            else:
                onehot = [1.0 if v == c else 0.0 for c in self.axes[name]]
                feats.extend(onehot)
        return np.asarray(feats, np.float64)


def _rbf(a: np.ndarray, b: np.ndarray, lengthscale: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / lengthscale**2)


@dataclass
class GPOptimizer:
    """Exact-GP expected-improvement optimiser over a fixed candidate set."""

    candidates: List[Dict]
    encoder: AxisEncoder
    seed: int = 0
    lengthscale: float = 0.3
    noise: float = 1e-4
    n_init: int = 3
    xs: List[np.ndarray] = field(default_factory=list)
    ys: List[float] = field(default_factory=list)
    visited: set = field(default_factory=set)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._X = np.stack([self.encoder.encode(c) for c in self.candidates])

    def observe(self, combo_idx: int, objective: float) -> None:
        self.visited.add(combo_idx)
        self.xs.append(self._X[combo_idx])
        self.ys.append(float(objective))

    def suggest(self) -> int:
        """Index of the next candidate to evaluate (maximisation)."""
        remaining = [i for i in range(len(self.candidates)) if i not in self.visited]
        if not remaining:
            raise StopIteration("candidate set exhausted")
        if len(self.ys) < self.n_init:
            return int(self._rng.choice(remaining))
        mu, sigma = self._posterior(self._X[remaining])
        best = max(self.ys)
        # expected improvement (maximisation), xi = tiny exploration bonus
        xi = 1e-3
        imp = mu - best - xi
        z = np.where(sigma > 0, imp / np.maximum(sigma, 1e-12), 0.0)
        ei = imp * _norm_cdf(z) + sigma * _norm_pdf(z)
        ei = np.where(sigma > 0, ei, 0.0)
        return int(remaining[int(np.argmax(ei))])

    def _posterior(self, Xq: np.ndarray):
        X = np.stack(self.xs)
        y = np.asarray(self.ys, np.float64)
        y_mean, y_std = y.mean(), max(y.std(), 1e-9)
        yn = (y - y_mean) / y_std
        K = _rbf(X, X, self.lengthscale) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        Ks = _rbf(Xq, X, self.lengthscale)
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.clip(1.0 - np.sum(v**2, axis=0), 0.0, None)
        return mu * y_std + y_mean, np.sqrt(var) * y_std


def _norm_cdf(z):
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _norm_pdf(z):
    return np.exp(-0.5 * z**2) / math.sqrt(2.0 * math.pi)


def optimise(
    candidates: List[Dict],
    axes: Dict[str, Sequence],
    evaluate,
    budget: int,
    seed: int = 0,
) -> Dict:
    """Run the BO loop: `evaluate(combo_dict) -> float` (higher is better).

    Returns {"best": combo, "best_value": float, "history": [(combo, y)]}.
    """
    opt = GPOptimizer(candidates, encode_axes(axes), seed=seed)
    history = []
    for _ in range(min(budget, len(candidates))):
        idx = opt.suggest()
        y = float(evaluate(candidates[idx]))
        opt.observe(idx, y)
        history.append((candidates[idx], y))
    best_combo, best_y = max(history, key=lambda t: t[1])
    return {"best": best_combo, "best_value": best_y, "history": history}
