"""Gaussian-process regression + Bayesian optimization for autotuning
(copy of ``horovod_tpu/core/optim.py``, which is numpy only).

Reference: ``horovod/common/optim/gaussian_process.{h,cc}`` and
``optim/bayesian_optimization.{h,cc}`` (Eigen + LBFGS).  Numpy is the
right tool here — the GP fits tens of points over a 2-4 dim space, so
closed-form Cholesky solves beat a native reimplementation.
"""

import numpy as np


class GaussianProcess:
    """RBF-kernel GP regression (reference gaussian_process.h Matern
    is close enough to RBF at this sample scale)."""

    def __init__(self, length_scale=1.0, signal_variance=1.0,
                 noise=1e-4):
        self.length_scale = length_scale
        self.signal_variance = signal_variance
        self.noise = noise
        self._X = None
        self._y = None
        self._L = None
        self._alpha = None

    def _kernel(self, A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return self.signal_variance * np.exp(
            -0.5 * d2 / self.length_scale ** 2)

    def fit(self, X, y):
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        y = np.asarray(y, dtype=np.float64)
        self._ymean = y.mean() if y.size else 0.0
        yc = y - self._ymean
        K = self._kernel(X, X) + self.noise * np.eye(len(X))
        self._L = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, yc))
        self._X = X
        self._y = y

    def predict(self, Xs):
        Xs = np.atleast_2d(np.asarray(Xs, dtype=np.float64))
        Ks = self._kernel(Xs, self._X)
        mu = Ks @ self._alpha + self._ymean
        v = np.linalg.solve(self._L, Ks.T)
        var = np.clip(
            self.signal_variance - (v ** 2).sum(axis=0), 1e-12, None)
        return mu, np.sqrt(var)


def expected_improvement(mu, sigma, best, xi=0.01):
    """EI acquisition (reference bayesian_optimization.cc)."""
    from math import erf, sqrt

    imp = mu - best - xi
    z = imp / sigma
    cdf = 0.5 * (1.0 + np.vectorize(erf)(z / sqrt(2.0)))
    pdf = np.exp(-0.5 * z ** 2) / np.sqrt(2 * np.pi)
    return imp * cdf + sigma * pdf


class BayesianOptimizer:
    """Maximize a black-box score over a box of normalized [0,1]^d
    parameters (reference BayesianOptimization: EI over GP posterior,
    candidates sampled instead of LBFGS-polished)."""

    def __init__(self, dims, seed=0, noise=1e-3):
        self.dims = dims
        self._rng = np.random.RandomState(seed)
        self._X = []
        self._y = []
        self._gp = GaussianProcess(length_scale=0.3, noise=noise)

    def observe(self, x, score):
        self._X.append(np.asarray(x, dtype=np.float64))
        self._y.append(float(score))

    def suggest(self):
        if len(self._X) < 2:
            return self._rng.uniform(size=self.dims)
        self._gp.fit(np.stack(self._X), np.asarray(self._y))
        cands = self._rng.uniform(size=(256, self.dims))
        mu, sigma = self._gp.predict(cands)
        ei = expected_improvement(mu, sigma, max(self._y))
        return cands[int(np.argmax(ei))]

    def best(self):
        if not self._y:
            return None, None
        i = int(np.argmax(self._y))
        return self._X[i], self._y[i]
