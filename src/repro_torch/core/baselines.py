"""Baseline estimators (paper §4.3): Naive, Online-M, Online-P.

All three are *node-unaware*: they predict the same runtime for every
target node — exactly how the paper evaluates them in the heterogeneous
scenario (their errors blow up on nodes unlike the training machine).
"""
from __future__ import annotations

import numpy as np
from scipy import stats

from .blr import pearson


class NaiveEstimator:
    """mean ratio r = mean(run_q / d_q); prediction = r * d."""

    def fit(self, sizes, runtimes):
        sizes = np.asarray(sizes, np.float64)
        runtimes = np.asarray(runtimes, np.float64)
        self.ratio_ = float(np.mean(runtimes / np.maximum(sizes, 1e-12)))
        return self

    def predict(self, size):
        return self.ratio_ * np.asarray(size, np.float64)


class OnlineM:
    """Da Silva et al. (Online-M): nearest data point (density clustering is
    impossible on the sparse local data, per the paper), ratio prediction if
    input-output correlation is significant, mean otherwise."""

    threshold = 0.75

    def fit(self, sizes, runtimes):
        self.sizes_ = np.asarray(sizes, np.float64)
        self.runtimes_ = np.asarray(runtimes, np.float64)
        self.corr_ = pearson(self.sizes_, self.runtimes_)
        self.mean_ = float(np.mean(self.runtimes_))
        return self

    def _ratio_pred(self, size):
        size = np.asarray(size, np.float64)
        idx = np.argmin(np.abs(self.sizes_[None, ...]
                               - np.atleast_1d(size)[..., None]), axis=-1)
        r = self.runtimes_[idx] / np.maximum(self.sizes_[idx], 1e-12)
        out = r * size
        return out if out.shape else float(out)

    def _uncorrelated(self, size):
        return np.full(np.shape(size), self.mean_) if np.shape(size) else self.mean_

    def predict(self, size):
        if self.corr_ > self.threshold:
            return self._ratio_pred(size)
        return self._uncorrelated(size)


class OnlineP(OnlineM):
    """Online-P: like Online-M but fits a Normal or Gamma distribution for
    the uncorrelated case and predicts its mean."""

    def fit(self, sizes, runtimes):
        super().fit(sizes, runtimes)
        y = self.runtimes_
        if len(y) >= 3 and np.std(y) > 0 and np.all(y > 0):
            # pick Normal vs Gamma by log-likelihood
            mu, sd = float(np.mean(y)), float(np.std(y, ddof=1) + 1e-12)
            ll_norm = float(np.sum(stats.norm.logpdf(y, mu, sd)))
            try:
                a, loc, scale = stats.gamma.fit(y, floc=0.0)
                ll_gamma = float(np.sum(stats.gamma.logpdf(y, a, loc, scale)))
            except (ValueError, RuntimeError):
                # scipy's MLE raises ValueError on degenerate samples and
                # FitError (a RuntimeError) on non-convergence; either way
                # the Gamma candidate simply loses the model selection
                ll_gamma = -np.inf
            if ll_gamma > ll_norm:
                self.dist_mean_ = float(a * scale)
            else:
                self.dist_mean_ = mu
        else:
            self.dist_mean_ = float(np.mean(y))
        return self

    def _uncorrelated(self, size):
        return (np.full(np.shape(size), self.dist_mean_)
                if np.shape(size) else self.dist_mean_)


BASELINES = {"naive": NaiveEstimator, "online_m": OnlineM, "online_p": OnlineP}
