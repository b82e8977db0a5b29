"""Bayesian linear regression (the paper's §3.3 predictor), in PyTorch.

Conjugate Normal–Inverse-Gamma model:

    y_i = x_i^T b + eps_i,   eps_i ~ N(0, sigma^2)
    b | sigma^2 ~ N(mu0, sigma^2 V0),   sigma^2 ~ InvGamma(a0, b0)

with a Gaussian (L2 / ridge) prior on the weights, as in the paper.  The
posterior predictive at x* is a Student-t: mean x*^T mu_n, scale^2 =
b_n/a_n (1 + x*^T V_n x*), 2 a_n degrees of freedom.  Features are 1D
(input size) plus an intercept; everything is closed-form and tiny.

Port of ``repro.core.blr``.  Every entry point takes ``device`` (``None``
is the CUDA card; raises without one) and ``dtype`` (``None`` is
float64; ``torch.float32`` is the counterpart of the JAX package's
non-x64 mode).  Posteriors, moments and predictions live on that device;
the raw-sample history (``SampleLog``), the medians and MADs of the
fallback, ``BiasModel`` and ``ReliabilityModel`` stay numpy on the host.

The batched engine: all T per-task posteriors are fitted in ONE closed-form
solve over (T, n) padded samples (``fit_batch`` / ``fit_task_batch``;
masked design rows contribute nothing to X^T X, X^T y or n) and queried
with a batched Student-t predictive.  The 2-vector and 2x2 products are
written out element by element, so a row's numbers do not depend on the
batch it sits in or on the device; the 2x2 inverse is LU
(``torch.linalg.inv_ex``, which checks no error and so never waits on the
card).

The online engine: the NIG posterior is a function of the streamed
moments (n, Σx, Σy, Σx², Σy², Σxy, max|x|, max|y|), so an observation is
a rank-1 moment update plus an O(d²) posterior recompute of its row.
``update_task_batch_stream`` folds a stream into the (T, 8) moments in
stream order (two launches an observation, nothing read back), then
recomputes the posteriors of the rows it touched in one batched solve —
the same numbers as recomputing after every observation, since a
posterior is a function of its row's moments alone.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy import stats as _scipy_stats

from repro_torch import resolve_device


def _default_dtype(dtype=None) -> torch.dtype:
    """The port's numeric dtype policy: float64 unless the caller passes
    another dtype (``torch.float32`` mirrors the JAX package's non-x64
    mode).  One explicit argument on each entry point, no global switch;
    this definition is the policy itself, so the literal below is the one
    sanctioned mention."""
    return torch.float64 if dtype is None else dtype


#: the fields of a posterior, in the order the JSON state stores them
POSTERIOR_FIELDS = ("mu", "V", "a", "b", "x_scale", "y_scale")


def _to_device(a, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A copy of host data as a tensor on ``device``: one host->device
    transfer, from pinned memory and asynchronous on a card, so staging
    inputs never waits on the device."""
    t = torch.tensor(np.asarray(a), dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host, as float64 numpy (one transfer)."""
    return np.asarray(t.detach().cpu().numpy(), np.float64)


def _as_input(v, like: torch.Tensor) -> torch.Tensor:
    """A query point (scalar, numpy or tensor) on ``like``'s device in its
    dtype."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=like.dtype)
    return _to_device(np.asarray(v, np.float64), like.device, like.dtype)


@dataclass(frozen=True)
class BLRPosterior:
    mu: torch.Tensor         # (d,) posterior mean of weights; (T, d) batched
    V: torch.Tensor          # (d, d) posterior covariance factor
    a: torch.Tensor          # shape of InvGamma
    b: torch.Tensor          # scale of InvGamma
    x_scale: torch.Tensor    # feature normalisation
    y_scale: torch.Tensor

    @property
    def dof(self):
        return 2.0 * self.a

    @property
    def sigma2_mean(self):
        return self.b / torch.clamp_min(self.a - 1.0, 1e-6)

    def rows(self, idx) -> "BLRPosterior":
        """The posteriors of rows ``idx`` (host ints or an index tensor) of a
        batched posterior: a gather on the device, the counterpart of the
        JAX package's ``tree_map(lambda a: a[idx], post)``."""
        it = _row_index(idx, self.mu.device)
        return BLRPosterior(*(getattr(self, f).index_select(0, it)
                              for f in POSTERIOR_FIELDS))


def _row_index(idx, device: torch.device) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        return idx
    return _to_device(np.asarray(idx, np.int64), device, torch.int64)


def _solve(p00, p01, p11, t0, t1):
    """Posterior covariance and mean from the precision matrix's entries
    [[p00, p01], [p01, p11]] and X^T y = [t0, t1], each of shape (R,):
    Vn = inverse by LU (``inv_ex``: no error check, so no wait on the card),
    mun = Vn @ X^T y written out element by element."""
    P = torch.stack([torch.stack([p00, p01], -1),
                     torch.stack([p01, p11], -1)], -2)
    Vn = torch.linalg.inv_ex(P).inverse
    mun = torch.stack([Vn[..., 0, 0] * t0 + Vn[..., 0, 1] * t1,
                       Vn[..., 1, 0] * t0 + Vn[..., 1, 1] * t1], -1)
    return Vn, mun


def _fit_core(x, y, mask, prior_scale, a0, b0):
    """Closed-form NIG update over (T, n) padded samples, one row a task.

    ``mask`` entries set to 0 contribute nothing: the design row, the
    target and the effective sample count all vanish, so a padded batch
    solve is exactly the ragged per-task solve.
    """
    xm = x * mask
    ym = y * mask
    x_scale = torch.clamp_min(xm.abs().amax(-1), 1e-12)
    y_scale = torch.clamp_min(ym.abs().amax(-1), 1e-12)
    x1 = xm / x_scale[:, None]          # the size column of the masked design
    yn = ym / y_scale[:, None]
    n = mask.sum(-1)
    prec0 = 1.0 / (prior_scale ** 2)    # V0^-1 = I / prior_scale^2
    Vn, mun = _solve(prec0 + (mask * mask).sum(-1), (mask * x1).sum(-1),
                     prec0 + (x1 * x1).sum(-1),
                     (mask * yn).sum(-1), (x1 * yn).sum(-1))
    an = a0 + n / 2.0
    resid = yn - (mask * mun[:, 0, None] + x1 * mun[:, 1, None])
    bn = torch.clamp_min(b0 + 0.5 * (resid * yn).sum(-1), 1e-12)
    return mun, Vn, an, bn, x_scale, y_scale


def fit(x, y, *, prior_scale: float = 10.0, a0: float = 1.0,
        b0: float = 1.0, device=None, dtype=None) -> BLRPosterior:
    """Fit runtime ~ input_size.  x, y: (n,) arrays (n may be tiny)."""
    post = fit_batch(np.atleast_1d(np.asarray(x, np.float64))[None],
                     np.atleast_1d(np.asarray(y, np.float64))[None],
                     prior_scale=prior_scale, a0=a0, b0=b0, device=device,
                     dtype=dtype)
    return BLRPosterior(*(getattr(post, f)[0] for f in POSTERIOR_FIELDS))


def fit_batch(x, y, mask=None, *, prior_scale: float = 10.0,
              a0: float = 1.0, b0: float = 1.0, device=None,
              dtype=None) -> BLRPosterior:
    """Fit T independent BLRs in one batched solve.

    x, y: (T, n) padded sample arrays; mask: (T, n) validity (1 = real
    sample, 0 = padding).  Returns a ``BLRPosterior`` whose fields carry a
    leading (T,) batch axis.  The three arrays cross to the device in one
    transfer.
    """
    x = np.asarray(x, np.float64)
    m = np.ones_like(x) if mask is None else np.asarray(mask, np.float64)
    xym = _to_device(np.stack([x, np.asarray(y, np.float64), m]),
                     resolve_device(device), _default_dtype(dtype))
    return BLRPosterior(*_fit_core(xym[0], xym[1], xym[2], prior_scale,
                                   a0, b0))


def _quad(V, xn):
    """x^T V x at the design rows [1, xn]: V is (..., 2, 2), xn (..., K)."""
    v = V[..., None, :, :]
    return (v[..., 0, 0] + xn * v[..., 1, 0]) \
        + (v[..., 0, 1] + xn * v[..., 1, 1]) * xn


def _predict_core(mu, V, a, b, x_scale, y_scale, x_star):
    """Student-t predictive mean/std.  Every posterior field carries the
    batch shape B (empty for one posterior; mu (B, 2), V (B, 2, 2)), and
    ``x_star`` is (B, K): K query points per posterior."""
    xn = x_star / x_scale[..., None]
    mean = mu[..., 0, None] + xn * mu[..., 1, None]
    s2 = (b / a)[..., None] * (1.0 + _quad(V, xn))
    dof = (2.0 * a)[..., None]
    var = s2 * dof / torch.clamp_min(dof - 2.0, 1e-6)   # Student-t variance
    return (mean * y_scale[..., None],
            torch.sqrt(torch.clamp_min(var, 0.0)) * y_scale[..., None])


def _core(post: BLRPosterior, x):
    return _predict_core(post.mu, post.V, post.a, post.b, post.x_scale,
                         post.y_scale, x)


def predict(post: BLRPosterior, x_star):
    """Posterior predictive mean and standard deviation at x_star."""
    xs = _as_input(x_star, post.mu)
    mean, std = _core(post, torch.atleast_1d(xs).reshape(-1))
    if xs.ndim == 0:
        return mean.reshape(()), std.reshape(())
    return mean.reshape(xs.shape), std.reshape(xs.shape)


def predict_batch(post: BLRPosterior, x_star):
    """Batched predictive at one point per task.

    ``post`` carries a leading (T,) axis (from ``fit_batch``); ``x_star`` is
    a scalar (broadcast to every task) or a (T,) array.  Returns (T,) mean
    and std.
    """
    x = torch.broadcast_to(_as_input(x_star, post.mu), post.a.shape)
    mean, std = _core(post, x[:, None])
    return mean[:, 0], std[:, 0]


def predict_batch_grid(post: BLRPosterior, xs):
    """Batched predictive on a shared grid: xs (S,) -> (T, S) mean/std."""
    x = _as_input(xs, post.mu).reshape(-1)
    return _core(post, x.expand(post.a.shape[0], x.shape[0]))


def predict_interval(post: BLRPosterior, x_star, confidence: float = 0.5):
    """Equal-tailed predictive interval via the Student-t quantile (scipy,
    on the host).

    Vectorised: works on a scalar posterior with scalar/vector x_star, and
    on batched posteriors (leading (T,) axis) without a Python loop.
    """
    batched = post.a.ndim > 0
    if batched:
        mean, _ = predict_batch(post, x_star)
        xq = torch.broadcast_to(_as_input(x_star, post.mu), post.a.shape)
        quad = _quad(post.V, (xq / post.x_scale)[:, None])[:, 0]
    else:
        mean, _ = predict(post, x_star)
        xq = torch.atleast_1d(_as_input(x_star, post.mu))
        quad = _quad(post.V, xq / post.x_scale)
    scale = _np(torch.sqrt((post.b / post.a) * (1.0 + quad)))
    tq = _scipy_stats.t.ppf(0.5 + confidence / 2.0, df=_np(post.dof))
    half = tq * scale * _np(post.y_scale)
    lo = _np(mean) - half
    hi = _np(mean) + half
    if np.ndim(x_star) == 0 and not batched:
        return (np.float64(lo.reshape(-1)[0]), np.float64(hi.reshape(-1)[0]))
    return lo, hi


def predict_cdf(post: BLRPosterior, x_star, y) -> float:
    """CDF of the posterior predictive at ``y`` — the probability the
    predictive Student-t at input ``x_star`` assigns to runtimes ≤ ``y``.

    The PIT (probability integral transform) primitive: over a calibrated
    stream of realised runtimes it is uniform on [0, 1].  Uses the same
    location / scale / dof as ``predict_interval`` (scalar path), so
    interval coverage and PIT agree by construction.
    """
    mean, _ = predict(post, x_star)
    xq = torch.atleast_1d(_as_input(x_star, post.mu))
    quad = _quad(post.V, xq / post.x_scale)
    scale = float(_np(torch.sqrt((post.b / post.a) * (1.0 + quad)))
                  .reshape(-1)[0]) * float(_np(post.y_scale))
    z = (float(y) - float(_np(mean).reshape(-1)[0])) / max(scale, 1e-300)
    return float(_scipy_stats.t.cdf(z, df=float(_np(post.dof))))


def pearson(x, y) -> float:
    """Pearson correlation coefficient (paper eq. 1)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xd = x - x.mean()
    yd = y - y.mean()
    denom = np.sqrt((xd ** 2).sum() * (yd ** 2).sum())
    if denom == 0:
        return 0.0
    return float((xd * yd).sum() / denom)


def pearson_batch(x, y, mask=None) -> np.ndarray:
    """Vectorised Pearson over (T, n) rows with an optional validity mask."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    m = np.ones_like(x) if mask is None else np.asarray(mask, np.float64)
    n = np.maximum(m.sum(axis=-1), 1.0)
    xd = (x - (x * m).sum(axis=-1, keepdims=True) / n[..., None]) * m
    yd = (y - (y * m).sum(axis=-1, keepdims=True) / n[..., None]) * m
    denom = np.sqrt((xd ** 2).sum(axis=-1) * (yd ** 2).sum(axis=-1))
    num = (xd * yd).sum(axis=-1)
    return np.where(denom == 0, 0.0, num / np.where(denom == 0, 1.0, denom))


CORRELATION_THRESHOLD = 0.8   # paper: "significant if p greater than 0.8"


@dataclass(frozen=True)
class TaskModel:
    """Per-task predictor: BLR when size-runtime correlation is significant,
    median fallback otherwise (paper §3.3)."""
    correlated: bool
    post: BLRPosterior | None
    median: float
    spread: float               # robust std (MAD) for the median fallback

    def predict(self, x_star):
        if self.correlated:
            mean, std = predict(self.post, x_star)
            ms = _np(torch.stack([mean, std]))        # one transfer
            mean = np.maximum(ms[0], 0.0)
            std = ms[1]
            if np.ndim(x_star) == 0:
                return np.float64(mean.reshape(-1)[0]), np.float64(std.reshape(-1)[0])
            return mean, std
        x = np.asarray(x_star, np.float64)
        shape = x.shape if x.ndim else ()
        return (np.full(shape, self.median) if shape else np.float64(self.median),
                np.full(shape, self.spread) if shape else np.float64(self.spread))


def fit_task(sizes, runtimes, *, threshold: float = CORRELATION_THRESHOLD,
             device=None, dtype=None) -> TaskModel:
    sizes = np.asarray(sizes, np.float64)
    runtimes = np.asarray(runtimes, np.float64)
    p = pearson(sizes, runtimes)
    med = float(np.median(runtimes))
    spread = float(1.4826 * np.median(np.abs(runtimes - med)) + 1e-12)
    if p > threshold and len(sizes) >= 2:
        post = fit(sizes, runtimes, device=device, dtype=dtype)
        return TaskModel(correlated=True, post=post, median=med,
                         spread=spread)
    resolve_device(device)
    return TaskModel(correlated=False, post=None, median=med, spread=spread)


# ---------------------------------------------------------------------------
# Batched per-task models (BLR + median fallback) — one batched solve
# ---------------------------------------------------------------------------
class SampleLog:
    """Host-side mutable raw-sample history of T tasks.

    Only the median/MAD fallback needs the raw samples (order statistics
    are not a function of fixed-size moments), and it needs exactly one
    row per update — so the history lives on the host as plain numpy,
    mutated in place with amortised-O(1) appends, and the device update
    never waits on it.
    """
    __slots__ = ("x", "y", "count")

    def __init__(self, x: np.ndarray, y: np.ndarray, count: np.ndarray):
        self.x = x            # (T, C) float64, padded
        self.y = y            # (T, C)
        self.count = count    # (T,) int64

    def append(self, i: int, xv: float, yv: float) -> None:
        cap = self.x.shape[1]
        if self.count[i] >= cap:
            pad = ((0, 0), (0, cap))            # double the capacity
            self.x = np.pad(self.x, pad)
            self.y = np.pad(self.y, pad)
        k = self.count[i]
        self.x[i, k] = xv
        self.y[i, k] = yv
        self.count[i] = k + 1

    def median_spread(self, i: int) -> tuple[float, float]:
        row = self.y[i, :self.count[i]]
        med = float(np.median(row))
        return med, float(1.4826 * np.median(np.abs(row - med)) + 1e-12)

    def copy(self) -> "SampleLog":
        return SampleLog(self.x.copy(), self.y.copy(), self.count.copy())


@dataclass(frozen=True)
class OnlineStats:
    """Streamed sufficient statistics of T tasks' (size, runtime) samples.

    ``moments[t] = [n, Σx, Σy, Σx², Σy², Σxy, max|x|, max|y|]`` — one
    (T, 8) tensor on the device.  The moments determine the NIG posterior
    exactly (see ``_posterior_from_stats``); ``log`` is the raw history the
    median fallback reads on the host.
    """
    moments: torch.Tensor    # (T, 8)
    log: SampleLog | None = None

    @property
    def n(self):
        return self.moments[..., 0]

    @property
    def x_absmax(self):
        return self.moments[..., 6]

    @property
    def y_absmax(self):
        return self.moments[..., 7]


def _stats_from_padded(X, Y, M, device, dtype) -> OnlineStats:
    """Initial sufficient statistics from the padded (T, C) fit arrays
    (summed on the host in float64, as the JAX package does)."""
    xm = np.asarray(X, np.float64) * M
    ym = np.asarray(Y, np.float64) * M
    moments = np.stack([
        M.sum(axis=-1), xm.sum(axis=-1), ym.sum(axis=-1),
        (xm * xm).sum(axis=-1), (ym * ym).sum(axis=-1),
        (xm * ym).sum(axis=-1),
        np.abs(xm).max(axis=-1), np.abs(ym).max(axis=-1)], axis=-1)
    log = SampleLog(np.asarray(X, np.float64).copy(),
                    np.asarray(Y, np.float64).copy(),
                    np.asarray(np.sum(M, axis=-1), np.int64))
    return OnlineStats(moments=_to_device(moments, device, dtype), log=log)


def _posterior_from_stats(m, prior_scale, a0, b0):
    """The NIG posteriors of (R, 8) moment rows — the same quantities
    ``_fit_core`` builds from design rows:  X^T X, X^T y and y^T y are
    linear in the moments, so the result is mathematically identical to
    refitting on the full sample history."""
    n, sx, sy, sxx, syy, sxy = m[:, :6].unbind(-1)
    x_scale = torch.clamp_min(m[:, 6], 1e-12)
    y_scale = torch.clamp_min(m[:, 7], 1e-12)
    prec0 = 1.0 / (prior_scale ** 2)
    t0 = sy / y_scale
    t1 = sxy / x_scale / y_scale
    Vn, mun = _solve(prec0 + n, sx / x_scale,
                     prec0 + sxx / (x_scale * x_scale), t0, t1)
    an = a0 + n / 2.0
    # resid @ yn = yn·yn − mun·(X^T yn), with yn·yn = Σy² / y_scale²
    bn = torch.clamp_min(
        b0 + 0.5 * (syy / (y_scale * y_scale)
                    - (mun[:, 0] * t0 + mun[:, 1] * t1)), 1e-12)
    return mun, Vn, an, bn, x_scale, y_scale


def _gate(m, threshold):
    """The Pearson gate from (R, 8) moment rows (pearson_batch's centred
    form: Σ(x-x̄)(y-ȳ) = Σxy − ΣxΣy/n)."""
    n = m[:, 0]
    num = m[:, 5] - m[:, 1] * m[:, 2] / n
    den2 = (m[:, 3] - m[:, 1] * m[:, 1] / n) * (m[:, 4] - m[:, 2] * m[:, 2] / n)
    den = torch.sqrt(torch.clamp_min(den2, 0.0))
    pear = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return (pear > threshold) & (n >= 2)


@dataclass(frozen=True)
class BatchedTaskModel:
    """T per-task predictors fitted at once; Pearson gating vectorised.

    ``post`` is a batched ``BLRPosterior`` (leading (T,) axis).  Tasks whose
    size-runtime correlation fails the gate fall back to (median, spread)
    exactly like the scalar ``TaskModel``.  ``stats`` (when present) are the
    streamed sufficient statistics that let ``update_task_batch`` absorb new
    observations without a refit; models assembled from bare posteriors
    (``stack_task_models``) carry ``stats=None`` and cannot be updated.
    """
    correlated: torch.Tensor    # (T,) bool
    post: BLRPosterior          # batched fields, (T, ...)
    median: torch.Tensor        # (T,)
    spread: torch.Tensor        # (T,)
    stats: OnlineStats | None = None

    def rows(self, idx) -> "BatchedTaskModel":
        """The predictors of rows ``idx`` (a gather on the device); the
        moments stay behind, so the subset predicts but cannot update."""
        it = _row_index(idx, self.median.device)
        return BatchedTaskModel(
            correlated=self.correlated.index_select(0, it),
            post=self.post.rows(it), median=self.median.index_select(0, it),
            spread=self.spread.index_select(0, it))


def fit_task_batch(sizes_list, runtimes_list, *,
                   threshold: float = CORRELATION_THRESHOLD, device=None,
                   dtype=None) -> BatchedTaskModel:
    """Fit all T tasks in one batched closed-form solve.

    ``sizes_list`` / ``runtimes_list``: length-T sequences of per-task 1-D
    sample arrays; ragged sample counts are padded and masked out of the
    design, so the result matches T scalar ``fit_task`` calls.  The gate,
    medians and moments are computed on the host (numpy, float64), the
    posteriors on ``device``.
    """
    T = len(sizes_list)
    if T == 0:
        raise ValueError("fit_task_batch needs at least one task")
    dev = resolve_device(device)
    dt = _default_dtype(dtype)
    nmax = max(len(np.atleast_1d(s)) for s in sizes_list)
    X = np.zeros((T, nmax))
    Y = np.zeros((T, nmax))
    M = np.zeros((T, nmax))
    for i, (s, r) in enumerate(zip(sizes_list, runtimes_list)):
        s = np.atleast_1d(np.asarray(s, np.float64))
        r = np.atleast_1d(np.asarray(r, np.float64))
        if len(s) != len(r):
            raise ValueError(
                f"task {i}: {len(s)} sizes vs {len(r)} runtimes — padding "
                "would silently count zeros as real samples")
        X[i, :len(s)] = s
        Y[i, :len(r)] = r
        M[i, :len(s)] = 1.0
    p = pearson_batch(X, Y, M)
    counts = M.sum(axis=-1)
    correlated = (p > threshold) & (counts >= 2)
    post = fit_batch(X, Y, M, device=dev, dtype=dt)
    Yv = np.where(M > 0, Y, np.nan)
    med = np.nanmedian(Yv, axis=-1)
    spread = 1.4826 * np.nanmedian(np.abs(Yv - med[:, None]), axis=-1) + 1e-12
    ms = _to_device(np.stack([med, spread]), dev, dt)
    return BatchedTaskModel(correlated=_to_device(correlated, dev, torch.bool),
                            post=post, median=ms[0], spread=ms[1],
                            stats=_stats_from_padded(X, Y, M, dev, dt))


def stack_task_models(models, *, device=None, dtype=None) -> BatchedTaskModel:
    """Stack already-fitted scalar ``TaskModel``s into the batched container
    (posterior-exact: no refit; uncorrelated slots get inert placeholders)."""
    dev = resolve_device(device)
    dt = _default_dtype(dtype)
    d = 2
    mus, Vs, As, Bs, xs, ys = [], [], [], [], [], []
    for m in models:
        if m.post is not None:
            mus.append(_np(m.post.mu))
            Vs.append(_np(m.post.V))
            As.append(float(m.post.a))
            Bs.append(float(m.post.b))
            xs.append(float(m.post.x_scale))
            ys.append(float(m.post.y_scale))
        else:
            mus.append(np.zeros(d))
            Vs.append(np.eye(d))
            As.append(1.5)
            Bs.append(1.0)
            xs.append(1.0)
            ys.append(1.0)
    post = BLRPosterior(mu=_to_device(np.stack(mus), dev, dt),
                        V=_to_device(np.stack(Vs), dev, dt),
                        a=_to_device(As, dev, dt), b=_to_device(Bs, dev, dt),
                        x_scale=_to_device(xs, dev, dt),
                        y_scale=_to_device(ys, dev, dt))
    return BatchedTaskModel(
        correlated=_to_device([m.correlated for m in models], dev,
                              torch.bool),
        post=post,
        median=_to_device([m.median for m in models], dev, dt),
        spread=_to_device([m.spread for m in models], dev, dt))


def predict_task_batch(model: BatchedTaskModel, x_star):
    """Batched ``TaskModel.predict``: (T,) mean/std at one point per task.

    ``x_star`` scalar or (T,).  BLR mean is clamped at 0 exactly like the
    scalar path; uncorrelated tasks return (median, spread).
    """
    mean_b, std_b = predict_batch(model.post, x_star)
    mean = torch.where(model.correlated, torch.clamp_min(mean_b, 0.0),
                       model.median)
    std = torch.where(model.correlated, std_b, model.spread)
    return mean, std


def predict_task_batch_grid(model: BatchedTaskModel, xs):
    """Batched predictive on a shared grid: xs (S,) -> (T, S) mean/std."""
    mean_b, std_b = predict_batch_grid(model.post, xs)
    corr = model.correlated[:, None]
    mean = torch.where(corr, torch.clamp_min(mean_b, 0.0),
                       model.median[:, None])
    std = torch.where(corr, std_b, model.spread[:, None])
    return mean, std


def _slice_rows(model: BatchedTaskModel, rows) -> list[TaskModel]:
    """Rows of a batched model as scalar ``TaskModel``s (posterior-exact:
    each posterior is a view of the batched fit).  The gates, medians and
    spreads of all ``rows`` cross to the host in one transfer."""
    rows = [int(i) for i in rows]
    if not rows:
        return []
    it = _row_index(rows, model.median.device)
    host = _np(torch.stack([model.correlated.to(model.median.dtype),
                            model.median, model.spread]).index_select(1, it))
    p = model.post
    return [TaskModel(correlated=bool(host[0, k]),
                      post=BLRPosterior(mu=p.mu[i], V=p.V[i], a=p.a[i],
                                        b=p.b[i], x_scale=p.x_scale[i],
                                        y_scale=p.y_scale[i]),
                      median=float(host[1, k]), spread=float(host[2, k]))
            for k, i in enumerate(rows)]


def slice_task_model(model: BatchedTaskModel, i: int) -> TaskModel:
    """One row of a batched model as a scalar ``TaskModel``
    (posterior-exact: the row is a view of the batched fit, no refit)."""
    return _slice_rows(model, [i])[0]


def unstack_task_models(model: BatchedTaskModel) -> list[TaskModel]:
    """Slice a batched model back into T scalar ``TaskModel``s."""
    return _slice_rows(model, range(model.correlated.shape[0]))


# ---------------------------------------------------------------------------
# Incremental (online) updates — rank-1 conjugate absorption of samples
# ---------------------------------------------------------------------------
def _update_core_impl(model: BatchedTaskModel, task_idx: np.ndarray, obs,
                      prior_scale, a0, b0, threshold) -> BatchedTaskModel:
    """Absorb a stream of S observations into the R rows it touches.
    ``task_idx`` (S,) are host ints; ``obs`` is one float64 vector on the
    device, packed by ``_pack_stream``: the sizes and runtimes (S each),
    then the touched rows (sorted unique ``task_idx``) and their refreshed
    medians and MADs (R each), computed on the host from the
    ``SampleLog`` (order statistics are not moments).

    The moments are folded in stream order, one observation at a time, so
    each row's sums are added in the order the JAX scan adds them: two
    in-place launches an observation, with the row a host int and nothing
    read back.  Then the posteriors and gates of the touched rows are
    recomputed in one batched solve from their final moments — the state
    the scan leaves after recomputing them at every step.  The input's
    arrays are not written: the moments are cloned once, the other fields
    are written by out-of-place ``index_copy``.
    """
    S = len(task_idx)
    R = (obs.shape[0] - 2 * S) // 3
    dt = model.median.dtype
    x, y = obs[:S].to(dt), obs[S:2 * S].to(dt)
    it = obs[2 * S:2 * S + R].long()
    med, spr = obs[2 * S + R:2 * S + 2 * R].to(dt), obs[2 * S + 2 * R:].to(dt)
    inc = torch.stack([torch.ones_like(x), x, y, x * x, y * y, x * y], -1)
    ext = torch.stack([x.abs(), y.abs()], -1)
    moments = model.stats.moments.clone()
    sums, maxes = moments[:, :6].unbind(0), moments[:, 6:].unbind(0)
    for i, v, e in zip(task_idx.tolist(), inc.unbind(0), ext.unbind(0)):
        sums[i].add_(v)
        torch.maximum(maxes[i], e, out=maxes[i])
    m = moments.index_select(0, it)
    fields = _posterior_from_stats(m, prior_scale, a0, b0)
    p = model.post
    post = BLRPosterior(*(getattr(p, f).index_copy(0, it, v)
                          for f, v in zip(POSTERIOR_FIELDS, fields)))
    return BatchedTaskModel(
        correlated=model.correlated.index_copy(0, it, _gate(m, threshold)),
        post=post, median=model.median.index_copy(0, it, med),
        spread=model.spread.index_copy(0, it, spr),
        stats=OnlineStats(moments=moments, log=model.stats.log))


def _pack_stream(log: SampleLog, task_idx, x, y) -> np.ndarray:
    """Append the stream to the host-side log and pack what the device
    update needs into one float64 vector (one host->device transfer):
    sizes, runtimes, the touched rows, their medians and MADs."""
    for i, xv, yv in zip(task_idx.tolist(), x.tolist(), y.tolist()):
        log.append(i, xv, yv)
    rows = np.unique(task_idx)
    med_spr = np.array([log.median_spread(int(i)) for i in rows],
                       np.float64).reshape(-1, 2)
    return np.concatenate([x, y, rows, med_spr[:, 0], med_spr[:, 1]])


def _require_stats(model: BatchedTaskModel) -> None:
    if model.stats is None or model.stats.log is None:
        raise ValueError(
            "model carries no sufficient statistics (built via "
            "stack_task_models?) — refit with fit_task_batch to enable "
            "incremental updates")


def update_task_batch(model: BatchedTaskModel, task_idx: int, x, y, *,
                      prior_scale: float = 10.0, a0: float = 1.0,
                      b0: float = 1.0,
                      threshold: float = CORRELATION_THRESHOLD
                      ) -> BatchedTaskModel:
    """Absorb one (size, runtime) observation into task ``task_idx``.

    Mathematically identical to ``fit_task_batch`` on the concatenated
    sample history (same hyperparameters), but O(d²) on the affected row
    instead of a full refit, with no host↔device sync.  Returns a new
    model.  The posterior arrays of the input are unchanged; the
    raw-sample ``SampleLog`` is shared and mutated in place (treat the
    input model as consumed, like an optimiser state).
    """
    return update_task_batch_stream(model, [int(task_idx)], [x], [y],
                                    prior_scale=prior_scale, a0=a0, b0=b0,
                                    threshold=threshold)


# ---------------------------------------------------------------------------
# Per-(task, node) multiplicative bias — conjugate posterior on log-residuals
# ---------------------------------------------------------------------------
class BiasModel:
    """Systematic per-(task, node) residual learned online.

    The factor adjustment transfers the *average* hardware ratio, but real
    tasks hit different codepaths per machine, leaving a stable per-pair
    residual the factor cannot capture (the paper's Tables 4-6 error
    floor).  Model the multiplicative bias ``b[t, n]`` of task ``t`` on
    node ``n`` through its log:

        log r_k ~ N(beta, sigma_r^2),   beta ~ N(0, tau0^2)

    where ``r_k = measured / (factor x local prediction)`` is the k-th
    observed residual of the pair.  Conjugacy gives the closed-form
    posterior ``beta | r_1..r_n ~ N(mu, v)`` with

        lam = 1/tau0^2 + n/sigma_r^2,  mu = (sum log r)/(sigma_r^2 lam),
        v = 1/lam

    so the point estimate ``exp(mu)`` shrinks toward 1.0 under few
    observations and ``v`` quantifies how unsure the bias still is —
    consumers widen their predictive std/interval by it.  Pairs with zero
    observations are INERT (bias 1, no widening): the layer only activates
    where evidence exists, so a freshly fitted estimator predicts exactly
    like the pure factor-scaled path.

    State is three (T, N) float64 host arrays (counts, sum log r,
    sum (log r)^2) — sufficient statistics, so updates are O(batch) numpy
    scatters and the whole object serialises to JSON losslessly.  Row
    order follows the estimator's ``task_names()``; column order is the
    estimator's fixed node universe.

    Two online refinements, both inert at their defaults:

    * ``decay`` — exponential forgetting on the sufficient statistics:
      every ``update`` batch first multiplies (counts, log_sum, log_sq)
      by ``decay``, so older residuals carry weight ``decay^age`` and the
      posterior tracks slow hardware drift (thermal throttling, creeping
      contention) instead of averaging it away.  ``decay=1.0`` (default)
      is bit-exact with the decay-free model: the multiply is skipped
      entirely, not merely a multiply-by-one.
    * ``empirical_bayes`` — pool the residual noise scale from the data:
      ``effective_sigma_r()`` replaces the fixed ``sigma_r`` with the
      pooled within-pair spread of the observed log-residuals
      (``residual_spread``), so shrinkage weights match the cluster's
      actual noise level rather than a guessed 0.25.  Until any pair has
      two observations the configured ``sigma_r`` is used unchanged.
    """

    __slots__ = ("counts", "log_sum", "log_sq", "tau0", "sigma_r",
                 "decay", "empirical_bayes", "_sigma_r_cache")

    #: floor for the empirical-Bayes pooled noise scale — a cluster whose
    #: observed residuals are (near-)deterministic would otherwise drive
    #: sigma_r -> 0 and make a single residual look infinitely informative
    SIGMA_R_FLOOR = 0.02

    def __init__(self, n_tasks: int, n_nodes: int, *, tau0: float = 0.5,
                 sigma_r: float = 0.25, decay: float = 1.0,
                 empirical_bayes: bool = False, counts=None, log_sum=None,
                 log_sq=None):
        shape = (n_tasks, n_nodes)
        self.counts = (np.zeros(shape) if counts is None
                       else np.asarray(counts, np.float64).reshape(shape))
        self.log_sum = (np.zeros(shape) if log_sum is None
                        else np.asarray(log_sum, np.float64).reshape(shape))
        self.log_sq = (np.zeros(shape) if log_sq is None
                       else np.asarray(log_sq, np.float64).reshape(shape))
        self.tau0 = float(tau0)
        self.sigma_r = float(sigma_r)
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.decay = float(decay)
        self.empirical_bayes = bool(empirical_bayes)
        self._sigma_r_cache: float | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return self.counts.shape

    def effective_sigma_r(self) -> float:
        """The residual noise scale the posterior actually uses: the fixed
        ``sigma_r``, or — with ``empirical_bayes`` — the pooled empirical
        spread of the observed log-residuals (floored at
        ``SIGMA_R_FLOOR``), falling back to the fixed value while no pair
        has two observations yet.

        Memoised between updates: scalar consumers (``point`` /
        ``tail_mass`` / ``interval_scale``) may be called per running
        task per executor tick, and the pooled spread is an O(T·N)
        reduction — ``update`` invalidates the cache."""
        if not self.empirical_bayes:
            return self.sigma_r
        if self._sigma_r_cache is None:
            s = self.residual_spread()
            self._sigma_r_cache = (self.sigma_r if not np.isfinite(s)
                                   else max(s, self.SIGMA_R_FLOOR))
        return self._sigma_r_cache

    def update(self, rows, cols, log_resid) -> None:
        """Absorb a batch of log-residuals at (rows[k], cols[k]) — repeated
        pairs accumulate (``np.add.at`` scatter).

        With ``decay < 1`` the whole sufficient-statistic state is decayed
        once per call, *before* the batch is absorbed — one ``update`` is
        one forgetting step, so callers batching a simulation tick decay
        per tick, not per observation."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        lr = np.asarray(log_resid, np.float64)
        if self.decay != 1.0:
            self.counts *= self.decay
            self.log_sum *= self.decay
            self.log_sq *= self.decay
        np.add.at(self.counts, (rows, cols), 1.0)
        np.add.at(self.log_sum, (rows, cols), lr)
        np.add.at(self.log_sq, (rows, cols), lr * lr)
        self._sigma_r_cache = None

    def posterior(self) -> tuple[np.ndarray, np.ndarray]:
        """(mu, v): posterior mean and variance of the log-bias, (T, N)."""
        sr = self.effective_sigma_r()
        lam = 1.0 / self.tau0 ** 2 + self.counts / sr ** 2
        mu = self.log_sum / (sr ** 2 * lam)
        return mu, 1.0 / lam

    def matrix(self, cols=None) -> np.ndarray:
        """(T, N') multiplicative bias point estimates, inert (1.0) where
        unobserved; ``cols`` selects/reorders node columns."""
        mu, _ = self.posterior()
        b = np.where(self.counts > 0, np.exp(mu), 1.0)
        return b if cols is None else b[:, cols]

    def widen_std(self, mean, std, cols=None) -> np.ndarray:
        """Fold the bias into a predictive std: the bias-scaled std plus
        the residual uncertainty of the bias itself (delta method on
        ``exp(beta)``), inert where unobserved.

        ``mean`` / ``std`` are the bias-free (T, N') prediction arrays.
        """
        mu, v = self.posterior()
        if cols is not None:
            mu, v = mu[:, cols], v[:, cols]
            n = self.counts[:, cols]
        else:
            n = self.counts
        widened = np.exp(mu) * np.sqrt(
            np.asarray(std, np.float64) ** 2
            + np.asarray(mean, np.float64) ** 2 * np.expm1(v))
        return np.where(n > 0, widened, std)

    def _pair(self, i: int, j: int) -> tuple[float, float, float]:
        """(n, mu, v) of one (task, node) pair without building matrices."""
        n = float(self.counts[i, j])
        sr = self.effective_sigma_r()
        lam = 1.0 / self.tau0 ** 2 + n / sr ** 2
        mu = float(self.log_sum[i, j]) / (sr ** 2 * lam)
        return n, mu, 1.0 / lam

    def point(self, i: int, j: int) -> float:
        """Scalar bias point estimate for one pair (1.0 when unobserved)."""
        n, mu, _ = self._pair(i, j)
        return float(np.exp(mu)) if n > 0 else 1.0

    def fold_scalar(self, i: int, j: int, mean: float, std: float
                    ) -> tuple[float, float]:
        """Scalar twin of ``matrix``/``widen_std`` (the matrix consumers'
        equivalence oracle — keep the two in lock-step)."""
        n, mu, v = self._pair(i, j)
        if n <= 0:
            return float(mean), float(std)
        b = float(np.exp(mu))
        return (float(mean) * b,
                b * float(np.sqrt(std ** 2 + mean ** 2 * np.expm1(v))))

    def interval_scale(self, i: int, j: int, z: float
                       ) -> tuple[float, float]:
        """Multiplicative (lo, hi) scales for an equal-tailed predictive
        interval: the bias point estimate spread by ``z`` posterior sds of
        the log-bias — (1, 1) when the pair is unobserved."""
        n, mu, v = self._pair(i, j)
        if n <= 0:
            return 1.0, 1.0
        sd = float(np.sqrt(v))
        return float(np.exp(mu - z * sd)), float(np.exp(mu + z * sd))

    def tail_mass(self, i: int, j: int, threshold: float) -> float:
        """Posterior probability that the pair's multiplicative bias
        exceeds ``threshold``: ``P(exp(beta) > threshold)`` under the
        Normal posterior on the log-bias.

        This is the admission statistic for risk-aware speculation: the
        point estimate ``exp(mu)`` crosses a threshold the moment ``mu``
        does (tail mass 0.5), while requiring more tail mass demands the
        whole posterior — not just its centre — to sit above the drift
        line, so a single noisy residual cannot trigger a copy.  Returns
        0.0 for unobserved pairs (no evidence of drift); an observed
        pair's bias ``exp(beta)`` is almost-surely positive, so any
        ``threshold <= 0`` yields the full mass 1.0 (matching the
        point-estimate comparison at the same threshold)."""
        n, mu, v = self._pair(i, j)
        if n <= 0:
            return 0.0
        if threshold <= 0.0:
            return 1.0
        z = (np.log(threshold) - mu) / np.sqrt(v)
        return float(_scipy_stats.norm.sf(z))

    def residual_spread(self) -> float:
        """Pooled empirical sd of the log-residuals around their per-pair
        means — the data-driven counterpart of ``sigma_r``, and the
        quantity ``effective_sigma_r`` substitutes for it under
        ``empirical_bayes``.  A spread far from the configured ``sigma_r``
        means the shrinkage weights are mis-calibrated for this cluster.
        NaN until some pair has at least two observations."""
        n = self.counts
        mask = n >= 2
        if not mask.any():
            return float("nan")
        ss = self.log_sq[mask] - self.log_sum[mask] ** 2 / n[mask]
        dof = (n[mask] - 1).sum()
        return float(np.sqrt(max(ss.sum(), 0.0) / max(dof, 1.0)))

    def expand_rows(self, n_tasks: int) -> None:
        """Grow the task axis (new tasks appended) preserving history."""
        t0, n0 = self.counts.shape
        if n_tasks < t0:
            raise ValueError(f"cannot shrink bias rows {t0} -> {n_tasks}")
        if n_tasks == t0:
            return
        pad = ((0, n_tasks - t0), (0, 0))
        self.counts = np.pad(self.counts, pad)
        self.log_sum = np.pad(self.log_sum, pad)
        self.log_sq = np.pad(self.log_sq, pad)

    def to_dict(self) -> dict:
        return {"tau0": self.tau0, "sigma_r": self.sigma_r,
                "decay": self.decay,
                "empirical_bayes": self.empirical_bayes,
                "counts": self.counts.tolist(),
                "log_sum": self.log_sum.tolist(),
                "log_sq": self.log_sq.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "BiasModel":
        counts = np.asarray(d["counts"], np.float64)
        # decay / empirical_bayes landed in schema v4; v3 files predate
        # them and get the (bit-exact) inert defaults
        return cls(counts.shape[0], counts.shape[1], tau0=d["tau0"],
                   sigma_r=d["sigma_r"], decay=d.get("decay", 1.0),
                   empirical_bayes=d.get("empirical_bayes", False),
                   counts=counts, log_sum=d["log_sum"], log_sq=d["log_sq"])


# ---------------------------------------------------------------------------
# Per-node attempt reliability — Beta–Binomial posterior on success rate
# ---------------------------------------------------------------------------
class ReliabilityModel:
    """Per-node attempt-success posterior learned online.

    The runtime posterior prices how LONG a task runs on a node; this
    prices whether an attempt there FINISHES at all.  Model each node's
    attempt-success probability with the conjugate Beta–Binomial:

        p_j ~ Beta(a0, b0),   attempt outcomes ~ Bernoulli(p_j)

    so after s successes and f failures the posterior is
    ``Beta(a0 + s, b0 + f)`` in closed form — the same Bayesian story the
    estimator tells for runtimes, extended to availability.  A task whose
    attempts fail must be retried, so with independent attempts the
    expected number of tries until success is ``1/p`` and the expected
    time-to-success on node j is ``mean_j / p_j``.  Schedulers therefore
    consume the multiplicative **reliability factor**

        factor(j, k) = 1 / max(E[p_j] - k * sd[p_j], P_FLOOR)

    where ``k`` widens by the posterior sd exactly like the runtime
    plane's ``risk_k`` — a node with few observed attempts keeps a wide
    posterior and is priced cautiously until evidence narrows it, and a
    flaky node's factor grows as failures accrue, pricing it out of HEFT
    placements.

    The prior (``a0=8, b0=1`` → E[p] ≈ 0.89) is deliberately optimistic
    and UNIFORM across nodes: before any evidence every node carries the
    same factor, so relative placement is (near-)unchanged and the layer
    only differentiates nodes as attempt outcomes stream in.  State is a
    plain ``{node: [successes, failures]}`` dict — JSON-serialisable for
    the estimator checkpoint (schema v5).
    """

    __slots__ = ("a0", "b0", "state")

    #: floor on the widened success probability — a node that failed every
    #: observed attempt must stay priceable (finite factor), not divide by
    #: zero; 0.05 caps the factor at 20x
    P_FLOOR = 0.05

    def __init__(self, a0: float = 8.0, b0: float = 1.0, state=None):
        if a0 <= 0 or b0 <= 0:
            raise ValueError(f"Beta prior needs a0, b0 > 0, got {a0}, {b0}")
        self.a0 = float(a0)
        self.b0 = float(b0)
        self.state: dict[str, list[float]] = {
            str(k): [float(v[0]), float(v[1])]
            for k, v in (state or {}).items()}

    def record(self, node: str, success: bool, weight: float = 1.0) -> None:
        """Absorb one attempt outcome on ``node`` (a kill the *scheduler*
        ordered — e.g. a lost speculative race — is not a node failure
        and must not be recorded)."""
        s, f = self.state.setdefault(str(node), [0.0, 0.0])
        if success:
            self.state[str(node)][0] = s + weight
        else:
            self.state[str(node)][1] = f + weight

    def counts(self, node: str) -> tuple[float, float]:
        s, f = self.state.get(str(node), (0.0, 0.0))
        return float(s), float(f)

    def _ab(self, node: str) -> tuple[float, float]:
        s, f = self.counts(node)
        return self.a0 + s, self.b0 + f

    def p_mean(self, node: str) -> float:
        """Posterior mean success probability E[p] = a/(a+b)."""
        a, b = self._ab(node)
        return a / (a + b)

    def p_sd(self, node: str) -> float:
        """Posterior sd of p: sqrt(ab / ((a+b)^2 (a+b+1)))."""
        a, b = self._ab(node)
        return float(np.sqrt(a * b / ((a + b) ** 2 * (a + b + 1.0))))

    def factor(self, node: str, k: float = 1.0) -> float:
        """Expected time-to-success multiplier ``1 / p_eff`` with the
        uncertainty-widened ``p_eff = max(E[p] - k*sd[p], P_FLOOR)``.
        Always finite (>= 1, capped at 1/P_FLOOR); what matters is the
        ORDERING: flakier and less-certain nodes price higher."""
        p_eff = max(self.p_mean(node) - k * self.p_sd(node), self.P_FLOOR)
        return 1.0 / p_eff

    def factors(self, nodes, k: float = 1.0) -> np.ndarray:
        """(N,) reliability factors in ``nodes`` order."""
        return np.array([self.factor(n, k) for n in nodes], np.float64)

    def to_dict(self) -> dict:
        return {"a0": self.a0, "b0": self.b0,
                "state": {k: list(v) for k, v in self.state.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "ReliabilityModel":
        return cls(a0=d["a0"], b0=d["b0"], state=d["state"])


def update_task_batch_stream(model: BatchedTaskModel, task_idx, x, y, *,
                             prior_scale: float = 10.0, a0: float = 1.0,
                             b0: float = 1.0,
                             threshold: float = CORRELATION_THRESHOLD
                             ) -> BatchedTaskModel:
    """Absorb a whole observation stream, in stream order.

    ``task_idx`` (S,) int, ``x`` / ``y`` (S,).  The samples are appended to
    the host-side log and the touched rows' medians refreshed there; the
    stream crosses to the device in one transfer and ``_update_core_impl``
    folds it in.  Nothing in the update waits on the device.

    Like ``update_task_batch``, the input model is CONSUMED: its
    ``SampleLog`` is shared with the returned model and mutated in
    place.  Keep only the returned model.
    """
    _require_stats(model)
    task_idx = np.asarray(task_idx, np.int64).reshape(-1)
    x = np.asarray(x, np.float64).reshape(-1)
    y = np.asarray(y, np.float64).reshape(-1)
    if len(task_idx) == 0:
        return model
    obs = _to_device(_pack_stream(model.stats.log, task_idx, x, y),
                     model.median.device, torch.float64)
    return _update_core_impl(model, task_idx, obs, prior_scale, a0, b0,
                             threshold)
