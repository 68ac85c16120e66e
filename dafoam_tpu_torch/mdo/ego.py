"""Surrogate-based global optimization (EGO / Bayesian optimization).

Port of ``dafoam_tpu.mdo.ego``. Re-designs the reference's
surrogateOptimization layer (dafoam/pyDAFoam.py:2406-2817: SMT KRG
surrogates + EGO with penalty-based constraints) without the SMT
dependency: an anisotropic squared-exponential Gaussian process in torch
float64 (hyperparameters tuned by scipy's L-BFGS-B on the log marginal
likelihood, whose value and gradient come from autograd) and an Expected
Improvement acquisition maximized by multi-start L-BFGS-B. Constraints
enter as penalties, like the reference (pyDAFoam.py:2698-2771). Random
draws use ``numpy.random.default_rng(seed)`` as ``dafoam_tpu`` does, so
the same seed gives the same samples.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dafoam_tpu_torch.ops.core import maximum

F64 = torch.float64


def _kernel(X1, X2, log_ls, log_amp):
    ls = torch.exp(log_ls)
    d = (X1[:, None, :] - X2[None, :, :]) / ls
    r2 = torch.sum(d * d, dim=-1)
    return torch.exp(log_amp) * torch.exp(-0.5 * r2)


def _cholesky(K):
    """Lower Cholesky factor of K, all NaN where K is not positive definite
    (``jnp.linalg.cholesky``'s result there, which an L-BFGS-B line search
    backs away from; ``torch.linalg.cholesky`` would raise)."""
    L, info = torch.linalg.cholesky_ex(K)
    return L + torch.where(info > 0, math.nan, 0.0).to(L.dtype)


class GP:
    """Anisotropic squared-exponential GP (KRG-equivalent)."""

    def __init__(self, noise=1e-10, *, device="cuda"):
        self.noise = noise
        self.device = torch.device(device)
        self.params = None
        self.X = None
        self.y = None

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=F64, device=self.device)

    def _gram(self, theta):
        n, d = self.X.shape
        return _kernel(self.X, self.X, theta[:d], theta[d]) \
            + (self.noise + torch.exp(theta[d + 1])) \
            * torch.eye(n, dtype=F64, device=self.device)

    def nll(self, theta):
        """Negative log marginal likelihood (up to a constant) of the
        normalized data at hyperparameters theta = [log_ls, log_amp,
        log_noise]."""
        L = _cholesky(self._gram(theta))
        a = torch.cholesky_solve(self.yn[:, None], L)[:, 0]
        return 0.5 * self.yn @ a + torch.sum(torch.log(torch.diagonal(L)))

    def nll_and_grad(self, theta):
        """(value, gradient) of ``nll`` as float64 numpy, for scipy."""
        t = self._t(theta).requires_grad_(True)
        with torch.enable_grad():
            v = self.nll(t)
        (g,) = torch.autograd.grad(v, t)
        return float(v.detach()), g.cpu().numpy()

    def set_data(self, X, y):
        """The training points and their normalized values."""
        self.X = self._t(X)
        y = self._t(y)
        self.ymean, self.ystd = float(y.mean()), \
            float(y.std(correction=0) + 1e-12)
        self.yn = (y - self.ymean) / self.ystd
        return self

    def condition(self, theta):
        """Fix the hyperparameters and factor the Gram matrix."""
        theta = self._t(theta)
        self.params = theta
        self.L = _cholesky(self._gram(theta))
        self.alpha = torch.cholesky_solve(self.yn[:, None], self.L)[:, 0]
        return self

    def fit(self, X, y, restarts=3, seed=0):
        from scipy.optimize import minimize

        self.set_data(X, y)
        d = self.X.shape[1]

        rng = np.random.default_rng(seed)
        best = None
        for _ in range(restarts):
            t0 = np.concatenate([rng.normal(-0.5, 0.5, d), [0.0], [-12.0]])
            res = minimize(self.nll_and_grad, t0, jac=True,
                           method="L-BFGS-B")
            if best is None or res.fun < best.fun:
                best = res
        return self.condition(best.x)

    def predict(self, Xq):
        d = self.X.shape[1]
        theta = self.params
        Kq = _kernel(torch.as_tensor(Xq, dtype=F64, device=self.device),
                     self.X, theta[:d], theta[d])
        mu = Kq @ self.alpha
        v = torch.linalg.solve_triangular(self.L, Kq.T, upper=False)
        var = torch.exp(theta[d]) - torch.sum(v * v, dim=0)
        var = maximum(var, 1e-14)
        return mu * self.ystd + self.ymean, torch.sqrt(var) * self.ystd


def expected_improvement(mu, sigma, f_best):
    z = (f_best - mu) / sigma
    cdf = 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return (f_best - mu) * cdf + sigma * pdf


def _neg_ei_and_grad(gp, f_best, x):
    """(-EI(x), -dEI/dx) at one point x, as float and float64 numpy."""
    xt = torch.as_tensor(np.asarray(x), dtype=F64,
                         device=gp.device).requires_grad_(True)
    with torch.enable_grad():
        v = -expected_improvement(*gp.predict(xt[None]), f_best)[0]
    (g,) = torch.autograd.grad(v, xt)
    return float(v.detach()), g.cpu().numpy()


def ego_minimize(func, bounds, n_init=8, n_iter=20, seed=0,
                 constraints=None, penalty=1e3, *, device="cuda"):
    """EGO loop: func(x) -> scalar (expensive); bounds: (d,2) array.

    constraints: optional list of callables g(x) <= 0 evaluated WITH func
    (penalized, reference pyDAFoam.py:2698-2771 style). The GP and the
    acquisition run on ``device``."""
    from scipy.optimize import minimize

    bounds = np.asarray(bounds, dtype=float)
    d = bounds.shape[0]
    rng = np.random.default_rng(seed)
    X = rng.uniform(bounds[:, 0], bounds[:, 1], size=(n_init, d))

    def penalized(x):
        f = func(x)
        if constraints:
            for g in constraints:
                f = f + penalty * max(0.0, g(x)) ** 2
        return f

    y = np.array([penalized(x) for x in X])

    for it in range(n_iter):
        gp = GP(device=device).fit(X, y, seed=seed + it)
        f_best = float(y.min())

        best_x, best_v = None, np.inf
        starts = rng.uniform(bounds[:, 0], bounds[:, 1], size=(8, d))
        for s in starts:
            res = minimize(lambda x: _neg_ei_and_grad(gp, f_best, x), s,
                           jac=True, bounds=bounds, method="L-BFGS-B")
            if res.fun < best_v:
                best_v, best_x = res.fun, res.x
        X = np.vstack([X, best_x])
        y = np.append(y, penalized(best_x))

    i = int(np.argmin(y))
    return {"x": X[i], "fun": float(y[i]), "X": X, "y": y}
