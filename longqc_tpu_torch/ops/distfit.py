"""Distribution fitting: GMM EM, Normal+LogNormal EM, gamma fit.

The reference fits per-read coverage with sklearn's 2-component
GaussianMixture (lq_coverage.py:588) and, for low-coverage/transcript
data, a Normal(noise)+LogNormal(signal) mixture via the vendored mixEM
(lq_coverage.py:561-564, mixEM/mixem/em.py:16-88). sklearn's kmeans
init is unseeded in the reference (nondeterministic run to run); we use
a deterministic quantile init, making our results reproducible while
statistically equivalent.

The EM loops (port of longqc_tpu/ops/distfit) are plain torch loops in
float64 on the given device, each iteration's convergence test read on
the host. Summation order differs from XLA's, so parameters agree with
the JAX fits to the last bits, not bit for bit.
"""

import numpy as np
import torch
from scipy.stats import gamma as scipy_gamma

from longqc_tpu_torch.ops._ext import require_device

_LOG2PI = float(np.log(2.0 * np.pi))


def _gmm_em(x, weights0, means0, vars0, n_comp=2, max_iter=100,
            tol=1e-3, reg=1e-6):
    """1-D GMM EM (sklearn-equivalent updates, mean-log-likelihood tol)
    on float64 tensors of one device; the convergence test is read on
    the host each iteration. -> (weights, means, vars, ll, iterations)."""
    n = x.shape[0]
    eps = 10 * torch.finfo(x.dtype).eps

    def log_prob(means, variances):
        return (-0.5 * ((x[:, None] - means[None, :]) ** 2
                        / variances[None, :])
                - 0.5 * torch.log(variances[None, :]) - 0.5 * _LOG2PI)

    it, dll = 0, np.inf
    ll_prev = torch.tensor(-np.inf, dtype=x.dtype, device=x.device)
    wgt, mu, var = weights0, means0, vars0
    while it < max_iter and abs(dll) > tol:
        lp = log_prob(mu, var) + torch.log(wgt)[None, :]
        norm = torch.logsumexp(lp, dim=1)
        resp = torch.exp(lp - norm[:, None])
        nk = resp.sum(dim=0) + eps
        mu_n = (resp * x[:, None]).sum(dim=0) / nk
        var_n = ((resp * (x[:, None] - mu_n[None, :]) ** 2).sum(dim=0)
                 / nk + reg)
        wgt = nk / n
        ll = norm.mean()
        dll = float(ll - ll_prev)
        ll_prev, mu, var = ll, mu_n, var_n
        it += 1
    return wgt, mu, var, ll_prev, it


def fit_gmm(x, n_comp=2, device="cuda"):
    """Deterministic 2-component GMM fit -> (weights, means, covariances).

    Init: quantile-split means (balanced), pooled variance.
    """
    x = np.asarray(x, np.float64)
    qs = np.linspace(0, 100, 2 * n_comp + 1)[1::2]
    means0 = np.percentile(x, qs)
    var0 = np.full(n_comp, max(np.var(x), 1e-6) / n_comp)
    w0 = np.full(n_comp, 1.0 / n_comp)
    dev = require_device(device)
    t = [torch.from_numpy(np.asarray(a, np.float64)).to(dev)
         for a in (x, w0, means0, var0)]
    wgt, mu, var, _, _ = _gmm_em(*t, n_comp=n_comp)
    return wgt.cpu().numpy(), mu.cpu().numpy(), var.cpu().numpy()


def gmm_score_samples(x, weights, means, variances):
    """log pdf of the mixture at x (for plots)."""
    x = np.asarray(x, np.float64)[:, None]
    lp = (-0.5 * (x - means[None, :]) ** 2 / variances[None, :]
          - 0.5 * np.log(2 * np.pi * variances[None, :])
          + np.log(weights[None, :]))
    m = lp.max(axis=1, keepdims=True)
    return (m + np.log(np.exp(lp - m).sum(axis=1, keepdims=True)))[:, 0]


def _norm_lognorm_em(x, mu_n0, sd_n0, mu_l0, sd_l0, max_iter=500,
                     tol=1e-15, tol_iters=10):
    """Normal + LogNormal mixture EM with mixEM's convergence rule
    (relative log-likelihood change vs `tol_iters` iterations back,
    em.py:60-88). Weighted-ML M-steps per mixem.distribution. float64
    tensors of one device; the convergence test is read on the host each
    iteration. -> (w, mu_n, sd_n, mu_l, sd_l, ll, iterations)."""
    logx = torch.log(x)

    def log_dens(mu_n, sd_n, mu_l, sd_l):
        ln = (-(x - mu_n) ** 2 / (2 * sd_n ** 2) - torch.log(sd_n)
              - 0.5 * _LOG2PI)
        ll = (-(logx - mu_l) ** 2 / (2 * sd_l ** 2) - torch.log(sd_l)
              - 0.5 * _LOG2PI - logx)
        return torch.stack([ln, ll], dim=1)

    # the last tol_iters log-likelihoods, newest first (host f64, with
    # numpy's division by zero)
    hist = np.full(tol_iters, -np.inf)
    it = 0
    w = torch.tensor([0.5, 0.5], dtype=x.dtype, device=x.device)
    mu_n, sd_n, mu_l, sd_l = mu_n0, sd_n0, mu_l0, sd_l0
    while True:
        ll, old = hist[0], hist[tol_iters - 1]
        with np.errstate(invalid="ignore", divide="ignore"):
            converged = it >= tol_iters and (old - ll) / old <= tol
        if it > max_iter or converged or np.isnan(ll):
            break
        ld = log_dens(mu_n, sd_n, mu_l, sd_l)
        resp = w[None, :] * torch.exp(ld)
        resp = resp / resp.sum(dim=1, keepdim=True)
        ll_t = torch.sum(resp * ld)
        # M-step
        wsum = resp.sum(dim=0)
        mu_n = (resp[:, 0] * x).sum() / wsum[0]
        sd_n = torch.sqrt((resp[:, 0] * (x - mu_n) ** 2).sum() / wsum[0])
        mu_l = (resp[:, 1] * logx).sum() / wsum[1]
        sd_l = torch.sqrt((resp[:, 1] * (logx - mu_l) ** 2).sum() / wsum[1])
        w = resp.mean(dim=0)
        hist = np.concatenate([[ll_t.item()], hist[:-1]])
        it += 1
    return w, mu_n, sd_n, mu_l, sd_l, hist[0], it


def fit_norm_lognorm(x, mu_norm, sd_norm, mu_logn, sd_logn=1.0,
                     device="cuda"):
    """mixEM-equivalent fit -> (weights, [mu_n, mu_l], [sd_n, sd_l])."""
    dev = require_device(device)
    x = torch.from_numpy(np.asarray(x, np.float64)).to(dev)
    w, mu_n, sd_n, mu_l, sd_l, _, _ = _norm_lognorm_em(
        x, *(torch.tensor(float(v), dtype=torch.float64, device=dev)
             for v in (mu_norm, sd_norm, mu_logn, sd_logn)))
    return (w.cpu().numpy(), [float(mu_n), float(mu_l)],
            [float(sd_n), float(sd_l)])


def estimate_gamma_dist(vals):
    """scipy gamma.fit with floc=0, as the reference
    (lq_gamma.py:47-53)."""
    alpha, _loc, beta = scipy_gamma.fit(np.asarray(vals, np.float64),
                                        floc=0.0)
    return alpha, beta


def estimate_gamma_dist_minka(vals, tol=1e-6):
    """Minka (2002) fixed-point gamma estimation (cf. the reference's
    hand-rolled estimator, lq_gamma.py:21-44; unused by its main path
    but part of the module surface)."""
    from scipy import special
    from scipy.stats import dgamma

    v = np.asarray(vals, np.float64)
    mean_v = np.mean(v)
    mean_log = np.mean(np.log(v))
    a = 0.5 / (np.log(mean_v) - mean_log)
    b = mean_v / a

    def ll(a_, b_):
        return np.sum(np.log(dgamma.pdf(v, a_, loc=0, scale=1 / b_)))

    eps = np.inf
    ll_p = ll(a, b)
    while eps > tol:
        inv = 1 / a + ((mean_log - special.polygamma(0, a)
                        - np.log(mean_v) + np.log(a))
                       / (a ** 2 * (1 / a - special.polygamma(1, a))))
        a = 1 / inv
        b = mean_v / a
        ll_n = ll(a, b)
        eps = abs(ll_n - ll_p)
        ll_p = ll_n
    return a, b
