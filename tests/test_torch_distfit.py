"""The port's distribution fits against the JAX package's on the CPU.

The EM loops are plain torch loops in float64 in the port and jit +
while_loop in XLA in the JAX package: the same updates, summed in
another order, so f64 rounding differs in the last bits. Tolerances:
- the GMM EM (tol 1e-3 on the mean log-likelihood, far above rounding)
  stops after the same number of iterations, its parameters within
  rel=1e-9;
- the Normal+LogNormal EM stops on mixEM's rule, a relative change of
  at most 1e-15 over 10 iterations: that is a few ulps of the
  log-likelihood, so rounding decides the last iteration and the counts
  may differ by one (326 / 327 on the "mixed" input). Its parameters
  have reached the fixed point by then, bit-stationary from one
  iteration to the next, so they agree within rel=1e-9 all the same.
The gamma fits and gmm_score_samples are the same numpy / scipy code in
both: equal."""

import numpy as np
import pytest
import torch
import torch_util  # noqa: F401

from longqc_tpu.ops import distfit as jd
from longqc_tpu_torch.ops import distfit as td

REL = 1e-9


def _coverage_like(seed, n_main=400, n_bg=60, mean=9.0, sd=2.5):
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.normal(mean, sd, n_main),
                        rng.exponential(1.5, n_bg) + 0.2])
    return x[x > 0]


GMM_CASES = {
    "two-peaks": lambda: _coverage_like(1),
    "one-peak": lambda: np.random.RandomState(2).normal(20.0, 3.0, 300),
    "skewed": lambda: np.random.RandomState(3).lognormal(1.0, 0.8, 250),
    "few": lambda: np.array([1.0, 1.5, 2.0, 8.0, 9.0, 9.5, 10.0]),
}


def _gmm_init(x, n_comp=2):
    """fit_gmm's deterministic init (quantile-split means, pooled var)."""
    qs = np.linspace(0, 100, 2 * n_comp + 1)[1::2]
    return (np.full(n_comp, 1.0 / n_comp), np.percentile(x, qs),
            np.full(n_comp, max(np.var(x), 1e-6) / n_comp))


@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_em_iterations_and_params(case):
    import jax.numpy as jnp

    x = GMM_CASES[case]()
    w0, m0, v0 = _gmm_init(x)
    jw, jm, jv, jll, jit = jd._gmm_em(jnp.asarray(x), jnp.asarray(w0),
                                      jnp.asarray(m0), jnp.asarray(v0))
    t = [torch.from_numpy(np.asarray(a, np.float64)) for a in (x, w0, m0, v0)]
    tw, tm, tv, tll, tit = td._gmm_em(*t)
    assert tit == int(jit) and 1 < tit < 100
    for a, b in ((tw, jw), (tm, jm), (tv, jv)):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=REL,
                                   atol=0)
    assert float(tll) == pytest.approx(float(jll), rel=REL)

    got = td.fit_gmm(x, device="cpu")
    want = jd.fit_gmm(x)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=REL, atol=0)
    xs = np.linspace(0, 40, 200)
    assert (td.gmm_score_samples(xs, *got)
            == jd.gmm_score_samples(xs, *got)).all()


NL_CASES = {
    "mixed": (lambda: _coverage_like(4, n_main=300, n_bg=120, mean=6.0,
                                     sd=2.0), (1.5, 0.8, np.log(6.0))),
    "transcript": (lambda: np.random.RandomState(5).lognormal(2.0, 0.6, 300),
                   (3.0, 1.0, np.log(8.0))),
    "low": (lambda: _coverage_like(6, n_main=150, n_bg=150, mean=3.0,
                                   sd=1.0), (1.0, 0.5, np.log(3.0))),
}


def _flat(out):
    return np.concatenate([np.asarray(out[0], np.float64)]
                          + [np.asarray(float(v)).reshape(1)
                             for v in out[1:6]])


def _jax_nl(x, init, monkeypatch=None):
    """The JAX fit's outputs; with monkeypatch, run eagerly with a
    counting while_loop instead -> (outputs, iterations)."""
    import jax
    import jax.numpy as jnp

    args = (jnp.asarray(x),) + tuple(jnp.float64(v) for v in init + (1.0,))
    if monkeypatch is None:
        return _flat(jd._norm_lognorm_em(*args))
    count = []

    def counting_while(cond, body, val):
        n = 0
        while bool(cond(val)):
            val = body(val)
            n += 1
        count.append(n)
        return val

    monkeypatch.setattr(jax.lax, "while_loop", counting_while)
    with jax.disable_jit():
        out = _flat(jd._norm_lognorm_em(*args))
    return out, count[0]


@pytest.mark.parametrize("case", sorted(NL_CASES))
def test_norm_lognorm_em_iterations_and_params(case, monkeypatch):
    make, init = NL_CASES[case]
    x = make()
    tx = torch.from_numpy(x)
    out = td._norm_lognorm_em(
        tx, *(torch.tensor(float(v), dtype=torch.float64)
              for v in init + (1.0,)))
    n = out[-1]
    assert 10 <= n < 500
    got = _flat(out)
    want = _jax_nl(x, init)
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    # the JAX fit returns no iteration count: count its while_loop's
    # iterations in an eager run of the same function
    eager, n_jax = _jax_nl(x, init, monkeypatch)
    assert abs(n - n_jax) <= 1
    np.testing.assert_allclose(eager, want, rtol=REL, atol=0)

    w, mus, sds = td.fit_norm_lognorm(x, *init, device="cpu")
    jw, jmus, jsds = jd.fit_norm_lognorm(x, *init)
    np.testing.assert_allclose(w, jw, rtol=REL, atol=0)
    np.testing.assert_allclose(mus + sds, jmus + jsds, rtol=REL, atol=0)


def test_gamma_fits_equal():
    rng = np.random.RandomState(9)
    lengths = rng.gamma(3.0, 900.0, 500).astype(np.int64) + 50
    assert td.estimate_gamma_dist(lengths) == jd.estimate_gamma_dist(lengths)
    assert td.estimate_gamma_dist_minka(lengths) == \
        jd.estimate_gamma_dist_minka(lengths)


def test_fits_default_to_the_card():
    x = GMM_CASES["few"]()
    if torch.cuda.is_available():
        td.fit_gmm(x)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.fit_gmm(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.fit_norm_lognorm(x, 1.0, 0.5, 2.0)
