"""Dense GP regression in numpy: the O(N^3) oracle for predict_f and
predict_y (the formula of tests/integration/test_gpr.py, for Matern12, 32,
52 and their sums).  It imports numpy alone, so it runs beside either
package, on the card too (``chip_smoke.py`` loads it by path).
"""
import numpy as np

SQRT3 = 1.7320508075688772
SQRT5 = 2.23606797749979


def matern_gram(kind, lengthscale, variance, a, b):
    """k(a_i, b_j) of Matern12, Matern32 or Matern52."""
    r = np.abs(np.asarray(a)[:, None] - np.asarray(b)[None, :])
    if kind == "Matern12":
        return variance * np.exp(-r / lengthscale)
    if kind == "Matern32":
        lam = SQRT3 / lengthscale
        return variance * (1.0 + lam * r) * np.exp(-lam * r)
    if kind == "Matern52":
        lam = SQRT5 / lengthscale
        return variance * (1.0 + lam * r + (lam * r) ** 2 / 3.0) * np.exp(-lam * r)
    raise ValueError(kind)


def gram(kernels, a, b):
    """The sum of the grams of ``kernels``, a list of (kind, lengthscale,
    variance)."""
    return sum(matern_gram(kind, ell, var, a, b) for kind, ell, var in kernels)


def dense_posterior(kernels, noise_variance, x, y, x_new, mean=None):
    """Posterior of f at ``x_new`` given y [N] at x under kernels (a list of
    (kind, lengthscale, variance)) and Gaussian noise; ``mean`` maps time
    points to the prior mean.  Returns (mean [N*], covariance [N*, N*],
    log marginal likelihood)."""
    x, y, x_new = np.asarray(x), np.asarray(y), np.asarray(x_new)
    m_x = np.zeros_like(x) if mean is None else mean(x)
    m_new = np.zeros_like(x_new) if mean is None else mean(x_new)
    kxx = gram(kernels, x, x) + noise_variance * np.eye(len(x))
    kxs = gram(kernels, x, x_new)
    chol = np.linalg.cholesky(kxx)
    alpha = np.linalg.solve(chol.T, np.linalg.solve(chol, y - m_x))
    v = np.linalg.solve(chol, kxs)
    f_mean = m_new + kxs.T @ alpha
    f_cov = gram(kernels, x_new, x_new) - v.T @ v
    ll = -0.5 * ((y - m_x) @ alpha + 2.0 * np.log(np.diag(chol)).sum()
                 + len(x) * np.log(2.0 * np.pi))
    return f_mean, f_cov, ll
