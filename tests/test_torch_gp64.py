"""A float64 Gaussian-process posterior in numpy and scipy, the yardstick
the padded GP of both packages is held to (``test_torch_gp_padded.py``,
``test_torch_strategies.py``, ``test_torch_cuda.py``). It shares no code
with either package, imports no JAX, and is checked here against closed
forms."""
import math

import numpy as np
import scipy.linalg as sl


def kernel64(name, r, ell):
    """Matérn-1/2, 3/2, 5/2 or RBF covariance at distance ``r``."""
    s = r / ell
    if name == "matern12":
        return np.exp(-s)
    if name == "matern32":
        t = math.sqrt(3.0) * s
        return (1.0 + t) * np.exp(-t)
    if name == "matern52":
        t = math.sqrt(5.0) * s
        return (1.0 + t + (5.0 / 3.0) * s * s) * np.exp(-t)
    assert name == "rbf"
    return np.exp(-0.5 * s * s)


def posterior64(X, y, mask, Xc, extra=None, *, kernel="matern32", ell=2.0,
                noise=1e-6):
    """The GP posterior in float64: fitted on the real rows alone (a padded
    row drops out exactly), distances as differences, the observations
    standardized as both packages do. Returns (mean, std, alpha padded to
    ``len(mask)``, y_std, the covariance's condition number)."""
    mask = np.asarray(mask, bool)
    Xo = np.asarray(X, np.float64)[mask]
    yo = np.asarray(y, np.float64)[mask]
    y_mean = yo.mean()
    y_std = math.sqrt(max(float(((yo - y_mean) ** 2).mean()), 1e-12))
    yc = (yo - y_mean) / y_std

    def dist(a, b):
        return np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))

    K = kernel64(kernel, dist(Xo, Xo), ell) + noise * np.eye(len(Xo))
    if extra is not None:
        K += np.diag(np.asarray(extra, np.float64)[mask])
    L = np.linalg.cholesky(K)
    alpha = sl.cho_solve((L, True), yc)
    Ks = kernel64(kernel, dist(np.asarray(Xc, np.float64), Xo), ell)
    v = sl.solve_triangular(L, Ks.T, lower=True)
    var = np.maximum(1.0 - (v * v).sum(0), 1e-12)
    alpha_pad = np.zeros(len(mask))
    alpha_pad[mask] = alpha
    return (Ks @ alpha * y_std + y_mean, np.sqrt(var) * y_std, alpha_pad,
            y_std, float(np.linalg.cond(K)))


def test_two_points_closed_form():
    """Two observations at distance 1 under Matérn-3/2: the posterior at a
    third point, from the 2 x 2 inverse written out."""
    X = np.array([[0.0, 0.0], [1.0, 0.0], [9.0, 9.0]])
    y = np.array([1.0, 3.0, 123.0])
    mask = np.array([True, True, False])        # the padded row drops out
    xs = np.array([[0.25, 0.5]])
    mu, sd, alpha, y_std, _ = posterior64(X, y, mask, xs, noise=0.01)
    k = lambda r: kernel64("matern32", np.asarray(r, np.float64), 2.0)
    a, b = 1.0 + 0.01, float(k(1.0))
    inv = np.array([[a, -b], [-b, a]]) / (a * a - b * b)
    yc = np.array([-1.0, 1.0])                  # (y - 2) / 1
    ks = k([math.hypot(0.25, 0.5), math.hypot(0.75, 0.5)])
    assert y_std == 1.0
    np.testing.assert_allclose(alpha, np.r_[inv @ yc, 0.0], rtol=1e-12)
    np.testing.assert_allclose(mu, [ks @ inv @ yc + 2.0], rtol=1e-12)
    np.testing.assert_allclose(sd, [math.sqrt(1.0 - ks @ inv @ ks)],
                               rtol=1e-12)


def test_interpolates_its_observations():
    rng = np.random.default_rng(0)
    X = rng.random((12, 3))
    y = rng.normal(5.0, 2.0, 12)
    for kernel in ("matern12", "matern32", "matern52", "rbf"):
        mu, sd, _, _, _ = posterior64(X, y, np.ones(12, bool), X,
                                         kernel=kernel, ell=0.5, noise=1e-10)
        np.testing.assert_allclose(mu, y, atol=1e-6)
        assert sd.max() < 1e-3 * y.std()
