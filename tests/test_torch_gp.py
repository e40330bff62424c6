"""The port's IncrementalGP against the JAX package's.

``from_state`` carries a reference GP's arrays into the port. On the numpy
backend the two agree to 1e-12; the ``"cuda"`` backend (its plain version
on the CPU) is held against the reference's ``"pallas"`` backend in
interpret mode with the tolerances of ``tests/test_kernels.py``.
"""
import numpy as np
import pytest

import torch

from repro.core.gp_fast import IncrementalGP as JaxIncrementalGP

from repro_torch.core.gp_fast import IncrementalGP

STATE_KEYS = ("Xc", "L", "V", "ssq", "X", "y", "t", "kernel", "ell", "noise")


def _reference_gp(nu="matern32", N=512, d=6, t=23, backend="numpy",
                  seed=3, block_n=128):
    rng = np.random.default_rng(seed)
    Xc = rng.random((N, d))
    g = JaxIncrementalGP(Xc, max_obs=40, kernel=nu, ell=1.5, noise=1e-6,
                         backend=backend, block_n=block_n)
    for _ in range(t):
        g.add(Xc[rng.integers(N)], float(rng.normal(5, 2)))
    return g, rng


def _arrays_of(g):
    return {k: getattr(g, k) for k in STATE_KEYS}


@pytest.mark.parametrize("nu", ["matern12", "matern32", "matern52", "rbf"])
def test_from_state_numpy_backend_equals_reference(nu):
    jg, rng = _reference_gp(nu)
    g = IncrementalGP.from_state(_arrays_of(jg))
    mu, sd = g.predict()
    mu_j, sd_j = jg.predict()
    np.testing.assert_allclose(mu, mu_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(sd, sd_j, rtol=0, atol=1e-12)
    X = rng.random((300, 6))
    for a, b in zip(g.predict_at(X), jg.predict_at(X)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    # both keep evolving identically after the hand-over
    x, y = rng.random(6), 4.2
    g.add(x, y)
    jg.add(x, y)
    np.testing.assert_allclose(g.predict()[0], jg.predict()[0], rtol=0,
                               atol=1e-12)


def test_state_round_trip_and_shape_check():
    jg, _ = _reference_gp()
    g = IncrementalGP.from_state(_arrays_of(jg))
    st = g.state()
    assert set(st) == set(STATE_KEYS)
    assert all(isinstance(v, np.ndarray) for v in st.values())
    g2 = IncrementalGP.from_state(st)
    assert g2.t == jg.t and g2.kernel == jg.kernel and g2.max_obs == 40
    np.testing.assert_array_equal(g2.predict()[0], g.predict()[0])
    bad = dict(st, V=st["V"][:, :-1])
    with pytest.raises(ValueError, match="V"):
        IncrementalGP.from_state(bad)


@pytest.mark.parametrize("nu", ["matern32", "matern52"])
def test_cuda_backend_on_cpu_matches_reference_pallas_backend(nu):
    jg, rng = _reference_gp(nu, N=512, d=6, t=23, backend="pallas")
    g = IncrementalGP.from_state(_arrays_of(jg), backend="cuda",
                                 block_n=128, device="cpu")
    for mine, theirs in ((g.predict(), jg.predict()),
                         (g.predict_at(jg.Xc[:256]),
                          jg.predict_at(jg.Xc[:256]))):
        mu, _ = mine
        mu_j, _ = theirs
        y_range = mu_j.max() - mu_j.min()
        assert np.abs(mu - mu_j).max() < 0.05 * y_range
        assert len(set(np.argsort(mu)[:20]) & set(np.argsort(mu_j)[:20])) >= 18
    # and against the float64 engine it packages
    mu64, _ = IncrementalGP.from_state(_arrays_of(jg)).predict()
    mu, sd = g.predict()
    assert np.abs(mu - mu64).max() < 0.05 * (mu64.max() - mu64.min())
    assert np.all(np.isfinite(sd)) and np.all(sd > 0)


def test_cuda_backend_keeps_the_panel_resident():
    jg, _ = _reference_gp()
    g = IncrementalGP.from_state(_arrays_of(jg), backend="cuda",
                                 block_n=128, device="cpu")
    g.predict()
    panel = g._Xc_dev
    assert panel.shape == (512, 6) and panel.dtype == torch.float32
    g.add(jg.Xc[7], 3.0)
    g.predict()
    assert g._Xc_dev is panel          # uploaded once, reused


def test_backend_names_and_default_device():
    with pytest.raises(ValueError, match="numpy\\|cuda"):
        IncrementalGP(np.zeros((4, 2)), max_obs=4, backend="pallas")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IncrementalGP(np.zeros((4, 2)), max_obs=4, backend="cuda")
