"""The port's plotting layer (headless Agg backend) on port models, with
its helpers held against the JAX package's (JAX: tests/test_plotting.py)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multivartv_tpu import plotting as jplotting
from multivartv_tpu_torch import mvtv
from multivartv_tpu_torch import plotting


@pytest.fixture(scope="module")
def model_2d():
    rng = np.random.RandomState(117)
    x = rng.uniform(size=(60, 2))
    y = rng.uniform(size=60)
    return mvtv(x, y, m=(3, 3), n_lambda=6, folds=1, device="cpu")


@pytest.fixture(scope="module")
def model_1d():
    rng = np.random.RandomState(7)
    x = rng.uniform(size=(50, 1))
    y = np.where(x[:, 0] > 0.5, 1.0, 0.0) + rng.normal(0, 0.2, 50)
    return mvtv(x, y, m=(6,), n_lambda=6, folds=1, device="cpu")


def test_plot_2d(model_2d, tmp_path):
    plotting.plot_model(model_2d, save=str(tmp_path / "s.png"))
    assert (tmp_path / "s.png").exists()


def test_plot_1d(model_1d, tmp_path):
    plotting.plot_model(model_1d, addmesh=True, save=str(tmp_path / "l.png"))
    assert (tmp_path / "l.png").exists()


def test_plot_at_lambda(model_2d):
    lam = float(np.sqrt(model_2d.lambdas[2] * model_2d.lambdas[3]))
    for at in (lam, float(model_2d.lambdas[0]) * 2, float(model_2d.lambdas[-1]) / 2,
               float(model_2d.lambdas[4])):
        plotting.plot_model(model_2d, lam=at)
        # the same entries, means and end points as the JAX package picks
        for got, want in zip(plotting._model_at_lambda(model_2d, at),
                             jplotting._model_at_lambda(model_2d, at)):
            np.testing.assert_array_equal(got, want)


def test_plot_residuals(model_2d, tmp_path):
    plotting.plot_residuals(model_2d, save=str(tmp_path / "r.png"))
    assert (tmp_path / "r.png").exists()


def test_plot_cv_curve(model_2d, tmp_path):
    plotting.plot_cv_curve(model_2d, save=str(tmp_path / "c.png"))
    assert (tmp_path / "c.png").exists()


def test_plot_3d_raises(model_2d):
    bad = dataclasses.replace(model_2d, data=np.zeros((10, 3)))
    with pytest.raises(ValueError):
        plotting.plot_model(bad)


def test_loess_exact_on_quadratic():
    """Degree-2 LOESS reproduces a noiseless quadratic (R loess defaults,
    MultivarTV.R:74), as the JAX package's does."""
    x = np.linspace(-2.0, 3.0, 80)
    y = 1.5 - 0.7 * x + 0.3 * x ** 2
    sm = plotting._loess_smooth(x, y)
    np.testing.assert_allclose(sm, y, atol=1e-8)
    np.testing.assert_array_equal(sm, jplotting._loess_smooth(x, y))


def test_loess_smooths_noise():
    rng = np.random.RandomState(0)
    x = np.sort(rng.uniform(0, 1, 200))
    y = np.sin(2 * np.pi * x)
    noisy = y + rng.randn(200) * 0.3
    sm = plotting._loess_smooth(x, noisy, frac=0.4)
    assert np.sqrt(np.mean((sm - y) ** 2)) < 0.15
    np.testing.assert_array_equal(sm, jplotting._loess_smooth(x, noisy, frac=0.4))


def test_model_at_lambda_without_stored_fits_warns(model_2d, caplog):
    """With per-lambda fits not stored (PathConfig.store="mse"), a plot at
    a lambda falls back to the best fit, with a logged warning."""
    bare = dataclasses.replace(model_2d, models=[{"lambda": 1.0, "mse": 0.0, "iters": 1}])
    import logging
    logger = logging.getLogger("multivartv_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        th, ft = plotting._model_at_lambda(bare, 0.5)
    finally:
        logger.removeHandler(caplog.handler)
    assert th is bare.theta_hat and ft is bare.fitted
    assert any("not stored" in r.getMessage() for r in caplog.records)
