"""The port's mvtv against the JAX package's on the CPU, with the JAX
package's fold labels (fed to the port through its kfold_indices): the
lambda grid, the CV curve, the chosen index and lambda_1se, the objective
at the chosen lambda, the folds = 1 bypass, store="mse" with its fresh
solve, the kernel route (B5 and B4 through their plain versions),
MVTVModel.predict with and without an explicit mesh, and p = 1 (mvtv and
mvtv_one) under the default config."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multivartv_tpu import api as japi
from multivartv_tpu.config import PathConfig as JPathConfig
from multivartv_tpu.solver import cv as jcv
import multivartv_tpu_torch as mt
from multivartv_tpu_torch.config import PathConfig, SolverConfig
from multivartv_tpu_torch.solver import cv

N, FOLDS, N_LAMBDA = 1000, 3, 6
EXACT = SolverConfig(use_kernels=False)
MESHES = ((12, 16), (11, 17))


def bivariate_exp(n, seed=117):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 2))
    return x, np.exp(-(x[:, 0] ** 2 + x[:, 1] ** 2)) + rng.randn(n) * 0.3


def objective(model):
    """0.5 ||y - fitted||^2 + lambda ||D theta||_1 of a model's chosen fit,
    in float64."""
    th = np.asarray(model.theta_lattice, np.float64)
    d0, d1 = (float(v) for v in np.asarray(model.mesh_spec.deltas))
    fid = 0.5 * np.sum((model.y - np.asarray(model.fitted, np.float64)) ** 2)
    pen = (np.abs(th[1:, 1:] - th[1:, :-1] - th[:-1, 1:] + th[:-1, :-1]).sum()
           + d0 * np.abs(th[:, 1:] - th[:, :-1]).sum() + d1 * np.abs(th[1:] - th[:-1]).sum())
    return fid + model.lambda_minmse * pen


@pytest.fixture(scope="module")
def data():
    x, y = bivariate_exp(N)
    return x, y, torch.as_tensor(np.array(jcv.kfold_indices(N, FOLDS, 123)), dtype=torch.int64)


@pytest.fixture()
def jax_labels(data, monkeypatch):
    """The port's mvtv draws the JAX package's fold labels."""
    monkeypatch.setattr(cv, "kfold_indices", lambda n, k, seed: data[2])


@pytest.fixture(scope="module")
def jax_fits(data):
    x, y, _ = data
    return {m: japi.mvtv(x, y, m=m, n_lambda=N_LAMBDA, folds=FOLDS) for m in MESHES}


@pytest.fixture(scope="module")
def port_fits(data):
    x, y, labels = data
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cv, "kfold_indices", lambda n, k, seed: labels)
        return {m: mt.mvtv(x, y, m=m, n_lambda=N_LAMBDA, folds=FOLDS, device="cpu",
                           solver_config=EXACT) for m in MESHES}


@pytest.mark.parametrize("m", MESHES)
def test_mvtv_matches_jax(jax_fits, port_fits, m):
    """Exact route, JAX's fold labels: the same lambda grid (rtol 1e-5),
    the same chosen index and lambda_1se, the CV curve at rtol 1e-4
    (measured 1e-5), the objective at the chosen lambda within 2e-5, and
    the per-lambda iterations of the full path equal."""
    jm, pm = jax_fits[m], port_fits[m]
    np.testing.assert_allclose(pm.lambdas, np.asarray(jm.lambdas), rtol=1e-5)
    assert pm.lambda_minmse_ind == jm.lambda_minmse_ind
    np.testing.assert_allclose(pm.cv_mses, np.asarray(jm.cv_mses), rtol=1e-4)
    np.testing.assert_allclose(pm.lambda_1se, jm.lambda_1se, rtol=1e-5)
    assert abs(objective(pm) - objective(jm)) <= 2e-5 * abs(objective(jm))
    assert [e["iters"] for e in pm.models] == [e["iters"] for e in jm.models]
    assert pm.theta_lattice.shape == m and pm.fitted.shape == (N,)
    np.testing.assert_array_equal(pm.theta_hat, pm.theta_lattice.T.reshape(-1))
    np.testing.assert_allclose(pm.residuals, pm.y - pm.fitted)
    np.testing.assert_array_equal(pm.models[pm.lambda_minmse_ind]["theta_hat"], pm.theta_hat)


def test_mvtv_kernel_route_on_cpu(data, jax_fits, jax_labels):
    """The default route (B5 and B4 through their plain versions): the
    chosen index in the set whose JAX CV MSE is within 1e-3 of the minimum,
    the curve within 5e-3 (measured 5.1e-4: each route stops at its own
    point inside tol)."""
    x, y, _ = data
    jm = jax_fits[(12, 16)]
    pm = mt.mvtv(x, y, m=(12, 16), n_lambda=N_LAMBDA, folds=FOLDS, device="cpu")
    jc = np.asarray(jm.cv_mses)
    assert pm.lambda_minmse_ind in np.nonzero(jc <= jc.min() * (1 + 1e-3))[0]
    np.testing.assert_allclose(pm.cv_mses, jc, rtol=5e-3)


def test_mvtv_folds1_and_fresh_solve_match_jax(data, jax_labels):
    """folds = 1: the path's MSE against y picks the index and a fresh
    solve refits it (solvers.cpp:328-335); store="mse" refits with a fresh
    solve too.  Both against the JAX package (objective 2e-5)."""
    x, y, _ = data
    m = (11, 17)
    for folds, store in ((1, "fitted"), (FOLDS, "mse")):
        jm = japi.mvtv(x, y, m=m, n_lambda=4, folds=folds, path_config=JPathConfig(
            n_lambda=4, store=store))
        pm = mt.mvtv(x, y, m=m, n_lambda=4, folds=folds, device="cpu", solver_config=EXACT,
                     path_config=PathConfig(n_lambda=4, store=store))
        assert pm.lambda_minmse_ind == jm.lambda_minmse_ind
        np.testing.assert_allclose(pm.cv_mses, np.asarray(jm.cv_mses), rtol=1e-4)
        assert abs(objective(pm) - objective(jm)) <= 2e-5 * abs(objective(jm))
        assert ("theta_hat" in pm.models[0]) == (store == "fitted")


def test_predict_matches_jax(jax_fits, port_fits):
    """MVTVModel.predict on new data and with an explicit mesh= (the knot
    matrix, shuffled), and predict_mvtv(model): the JAX package's values
    on the same theta (points binned differently at exact midpoints
    excepted, <= 1e-3)."""
    m = (12, 16)
    jm, pm = jax_fits[m], port_fits[m]
    rng = np.random.RandomState(9)
    xq = rng.uniform(-1.1, 1.1, (3000, 2))
    jm_same = dataclasses.replace(jm, theta_lattice=pm.theta_lattice, theta_hat=pm.theta_hat)
    assert np.mean(pm.predict(xq) != np.asarray(jm_same.predict(xq))) <= 1e-3
    np.testing.assert_array_equal(mt.predict_mvtv(pm, xq), pm.predict(xq))
    np.testing.assert_array_equal(mt.predict_mvtv(pm), pm.fitted)
    np.testing.assert_array_equal(pm.predict(pm.data), pm.fitted)
    got = pm.predict(xq, mesh=pm.mesh)
    assert np.mean(got != np.asarray(jm_same.predict(xq, mesh=np.asarray(jm.mesh)))) <= 1e-3
    assert np.mean(got != pm.predict(xq)) <= 1e-3     # the mesh is the lattice itself
    from matplotlib.figure import Figure
    import matplotlib.pyplot as plt
    for fig in (pm.plot(), pm.plot(lam=float(pm.lambdas[1])), pm.plot_residuals()):
        assert isinstance(fig, Figure) and fig.axes
        plt.close(fig)


def univariate(n, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, n)
    return x, np.exp(-x ** 2) + rng.randn(n) * 0.3


@pytest.mark.parametrize("column", [False, True], ids=["x(n,)", "x(n,1)"])
def test_mvtv_p1_default_config_matches_jax(column, monkeypatch):
    """p = 1 under the default config runs the "tridiag" route (T1's
    wrapper, the exact cyclic reduction, on every x-update of the folds and
    the path), with JAX's fold labels: the same chosen index, the CV curve
    at rtol 1e-4, on x of shape (n,) and (n, 1)."""
    from multivartv_tpu_torch.ops import kernels as K
    n = 400
    x, y = univariate(n)
    x = x[:, None] if column else x
    labels = torch.as_tensor(np.array(jcv.kfold_indices(n, 2, 123)), dtype=torch.int64)
    monkeypatch.setattr(cv, "kfold_indices", lambda n_, k, seed: labels)
    calls = []
    plain = K.xupdate_tridiag_reference
    monkeypatch.setattr(K, "xupdate_tridiag_reference", lambda *a: calls.append(1) or plain(*a))
    jm = japi.mvtv(x, y, n_lambda=4, folds=2)
    pm = mt.mvtv(x, y, n_lambda=4, folds=2, device="cpu")
    assert calls
    assert pm.lambda_minmse_ind == jm.lambda_minmse_ind
    np.testing.assert_allclose(pm.cv_mses, np.asarray(jm.cv_mses), rtol=1e-4)
    assert pm.theta_lattice.shape == tuple(np.asarray(jm.theta_lattice).shape)


def test_mvtv_one_p1_default_config_matches_jax():
    """mvtv_one on one column under the default config (the "tridiag"
    route, no CG step): 0.5 ||y - fitted||^2 + lambda ||D theta||_1 within
    2e-5 of JAX's."""
    x, y = univariate(400, seed=5)

    def objective(res):
        th = np.asarray(res["theta_lattice"], np.float64).reshape(-1)
        fid = 0.5 * np.sum((res["y"] - np.asarray(res["fitted"], np.float64)) ** 2)
        return fid + res["lambda"] * np.abs(np.diff(th)).sum()

    jres = japi.mvtv_one(x, y, lam=1.0)
    pres = mt.mvtv_one(x, y, lam=1.0, device="cpu")
    assert pres["diagnostics"]["converged"] and pres["diagnostics"]["cg_iterations"] == 0
    assert pres["diagnostics"]["exact_iterations"] == 0
    assert abs(objective(pres) - objective(jres)) <= 2e-5 * abs(objective(jres))


def test_mvtv_cuda_default_raises_without_cuda(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-CUDA guard cannot be observed")
    x, y, _ = data
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mt.mvtv(x, y, m=(8, 8), n_lambda=2)
    # a user's mesh= goes through the same guard
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mt.mvtv(x, y, m=(2, 2), mesh=np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]))
