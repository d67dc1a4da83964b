"""The port's lambda path, batched path and cross-validation against the
JAX package on the CPU: per-lambda MSEs and iterations of solve_path and
solve_path_batch on the JAX package's fold problems (exact route), the
kernel route's batched path (B5's plain version), the sweeps of
solver/batch.py, and the small units (fold labels, training masks, the
store budget, the point-cloud search, the lambda grid, with mvtv on a
one-point grid).  mvtv itself: test_torch_mvtv.py."""

import dataclasses
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from multivartv_tpu import api as japi
from multivartv_tpu.config import PathConfig as JPathConfig
from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.ops import interp as jinterp
from multivartv_tpu.solver import admm as jadmm
from multivartv_tpu.solver import batch as jbatch
from multivartv_tpu.solver import cv as jcv
from multivartv_tpu.solver import path as jpath
from multivartv_tpu.solver.problem import build_problem as jbuild_problem
import multivartv_tpu_torch as mt
from multivartv_tpu_torch import api
from multivartv_tpu_torch.config import CVConfig, PathConfig, SolverConfig
from multivartv_tpu_torch.ops import interp
from multivartv_tpu_torch.solver import admm
from multivartv_tpu_torch.solver import batch
from multivartv_tpu_torch.solver import cv
from multivartv_tpu_torch.solver import path
from multivartv_tpu_torch.solver.problem import problem_at

N, FOLDS = 1000, 3
EXACT = SolverConfig(use_kernels=False)


def bivariate_exp(n, seed=117):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 2))
    return x, np.exp(-(x[:, 0] ** 2 + x[:, 1] ** 2)) + rng.randn(n) * 0.3


@pytest.fixture(scope="module")
def data():
    x, y = bivariate_exp(N)
    labels = np.asarray(jcv.kfold_indices(N, FOLDS, 123))
    return x, y, labels


# ---------------------------------------------------------------------------
# Small units
# ---------------------------------------------------------------------------

def test_kfold_indices_balance():
    """Every fold gets n // k or n // k + 1 samples (test_cv.py:14-21);
    the labels are a seeded shuffle of i mod k."""
    for n, k in ((103, 5), (1000, 3)):
        labels = cv.kfold_indices(n, k, 123).numpy()
        counts = np.bincount(labels, minlength=k)
        assert counts.max() - counts.min() <= 1 and counts.sum() == n
        np.testing.assert_array_equal(np.sort(labels), np.sort(np.arange(n) % k))
        np.testing.assert_array_equal(labels, cv.kfold_indices(n, k, 123).numpy())
    assert not np.array_equal(cv.kfold_indices(1000, 3, 1).numpy(), labels)


@pytest.mark.parametrize("n_lambda", [1, 2, 3])
def test_create_lambdas_matches_jax(n_lambda):
    """The descending log grid against JAX's jnp.linspace one (rtol 1e-6):
    a one-point grid is [lambda_max * lambda_min_ratio], as jnp.linspace(lo,
    hi, 1) = [lo] gives it, not [lambda_max] (ROADMAP C4)."""
    lmax = np.float32(100.0)
    got = path.create_lambdas(torch.tensor(lmax), PathConfig(n_lambda=n_lambda)).numpy()
    want = np.asarray(jpath.create_lambdas(jnp.float32(lmax), JPathConfig(n_lambda=n_lambda)))
    assert got.shape == want.shape == (n_lambda,)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got[-1], lmax * PathConfig().lambda_min_ratio, rtol=1e-6)


def test_mvtv_single_lambda_matches_jax():
    """mvtv(n_lambda=1, folds=3) on the default config, with JAX's fold
    labels: the one lambda is lambda_max * lambda_min_ratio as in JAX
    (rtol 1e-5), and the objective at it agrees to 2e-5 (ROADMAP C4: the
    port fitted the constant at lambda_max, 0.60 from JAX's fit)."""
    rng = np.random.RandomState(1)
    n, m = 800, (8, 8)
    x = rng.uniform(-1, 1, (n, 2))
    y = np.exp(-(x[:, 0] ** 2 + x[:, 1] ** 2)) + rng.randn(n) * 0.3
    labels = torch.as_tensor(np.array(jcv.kfold_indices(n, FOLDS, 123)), dtype=torch.int64)
    jm = japi.mvtv(x, y, m=m, n_lambda=1, folds=FOLDS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cv, "kfold_indices", lambda n_, k, seed: labels)
        pm = mt.mvtv(x, y, m=m, n_lambda=1, folds=FOLDS, device="cpu")

    def objective(model):
        th = np.asarray(model.theta_lattice, np.float64)
        d0, d1 = (float(v) for v in np.asarray(model.mesh_spec.deltas))
        fid = 0.5 * np.sum((model.y - np.asarray(model.fitted, np.float64)) ** 2)
        pen = (np.abs(th[1:, 1:] - th[1:, :-1] - th[:-1, 1:] + th[:-1, :-1]).sum()
               + d0 * np.abs(th[:, 1:] - th[:, :-1]).sum()
               + d1 * np.abs(th[1:] - th[:-1]).sum())
        return fid + model.lambda_minmse * pen

    assert pm.lambdas.shape == (1,)
    np.testing.assert_allclose(pm.lambdas, np.asarray(jm.lambdas), rtol=1e-5)
    np.testing.assert_allclose(pm.lambda_minmse, jm.lambda_minmse, rtol=1e-5)
    assert abs(objective(pm) - objective(jm)) <= 2e-5 * abs(objective(jm))


def test_build_problem_train_mask_matches_jax(data):
    """Masked counts (exact), masked O'y and ybar over the training samples
    (float32 sums in another order: rtol 1e-5)."""
    x, y, labels = data
    mask = (labels != 1).astype(np.float32)
    spec = api._resolve_mesh(x, (12, 16), mt.MeshConfig(), torch.device("cpu"))
    got = mt.api.build_problem(spec, torch.as_tensor(x, dtype=torch.float32),
                               torch.as_tensor(y, dtype=torch.float32),
                               train_mask=torch.as_tensor(mask))
    jspec = japi._resolve_mesh(x, y, (12, 16), None, japi.DEFAULT_MESH, jnp.float32)
    want = jbuild_problem(jspec, jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                          train_mask=jnp.asarray(mask))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_allclose(got.oty.numpy(), np.asarray(want.oty), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.ybar), float(want.ybar), rtol=1e-5)
    np.testing.assert_array_equal(got.train_mask.numpy(), mask)
    ops = mt.api.build_operators((12, 16), spec.deltas, SolverConfig(), "cpu")
    theta = torch.as_tensor(np.random.RandomState(2).randn(12, 16).astype(np.float32))
    jops = japi._jit_setup(jspec, jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                           JSolverConfig())[0]
    fid, pen = admm.objective(ops, got, theta)
    jfid, jpen = jadmm.objective(jops, want, jnp.asarray(theta.numpy()))
    np.testing.assert_allclose([float(fid), float(pen)], [float(jfid), float(jpen)], rtol=1e-5)


def test_effective_store_degrades(monkeypatch, caplog):
    """Past STORE_BUDGET_ELEMS the path keeps only the MSEs, with a warning."""
    x, y = bivariate_exp(200)
    _, _, _, _, _, ops, problem = api._setup(x, y, (8, 8), None, SolverConfig(),
                                             mt.MeshConfig(), "cpu")
    lambdas = torch.ones(4)
    assert path._effective_store(ops, problem, lambdas, PathConfig()).store == "fitted"
    monkeypatch.setattr(path, "STORE_BUDGET_ELEMS", 4 * (64 + 200) - 1)
    with caplog.at_level(logging.WARNING, logger="multivartv_tpu_torch"):
        assert path._effective_store(ops, problem, lambdas, PathConfig()).store == "mse"
    assert "auto-degrading" in caplog.text
    assert path._effective_store(ops, problem, lambdas, PathConfig(store="mse")).store == "mse"
    with pytest.raises(ValueError):
        PathConfig(store="everything")


def test_nearest_pointcloud_indices_match_jax():
    rng = np.random.RandomState(4)
    pts = rng.uniform(-1, 1, (300, 2)).astype(np.float32)
    q = rng.uniform(-1.1, 1.1, (5000, 2)).astype(np.float32)
    got = interp.nearest_pointcloud_indices(torch.as_tensor(q), torch.as_tensor(pts), chunk=1024)
    want = np.asarray(jinterp.nearest_pointcloud_indices(q, pts, chunk=1024))
    assert np.mean(got.numpy() != want) <= 1e-3     # float32 near-ties may break either way
    exact = np.argmin(((q[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1), axis=1)
    assert np.mean(got.numpy() != exact) <= 1e-3


# ---------------------------------------------------------------------------
# The path and the batched path (exact route)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def folds_setup(data):
    x, y, labels = data
    m = (11, 17)
    _, _, spec, data_t, y_t, ops, problem = api._setup(x, y, m, None, EXACT, mt.MeshConfig(),
                                                       "cpu")
    problems = cv.fold_problems(spec, data_t, y_t, torch.as_tensor(np.array(labels)), FOLDS)
    jspec = japi._resolve_mesh(x, y, m, None, japi.DEFAULT_MESH, jnp.float32)
    xj, yj = jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
    jops, jproblem = japi._jit_setup(jspec, xj, yj, JSolverConfig())
    jproblems = jcv.fold_problems(jspec, xj, yj, jnp.asarray(labels), FOLDS)
    lambdas = np.geomspace(1.0, 0.03, 4).astype(np.float32)
    return dict(ops=ops, problem=problem, problems=problems, jops=jops, jproblem=jproblem,
                jproblems=jproblems, lambdas=lambdas, m=m)


def jax_fold(jproblems, f):
    """Fold f of the JAX package's fold-batched Problem."""
    return type(jproblems)(**{k.name: (None if getattr(jproblems, k.name) is None
                                       else getattr(jproblems, k.name)[f])
                              for k in dataclasses.fields(jproblems)})


def test_solve_path_exact_matches_jax(folds_setup):
    """One fold's path: per-lambda train and test MSE (rtol 1e-4) and
    iterations (equal) against JAX's solve_path on its CPU route."""
    s = folds_setup
    pr = problem_at(s["problems"], 0, 2)
    jpr = jax_fold(s["jproblems"], 0)
    got = path.solve_path(s["ops"], pr, torch.as_tensor(s["lambdas"]), EXACT, PathConfig())
    want = jpath.solve_path(s["jops"], jpr, jnp.asarray(s["lambdas"]), JSolverConfig(),
                            JPathConfig())
    np.testing.assert_allclose(got.train_mse.numpy(), np.asarray(want.train_mse), rtol=1e-4)
    np.testing.assert_allclose(got.test_mse.numpy(), np.asarray(want.test_mse), rtol=1e-4)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert got.thetas.shape == (4,) + s["m"] and got.fitted.shape == (4, N)
    for i, lam in enumerate(s["lambdas"]):
        fid, pen = admm.objective(s["ops"], pr, got.thetas[i])
        jfid, jpen = jadmm.objective(s["jops"], jpr, want.thetas[i])
        np.testing.assert_allclose(float(fid + lam * pen), float(jfid + lam * jpen), rtol=2e-5)
    assert got.exact_iters.tolist() == got.iters.tolist() and not got.escaped.any()


def test_solve_path_batch_exact_matches_jax(folds_setup):
    """All folds as one batch: (B, n_lambda) MSEs (rtol 1e-4), iterations
    (equal) and each fold's objective at each lambda (2e-5) against JAX's
    vmapped batch path."""
    s = folds_setup
    got = path.solve_path_batch(s["ops"], s["problems"], torch.as_tensor(s["lambdas"]), EXACT,
                                PathConfig())
    want = jpath.solve_path_batch(s["jops"], s["jproblems"], jnp.asarray(s["lambdas"]),
                                  JSolverConfig(), JPathConfig())
    assert got.test_mse.shape == (FOLDS, 4) and got.thetas.shape == (FOLDS, 4) + s["m"]
    np.testing.assert_allclose(got.train_mse.numpy(), np.asarray(want.train_mse), rtol=1e-4)
    np.testing.assert_allclose(got.test_mse.numpy(), np.asarray(want.test_mse), rtol=1e-4)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    for f in range(FOLDS):
        pr = problem_at(s["problems"], f, 2)
        jpr = jax_fold(s["jproblems"], f)
        for i, lam in enumerate(s["lambdas"]):
            fid, pen = admm.objective(s["ops"], pr, got.thetas[f, i])
            jfid, jpen = jadmm.objective(s["jops"], jpr, want.thetas[f, i])
            np.testing.assert_allclose(float(fid + lam * pen), float(jfid + lam * jpen),
                                       rtol=2e-5)


def test_cross_validate_loop_equals_batch(folds_setup):
    """vmap_folds=False (one fold after another) gives the batch's numbers."""
    s = folds_setup
    lam = torch.as_tensor(s["lambdas"][2:])
    a = cv.cross_validate(s["ops"], s["problems"], lam, EXACT, PathConfig(), CVConfig())
    b = cv.cross_validate(s["ops"], s["problems"], lam, EXACT, PathConfig(),
                          CVConfig(vmap_folds=False))
    torch.testing.assert_close(a.fold_test_mse, b.fold_test_mse, rtol=0, atol=0)
    assert torch.equal(a.fold_iters, b.fold_iters)
    torch.testing.assert_close(a.mean_mse, a.fold_test_mse.mean(dim=0))


def test_kernel_route_path_batch_matches_exact(folds_setup):
    """The same batched path through B5 (its plain version here): every
    fold Boyd-converged at every lambda, test MSE within 1e-2 of the exact
    route (bf16 preconditioner: each route stops at its own point inside
    tol; measured 1.1e-3)."""
    s = folds_setup
    lam = torch.as_tensor(s["lambdas"])
    got = path.solve_path_batch(s["ops"], s["problems"], lam, SolverConfig(), PathConfig())
    ref = path.solve_path_batch(s["ops"], s["problems"], lam, EXACT, PathConfig(store="mse"))
    np.testing.assert_allclose(got.test_mse.numpy(), ref.test_mse.numpy(), rtol=1e-2)
    assert torch.equal(got.chunked_iters, got.iters) and got.thetas.shape == (FOLDS, 4) + s["m"]
    assert bool(torch.all(got.iters < SolverConfig().max_iters))


def test_sweeps_match_jax(folds_setup):
    """solve_lambda_sweep (one problem, shared-mode B5) and
    solve_problem_batch against the JAX package's (exact route: MSEs rtol
    1e-4, iterations equal); the kernel route's sweep agrees to 1e-2."""
    s = folds_setup
    lam = s["lambdas"][1:4]
    got = batch.solve_lambda_sweep(s["ops"], s["problem"], torch.as_tensor(lam), EXACT)
    want = jbatch.solve_lambda_sweep(s["jops"], s["jproblem"], jnp.asarray(lam),
                                     JSolverConfig())
    np.testing.assert_allclose(got.mses.numpy(), np.asarray(want.mses), rtol=1e-4)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    kern = batch.solve_lambda_sweep(s["ops"], s["problem"], torch.as_tensor(lam),
                                    SolverConfig())
    np.testing.assert_allclose(kern.mses.numpy(), got.mses.numpy(), rtol=1e-2)
    got = batch.solve_problem_batch(s["ops"], s["problems"], torch.as_tensor(lam), EXACT)
    want = jbatch.solve_problem_batch(s["jops"], s["jproblems"], jnp.asarray(lam),
                                      JSolverConfig())
    np.testing.assert_allclose(got.mses.numpy(), np.asarray(want.mses), rtol=1e-4)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))


def test_path_progress_lines(folds_setup, capsys):
    """progress=True prints the reference's per-lambda line (solvers.cpp:134)
    with each lambda's iteration count."""
    s = folds_setup
    lam = torch.as_tensor(s["lambdas"][2:])
    res = path.solve_path(s["ops"], s["problem"], lam, EXACT, PathConfig(store="mse"),
                          progress=True)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("Lambda= ")
    assert lines[1].endswith(f"Counter = {int(res.iters[1])}")
