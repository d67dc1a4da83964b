"""The port's exact p = 1 x-update (solver/tridiag.py, the plain version of
T1 = ops/kernels.py::xupdate_tridiag) and the 1-D fused lasso (m = N,
mesh = x) against the JAX package's cyclic reduction, a float64 banded
solve and tests/golden.py, on the CPU."""

import numpy as np
import pytest
import scipy.linalg

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import golden
from multivartv_tpu import api as japi
from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.solver import cv as jcv
from multivartv_tpu.solver import problem as jproblem
from multivartv_tpu.solver import tridiag as jtri
import multivartv_tpu_torch as mt
from multivartv_tpu_torch import mesh as mesh_lib
from multivartv_tpu_torch.config import SolverConfig
from multivartv_tpu_torch.ops import interp
from multivartv_tpu_torch.ops import kernels as K
from multivartv_tpu_torch.solver import admm, cv, tridiag
from multivartv_tpu_torch.solver.problem import build_operators

# JAX's tolerance for its CR against a dense solve (tests/test_tridiag.py:33-44)
TOL = 5e-6


def banded64(counts, b, rho, s):
    """x of (diag(counts) + g T) x = b in float64, g = (rho s) s in float32."""
    n = len(counts)
    g = float(np.float32(np.float32(rho) * np.float32(s)) * np.float32(s))
    diag = np.asarray(counts, np.float64) + g * (2.0 - (np.arange(n) == 0) - (np.arange(n) == n - 1))
    ab = np.zeros((3, n))
    ab[0, 1:] = -g
    ab[1] = diag
    ab[2, :-1] = -g
    return scipy.linalg.solve_banded((1, 1), ab, np.asarray(b, np.float64))


def system(n, seed, empty=0.0):
    """Poisson(2) counts (a share `empty` of them set to 0) and N(0, 1) b."""
    rng = np.random.RandomState(seed)
    counts = rng.poisson(2, n).astype(np.float32)
    counts[rng.uniform(size=n) < empty] = 0.0
    if counts.max() == 0:
        counts[0] = 1.0
    return counts, rng.randn(n).astype(np.float32)


def port_x(counts, b, rho, s, fn=tridiag.xupdate_tridiag):
    return fn(torch.as_tensor(counts), torch.as_tensor(b), torch.tensor(rho, dtype=torch.float32),
              s).numpy()


@pytest.mark.parametrize("n", [1, 2, 3, 64, 1000, 4097, 1 << 15])
def test_xupdate_tridiag_matches_banded_and_jax(n):
    counts, b = system(n, n)
    rho, s = 0.7, 1.3
    x = port_x(counts, b, rho, s)
    ref = banded64(counts, b, rho, s)
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(x - ref)) / scale < TOL
    xj = np.asarray(jtri.xupdate_tridiag(jnp.asarray(counts), jnp.asarray(b), jnp.float32(rho),
                                         jnp.float32(s)))
    assert np.max(np.abs(x - xj)) / scale < TOL


@pytest.mark.parametrize("g", [1e-4, 1e-2, 1.0, 50.0])
def test_xupdate_tridiag_conditioning_and_empty_knots(g):
    """g = rho s^2 from 1e-4 to 50 (the ill-conditioned end of JAX's
    docstring, tridiag.py:212-219), a third of the knots empty."""
    counts, b = system(5000, 11, empty=0.33)
    x = port_x(counts, b, g, 1.0)
    ref = banded64(counts, b, g, 1.0)
    assert np.max(np.abs(x - ref)) / max(1.0, np.max(np.abs(ref))) < TOL


def test_cr_solve_general_system():
    """cr_solve on a general diagonally dominant system, every length up to
    17 (the power-of-two padding at each)."""
    rng = np.random.RandomState(3)
    for n in range(1, 18):
        a = rng.uniform(-1, 0, n).astype(np.float32)
        c = rng.uniform(-1, 0, n).astype(np.float32)
        a[0] = c[-1] = 0.0
        bb = (np.abs(a) + np.abs(c) + rng.uniform(0.1, 1, n)).astype(np.float32)
        d = rng.randn(n).astype(np.float32)
        dense = np.diag(bb.astype(np.float64)) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)
        x = tridiag.cr_solve(*(torch.as_tensor(v) for v in (a, bb, c, d))).numpy()
        xj = np.asarray(jtri.cr_solve(*(jnp.asarray(v) for v in (a, bb, c, d))))
        ref = np.linalg.solve(dense, d.astype(np.float64))
        assert np.max(np.abs(x - ref)) < 1e-5 * max(1.0, np.max(np.abs(ref)))
        assert np.max(np.abs(x - xj)) < 1e-5 * max(1.0, np.max(np.abs(ref)))


def test_wrapper_runs_the_plain_version_on_the_cpu():
    """T1's wrapper on CPU tensors is the plain CR, bit for bit, and counts
    no launch; it refuses what the kernel does not take."""
    counts, b = system(300, 5)
    K.reset_launch_counts()
    x = port_x(counts, b, 0.4, 0.9, K.xupdate_tridiag)
    assert np.array_equal(x, port_x(counts, b, 0.4, 0.9))
    assert K.launch_counts["xupdate_tridiag"] == 0
    with pytest.raises(ValueError):
        K.xupdate_tridiag(torch.zeros(4), torch.zeros(5), torch.tensor(1.0), 1.0)
    with pytest.raises(ValueError):
        K.xupdate_tridiag(torch.zeros(4, dtype=torch.float64), torch.zeros(4, dtype=torch.float64),
                          torch.tensor(1.0), 1.0)


def test_tridiag_applies_matches_jax_gate():
    """tridiag_applies and the route it gives, against JAX's gate
    (tests/test_tridiag.py:63-71)."""
    for cfg_kw in ({}, {"x_solver": "jacobi_pcg"}, {"x_solver": "cg"},
                   {"x_solver": "dct_direct"}, {"stop_rule": "theta_inf"}):
        cfg, jcfg = SolverConfig(**cfg_kw), JSolverConfig(**cfg_kw)
        for m, d in (((37,), [0.1]), ((8, 8), [0.1, 0.1])):
            ops = build_operators(m, d, cfg, "cpu")
            jops = jproblem.build_operators(m, jnp.asarray(d), jcfg, jnp.float32)
            assert tridiag.tridiag_applies(ops, cfg) == jtri.tridiag_applies(jops, jcfg)
    ops1 = build_operators((37,), [0.1], SolverConfig(), "cpu")
    assert admm.solve_route(ops1, SolverConfig()) == "tridiag"
    assert admm.solve_route(ops1, SolverConfig(use_kernels=False)) is None
    assert admm.solve_route(ops1, SolverConfig(x_solver="jacobi_pcg")) is None
    # the elements of a batched solve (CV folds) keep the route, escape off
    el = admm._element_config(ops1, SolverConfig())
    assert el.use_kernels and not el.bf16_residual_escape
    assert admm.solve_route(ops1, el) == "tridiag"
    assert not admm.batched_kernel_route(ops1, None, SolverConfig())


def fused_lasso(n, seed=117):
    """The 1-D fused lasso's data: sorted x ~ U(0, 1), a step plus noise."""
    rng = np.random.RandomState(seed)
    x = np.sort(rng.uniform(0, 1, n))
    return x, (x > 0.5).astype(float) + rng.randn(n) * 0.1


def test_fused_lasso_mvtv_one_matches_golden():
    """mvtv_one(x, y, m=(n,), mesh=x) at n = 200, lambda = 0.05: the
    objective within 1e-4 of the float64 golden ADMM's, 0 CG steps, no
    iteration on the exact route (tests/test_tridiag.py:74-98)."""
    n, lam = 200, 0.05
    x, y = fused_lasso(n)
    K.reset_launch_counts()
    res = mt.mvtv_one(x, y, m=(n,), mesh=x[:, None], lam=lam, device="cpu")
    d = res["diagnostics"]
    assert d["converged"] and d["cg_iterations"] == 0 and d["exact_iterations"] == 0
    spec = res["mesh_spec"]
    assert isinstance(spec, mesh_lib.MeshSpec) and not spec.regular
    flat = interp.flat_knot_indices(spec, torch.as_tensor(x[:, None], dtype=torch.float32))
    deltas = spec.deltas.double().numpy()
    theta = res["theta_lattice"].astype(np.float64)
    obj = float(golden.objective(flat.numpy(), y, spec.m, deltas, theta, lam))
    g = golden.admm_golden(flat.numpy(), y, spec.m, deltas, lam)
    gobj = float(golden.objective(flat.numpy(), y, spec.m, deltas, g["theta"], lam))
    assert abs(obj - gobj) <= 1e-4 * abs(gobj)
    np.testing.assert_allclose(res["mesh"], x[:, None].astype(np.float32))


def objective64(model, i):
    """0.5 ||y - fitted||^2 + lambda ||D theta||_1 of a 1-D model's fit at
    lambda index i, in float64 (at p = 1 D is the unscaled first
    difference: its block scale is the empty product of cell sizes)."""
    if i == model.lambda_minmse_ind:
        th, fitted = model.theta_lattice, model.fitted
    else:
        th, fitted = model.models[i]["theta_hat"], model.models[i]["fitted"]
    fid = 0.5 * np.sum((model.y - np.asarray(fitted, np.float64)) ** 2)
    return fid + float(model.lambdas[i]) * np.abs(np.diff(np.asarray(th, np.float64))).sum()


def test_fused_lasso_mvtv_matches_jax(monkeypatch):
    """mvtv(x, y, m=(n,), mesh=x, folds=3, n_lambda=5) with JAX's fold
    labels: the chosen index in JAX's tie set, the objective at it within
    2e-5 of JAX's, the CV curve at rtol 1e-4, T1 on every fold."""
    n, folds = 200, 3
    x, y = fused_lasso(n, seed=5)
    labels = torch.as_tensor(np.array(jcv.kfold_indices(n, folds, 123)), dtype=torch.int64)
    monkeypatch.setattr(cv, "kfold_indices", lambda n_, k, seed: labels)
    calls = []
    plain = K.xupdate_tridiag_reference
    monkeypatch.setattr(K, "xupdate_tridiag_reference",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    jm = japi.mvtv(x, y, m=(n,), mesh=x[:, None], folds=folds, n_lambda=5)
    pm = mt.mvtv(x, y, m=(n,), mesh=x[:, None], folds=folds, n_lambda=5, device="cpu")
    jc = np.asarray(jm.cv_mses, np.float64)
    ties = np.nonzero(jc <= jc.min() * (1 + 1e-4))[0].tolist()
    assert pm.lambda_minmse_ind in ties
    np.testing.assert_allclose(pm.cv_mses, jc, rtol=1e-4)
    i = pm.lambda_minmse_ind
    assert abs(objective64(pm, i) / objective64(jm, i) - 1) <= 2e-5
    assert calls and all(sh == (n,) for sh in calls)
    np.testing.assert_allclose(pm.mesh, np.asarray(jm.mesh))
