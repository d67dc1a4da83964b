"""The whole slice: the port's mvtv_one and predict_mvtv against the JAX
package's on the CPU, the verify-flow invariant, and the guards that keep
the port off JAX and off a silent CPU fallback."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from multivartv_tpu import api as japi
from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.solver import admm as jadmm
import multivartv_tpu_torch as mt
from multivartv_tpu_torch.ops import kernels

ROOT = Path(__file__).resolve().parent.parent


def bivariate_exp(n, seed=117):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 2))
    return x, np.exp(-(x[:, 0] ** 2 + x[:, 1] ** 2)) + rng.randn(n) * 0.3


def objective(res, deltas):
    """0.5 ||y - fitted||^2 + lambda ||D theta||_1 in float64."""
    th = np.asarray(res["theta_lattice"], np.float64)
    d0, d1 = (float(v) for v in deltas)
    fid = 0.5 * np.sum((res["y"] - np.asarray(res["fitted"], np.float64)) ** 2)
    pen = (np.abs(th[1:, 1:] - th[1:, :-1] - th[:-1, 1:] + th[:-1, :-1]).sum()
           + d0 * np.abs(th[:, 1:] - th[:, :-1]).sum() + d1 * np.abs(th[1:] - th[:-1]).sum())
    return fid + res["lambda"] * pen


def jax_chunked(fn):
    """fn() on the JAX package's chunked route (admm_iters_2d in interpret
    mode, its TPU default); the route is chosen at trace time, so the jit
    caches are cleared around the call."""
    jadmm.FORCE_FUSED_INTERPRET = True
    jax.clear_caches()
    try:
        return fn()
    finally:
        jadmm.FORCE_FUSED_INTERPRET = False
        jax.clear_caches()


@pytest.fixture(scope="module")
def data():
    return bivariate_exp(2000)


@pytest.fixture(scope="module")
def fits(data):
    """The JAX package (its CPU route is the exact-f32 one) and the port at
    lambda_max / 100 on an odd mesh (the port pads it to even axes).  At the
    default tol = 1e-4 both routes stop ~2e-3 above the optimum on this
    problem, each at its own point, so the kernel route is compared at
    tol = 1e-5 (measured gap 4e-8), and the exact route, the same
    algorithm, at the default tol (measured gap 6e-8)."""
    x, y = data
    m = (30, 41)
    jmax = japi.mvtv_one(x, y, m=m)
    lam = jmax["lambda"] / 100.0
    tight = dict(tol=1e-5)
    return dict(
        m=m, jmax=jmax, pmax=mt.mvtv_one(x, y, m=m, device="cpu"),
        jmax_chunked=jax_chunked(lambda: japi.mvtv_one(x, y, m=m)),
        jfit=japi.mvtv_one(x, y, m=m, lam=lam, solver_config=JSolverConfig(**tight)),
        pfit=mt.mvtv_one(x, y, m=m, lam=lam, device="cpu",
                         solver_config=mt.SolverConfig(**tight)),
        jexact=japi.mvtv_one(x, y, m=m, lam=lam),
        pexact=mt.mvtv_one(x, y, m=m, lam=lam, device="cpu",
                           solver_config=mt.SolverConfig(use_kernels=False)))


def test_lambda_max_matches_jax(fits):
    """Exact DCT pseudo-inverse on both sides: rtol 1e-5."""
    np.testing.assert_allclose(fits["pmax"]["lambda"], fits["jmax"]["lambda"], rtol=1e-5)


def test_lambda_max_fit_matches_jax_chunked_route(fits, data):
    """The default call (lam=None, so lambda = lambda_max) against the JAX
    package's chunked route on the same data: objective gap <= 1e-3
    (test_chunk.py:70; measured 5e-5).  theta == mean(y) is the optimum at
    lambda_max, but at tol = 1e-4 both stop ~1.31 x above that closed-form
    objective here: Boyd's absolute tolerance lets a smooth drift of theta
    through, and lambda_max multiplies its ||D theta||_1."""
    _, y = data
    pmax, jc = fits["pmax"], fits["jmax_chunked"]
    np.testing.assert_allclose(pmax["lambda"], jc["lambda"], rtol=1e-5)
    deltas = np.asarray(jc["mesh_spec"].deltas)
    ref, got = objective(jc, deltas), objective(pmax, deltas)
    assert abs(got - ref) <= 1e-3 * ref
    assert 0.5 * np.sum((y - y.mean()) ** 2) <= got
    assert pmax["diagnostics"]["converged"]


@pytest.mark.parametrize("route", ["kernel", "exact"])
def test_mvtv_one_objective_matches_jax(fits, route):
    """Objective gap <= 2e-5 against the JAX exact-f32 route
    (test_pad_single.py:118); the same mesh and output layout."""
    jfit, pfit = (fits["jfit"], fits["pfit"]) if route == "kernel" else (fits["jexact"],
                                                                         fits["pexact"])
    assert pfit["theta_lattice"].shape == fits["m"]
    np.testing.assert_array_equal(pfit["mesh"], np.asarray(jfit["mesh"], np.float32))
    deltas = np.asarray(jfit["mesh_spec"].deltas)
    ref = objective(jfit, deltas)
    assert abs(objective(pfit, deltas) - ref) <= 2e-5 * abs(ref)
    assert pfit["diagnostics"]["converged"]
    np.testing.assert_array_equal(
        pfit["theta_hat"], pfit["theta_lattice"].T.reshape(-1))


def test_verify_flow_invariant():
    """mvtv_one(data, y, m=(10, 10)) at lambda_max: mean(theta_hat) ==
    mean(fitted) == mean(y) to 3 decimals (the JAX package's verify flow)."""
    x, y = bivariate_exp(1500, seed=3)
    res = mt.mvtv_one(x, y, m=(10, 10), device="cpu")
    means = [res["theta_hat"].mean(), res["fitted"].mean(), y.mean()]
    assert max(means) - min(means) < 5e-4


def test_predict_matches_jax(fits):
    """The same theta through both predict_mvtv: the same fitted values
    (samples binned differently at exact midpoints excepted, <= 1e-4)."""
    rng = np.random.RandomState(9)
    xq = rng.uniform(-1.2, 1.2, (5000, 2))
    pfit, jfit = fits["pfit"], fits["jfit"]
    got = mt.predict_mvtv(pfit, xq)
    want = np.asarray(japi.predict_mvtv(dict(jfit, theta_lattice=pfit["theta_lattice"]), xq))
    assert got.shape == (5000,)
    assert np.mean(got != want) <= 1e-4
    np.testing.assert_array_equal(mt.predict_mvtv(pfit), pfit["fitted"])
    np.testing.assert_array_equal(mt.predict_mvtv(pfit, pfit["data"]), pfit["fitted"])


def test_import_does_not_import_jax():
    """Importing the package and its modules imports no jax; the package
    and plotting.py import no matplotlib (the card's machine has none)."""
    code = ("import sys, multivartv_tpu_torch; "
            "assert 'matplotlib' not in sys.modules; "
            "import multivartv_tpu_torch.convert, "
            "multivartv_tpu_torch.ops.kernels, multivartv_tpu_torch.solver.cv, "
            "multivartv_tpu_torch.solver.batch, multivartv_tpu_torch.utils.logging, "
            "multivartv_tpu_torch.plotting, multivartv_tpu_torch.solver.path, "
            "multivartv_tpu_torch.utils.checkpoint, multivartv_tpu_torch.utils.metrics, "
            "multivartv_tpu_torch.utils.profiling, multivartv_tpu_torch.utils.roofline; "
            "assert 'matplotlib' not in sys.modules; "
            "assert 'jax' not in sys.modules, [m for m in sys.modules if 'jax' in m]")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_cuda_default_raises_without_cuda(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-CUDA guard cannot be observed")
    x, y = data
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mt.mvtv_one(x, y, m=(10, 10))


def test_wrapper_rejects_meta_tensors():
    meta = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.rhs_2d((meta,) * 3, (meta,) * 3, meta, meta, None, (1.0, 0.5, 0.5))


def test_chip_smoke_fails_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without CUDA, and
    in a directory that holds nothing else of the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (ROOT, tmp_path):
        if cwd is tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
