"""The port's sharded fit (multivartv_tpu_torch/parallel) against the JAX
package's, on the CPU.

The port's ranks are processes spawned with torch.multiprocessing, 2 and 4
of them on gloo with a file:// store (tests/torch_shard_ranks.py, which
imports no jax); the JAX package's sharded fit runs in this process on a
row mesh of as many virtual CPU devices (tests/conftest.py), (W, 1) for
its explicit solver and (1, W, 1) for mvtv_sharded.  Both worlds' rank
processes start together at the first test and run while the JAX side
computes.  The JAX package's sharded fit off the TPU runs its plain route
(the tolerance-driven DCT-preconditioned PCG, jnp stencils), the port its
shard route under SolverConfig(xla_packed=False) (B9s's r0, the
pencil-transposed DCT preconditioner, B8s's dual stage with the carries),
the same algorithm (the port's default x-update, the spectral CG across
ranks, is held against the JAX package's TPU x-update in
tests/test_torch_shard_spectral.py): fits are compared on
lambdas, CV MSEs, the chosen index and the objective, not theta element by
element (tests/test_torch_admm.py).  To keep the file to about half a
minute, where gloo's ~0.1-0.3 ms per collective multiplies tens of
collectives per ADMM iteration, the fits take 3 lambdas and both sides cap
each solve at 30 iterations (the same cap on both sides, so the two
trajectories stay comparable); one fit in this process (a group of one
rank) runs to convergence."""

import functools
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import torch_shard_ranks as ranks_lib
from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.parallel import fit as jfit
from multivartv_tpu.parallel import halo as jhalo
from multivartv_tpu.parallel.sharding import make_device_mesh as jmesh
from multivartv_tpu.solver import cv as jcv
from multivartv_tpu.solver.problem import build_operators as jbuild_operators
from multivartv_tpu.solver.problem import build_problem as jbuild_problem
from multivartv_tpu_torch.config import SolverConfig
from multivartv_tpu_torch.parallel import distributed, fit
from multivartv_tpu_torch.parallel.sharding import make_device_mesh
from test_admm import make_2d_problem

WORLDS = (2, 4)
CAP = 30          # iterations per solve on both sides in the spawned fits
N_LAMBDA = 3
# The fits of each world: (m, folds).
FITS = {2: [((8, 8), 1), ((8, 8), 2)], 4: [((64, 128), 1), ((64, 128), 2)]}
ADMM_M, ADMM_LAM = (16, 24), 0.08


_data = ranks_lib.fit_data


@functools.lru_cache(maxsize=None)
def _admm_inputs():
    data, y, _, spec = make_2d_problem(n=2000, m=ADMM_M)
    cfg = JSolverConfig(x_solver="jacobi_pcg", cg_fixed_iters=10, use_pallas=False)
    ops = jbuild_operators(spec.m, spec.deltas, cfg)
    problem = jbuild_problem(spec, jnp.asarray(data, jnp.float32), jnp.asarray(y, jnp.float32))
    return dict(m=ADMM_M, counts=np.asarray(problem.counts), oty=np.asarray(problem.oty),
                gram_diag=np.asarray(ops.gram_diagonal), ybar=float(problem.ybar),
                scales=tuple(float(s) for s in ops.scales), lam=ADMM_LAM,
                cfg=dict(x_solver="jacobi_pcg", cg_fixed_iters=10)), (cfg, ops, problem)


def _labels(n, folds):
    return np.asarray(jcv.kfold_indices(n, folds, 123))


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """{world: Ranks}: every world's jobs, started at the module's first
    test, so that they run while the tests before the last ones compute the
    JAX side."""
    admm_in, _ = _admm_inputs()
    out = {}
    for world in WORLDS:
        jobs = {"admm": ("sharded_admm", admm_in),
                "pieces": ("pieces", dict(m=(10, 9), seed=world))}
        tmp = tmp_path_factory.mktemp(f"world{world}")
        for m, folds in FITS[world]:
            labels = None
            if folds > 1:
                labels = str(tmp / f"labels{m[0]}x{m[1]}.npy")
                np.save(labels, _labels(len(_data(m, seed=11)[1]), folds))
            jobs[f"mvtv{m[0]}x{m[1]}f{folds}"] = ("mvtv_sharded", dict(
                m=m, seed=11, n_lambda=N_LAMBDA, folds=folds,
                cfg=dict(max_iters=CAP, xla_packed=False),
                labels_file=labels))
        out[world] = ranks_lib.Ranks(world, str(tmp), jobs)
    return out


def _penalty(theta, deltas):
    th = np.asarray(theta, np.float64)
    d0, d1 = (float(v) for v in deltas)
    return (np.abs(th[1:, 1:] - th[1:, :-1] - th[:-1, 1:] + th[:-1, :-1]).sum()
            + d0 * np.abs(th[:, 1:] - th[:, :-1]).sum() + d1 * np.abs(th[1:] - th[:-1]).sum())


def _objective(y, fitted, theta, lam, deltas):
    """0.5 ||y - O theta||^2 + lam ||D theta||_1 in float64."""
    return (0.5 * np.sum((np.asarray(y, np.float64) - fitted) ** 2)
            + lam * _penalty(theta, deltas))


def test_mvtv_sharded_one_rank_matches_jax(caplog):
    """A row group of one rank in this process (no process group, no
    collective call) runs the same shard route (its exact arm,
    xla_packed=False) to convergence: against the
    JAX package's mvtv_sharded on one device (8 x 8, 5 lambdas, 2 folds with
    JAX's labels), the same grid and chosen index, the CV MSEs within 1e-4
    and the objective within 2e-5; and the config adaptation is logged."""
    from multivartv_tpu_torch.solver import cv

    m = (8, 8)
    x, y = _data(m, seed=11)
    want = jfit.mvtv_sharded(x, y, m=m, n_lambda=5, folds=2,
                             device_mesh=jmesh((1, 1, 1), ("dp", "sx", "sy")),
                             spatial_axes=("sx", "sy"))
    labels = torch.as_tensor(_labels(len(y), 2))
    orig = cv.kfold_indices
    cv.kfold_indices = lambda n, k, seed: labels
    try:
        with caplog.at_level(logging.WARNING, logger="multivartv_tpu_torch"):
            got = fit.mvtv_sharded(x, y, m=m, n_lambda=5, folds=2, device="cpu",
                                   solver_config=SolverConfig(xla_packed=False))
    finally:
        cv.kfold_indices = orig
    assert any("adapted SolverConfig" in rec.message for rec in caplog.records)
    assert got.solver_config.tiled_shard_key is not None
    np.testing.assert_allclose(got.lambdas, want.lambdas, rtol=1e-5)
    np.testing.assert_allclose(got.cv_mses, want.cv_mses, rtol=1e-4)
    best = got.lambda_minmse_ind
    assert best == want.lambda_minmse_ind
    deltas = np.asarray(want.mesh_spec.deltas)
    a = _objective(y, got.fitted, got.theta_lattice, float(got.lambdas[best]), deltas)
    b = _objective(y, np.asarray(want.fitted), want.theta_lattice, float(want.lambdas[best]),
                   deltas)
    assert abs(a - b) <= 2e-5 * abs(b)


@pytest.mark.parametrize("entry", ["mvtv", "mvtv_sharded"])
def test_folds_merge_into_an_explicit_cv_config(entry):
    """mvtv and mvtv_sharded share one body: an explicit cv_config with a
    non-default folds runs `folds` folds in both, and mvtv_sharded runs
    them one after another whatever cv_config.vmap_folds says, on its
    slab's operators."""
    from multivartv_tpu_torch import CVConfig, api
    from multivartv_tpu_torch.solver import cv

    x, y = _data((8, 8), seed=3)
    seen = []
    orig = cv.cross_validate

    def spy(ops, problems, lambdas, cfg, pcfg, cvcfg):
        seen.append((int(problems.counts.shape[0]), cvcfg.vmap_folds, ops.slab is not None))
        return orig(ops, problems, lambdas, cfg, pcfg, cvcfg)

    cv.cross_validate = spy
    try:
        run = api.mvtv if entry == "mvtv" else fit.mvtv_sharded
        model = run(x, y, m=(8, 8), n_lambda=2, folds=2, device="cpu",
                    cv_config=CVConfig(folds=3, vmap_folds=True))
    finally:
        cv.cross_validate = orig
    sharded = entry == "mvtv_sharded"
    assert seen == [(2, not sharded, sharded)]
    assert model.cv_mses.shape == (2,) and np.all(np.isfinite(model.theta_lattice))


def test_distributed_bring_up_and_config_adaptation():
    """No process group comes up without a rendezvous; the backend follows
    the device (gloo on the CPU; NCCL, or an error, on CUDA); Jacobi PCG
    gets its 10 fixed steps, as in the JAX package; a 2-D process grid is
    refused, and p >= 4 gets the row layout (p = 1 and 3:
    tests/test_torch_shard3d.py)."""
    assert distributed.init_distributed() is False
    assert distributed.backend_for("cpu") == "gloo"
    if not torch.distributed.is_nccl_available():
        with pytest.raises(RuntimeError):
            distributed.backend_for("cuda")
    assert distributed.process_summary()["process_count"] == 1
    group, names = distributed.global_lattice_mesh(2)
    assert (group.rank, group.size, group.axis_name) == (0, 1, "sx") and names[1] == "sx"
    cfg = fit._sharded_solver_config(SolverConfig(x_solver="jacobi_pcg"))
    assert cfg.cg_fixed_iters == 10 and cfg.tiled_shard_key is not None
    assert fit._sharded_solver_config(cfg) is cfg
    with pytest.raises(ValueError):
        make_device_mesh((2, 2), ("sx", "sy"))      # four ranks asked of one
    group, names = fit.default_lattice_mesh(4)      # p >= 4 is cut too (C7)
    assert group.size == 1 and names == ("dp", "sx", "sy")


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_admm_solve_matches_jax(spawned, world):
    """The explicit solver (Jacobi PCG, every collective by hand) on a
    (W, 1) mesh, test_halo.py's problem: the same iteration count within 2
    and the objective within 1e-5 relative."""
    _, (cfg, ops, problem) = _admm_inputs()
    mesh = jmesh((world, 1), ("sx", "sy"))
    scales = tuple(float(s) for s in ops.scales)
    lam = jnp.float32(ADMM_LAM)
    want = jhalo.sharded_admm_solve(mesh, problem.counts, problem.oty, ops.gram_diagonal,
                                    float(problem.ybar), scales, lam, lam / 5.0, cfg)
    r = spawned[world].result()
    counts, oty = np.asarray(problem.counts, np.float64), np.asarray(problem.oty, np.float64)
    deltas = np.asarray(ops.deltas)

    def obj(theta):
        th = np.asarray(theta, np.float64)
        return 0.5 * np.sum(counts * th * th) - np.sum(oty * th) + ADMM_LAM * _penalty(th,
                                                                                       deltas)

    assert abs(int(r["admm/iters"]) - int(want.iters)) <= 2
    ref = obj(want.theta)
    assert abs(obj(r["admm/theta"]) - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("world,m,folds", [(w, m, f) for w in WORLDS for m, f in FITS[w]])
def test_mvtv_sharded_matches_jax(spawned, world, m, folds):
    """mvtv_sharded against the JAX package's on a (1, W, 1) mesh, each
    solve capped at CAP iterations on both sides: the lambda grid within
    1e-5 (the port's lambda_max is float64, JAX's float32), the CV MSEs
    within 1e-4, the same chosen index, and the objective at it within
    1e-5 relative."""
    x, y = _data(m, seed=11)
    want = jfit.mvtv_sharded(x, y, m=m, n_lambda=N_LAMBDA, folds=folds,
                             device_mesh=jmesh((1, world, 1), ("dp", "sx", "sy")),
                             spatial_axes=("sx", "sy"), solver_config=JSolverConfig(max_iters=CAP))
    r = {k.split("/")[1]: v for k, v in spawned[world].result().items()
         if k.startswith(f"mvtv{m[0]}x{m[1]}f{folds}/")}
    np.testing.assert_allclose(r["lambdas"], want.lambdas, rtol=1e-5)
    np.testing.assert_allclose(r["cv_mses"], want.cv_mses, rtol=1e-4)
    best = int(r["best"])
    assert best == want.lambda_minmse_ind
    deltas = np.asarray(want.mesh_spec.deltas)
    got = _objective(y, r["fitted"], r["theta"], float(r["lambdas"][best]), deltas)
    ref = _objective(y, np.asarray(want.fitted), want.theta_lattice,
                     float(want.lambdas[best]), deltas)
    assert abs(got - ref) <= 1e-5 * abs(ref)
    assert r["theta"].shape == m and int(r["key"]) >= 1


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_and_slab_kernels(spawned, world):
    """Each collective (halo rows, the global shifts, the pencil transposes,
    the gathers, the group sum) and each row-slab operation (D, D', B8s with
    and without true_m, B9s given and fused, its matvec, B11s, the shard
    route's x-update) on 10 x 9 cut unevenly over the ranks, against its
    single-process version on the whole lattice: the moves are exact, the
    kernels' plain versions agree to 1e-6 (stats 1e-5 relative: summed in
    another order), the x-update to 1e-5 within one CG step (its stopping
    test compares sums taken in another order)."""
    r = spawned[world].result()
    for k in ("halo", "shift", "pencil", "gather", "B8s", "B9s", "B11s"):
        assert r[f"pieces/{k}"] == 0.0, k
    assert r["pieces/D"] <= 1e-6
    assert r["pieces/B8s stats"] <= 1e-5
    assert r["pieces/solve_x"] <= 1e-5 and r["pieces/solve_x iterations"] <= 1
