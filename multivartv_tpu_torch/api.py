"""User-facing entry points: the cross-validated fit, the single-lambda
fit, the model object and prediction.

Counterpart of ``multivartv_tpu/api.py``: ``mvtv`` (the reference's
mvtv.default over the C++ CV routine mbs_impl, solvers.cpp:305-376) returns
an ``MVTVModel``; ``mvtv_one`` (reference mbs_one, code/solvers.py:15-78)
returns a dict; ``predict_mvtv`` takes either.  Output fields use the
reference's names and its axis-0-fastest flat layout.

Every entry point takes an explicit ``device``.  The default is "cuda", and
it raises when CUDA is absent: the port never moves a fit to the CPU on its
own.  Pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from multivartv_tpu_torch import mesh as mesh_lib
from multivartv_tpu_torch.config import (DEFAULT_MESH, DEFAULT_PATH, DEFAULT_SOLVER, CVConfig,
                                         MeshConfig, PathConfig, SolverConfig)
from multivartv_tpu_torch.mesh import MeshSpec
from multivartv_tpu_torch.ops import interp as interp_ops
from multivartv_tpu_torch.solver import admm
from multivartv_tpu_torch.solver import cv as cv_lib
from multivartv_tpu_torch.solver import path as path_lib
from multivartv_tpu_torch.solver.problem import build_operators, build_problem


@dataclasses.dataclass
class MVTVModel:
    """A fitted model.  Field names follow the reference output list
    (solvers.cpp:368-373 and MultivarTV.R:51-58); arrays are on the host,
    mesh_spec on the fit's device."""

    data: np.ndarray
    y: np.ndarray
    m: tuple
    mesh: np.ndarray              # (ntheta, p) knot coordinates, reference order
    theta_hat: np.ndarray         # (ntheta,) reference (axis-0-fastest) order
    theta_lattice: np.ndarray     # the p-dim lattice
    fitted: np.ndarray            # (n,) fitted values at the best lambda
    residuals: np.ndarray         # y - fitted
    lambdas: np.ndarray           # (n_lambda,) descending
    models: List[dict]            # per lambda {lambda, mse, iters[, theta_hat, fitted]}
    lambda_minmse_ind: int        # 0-based index into lambdas
    lambda_minmse: float
    lambda_1se: float
    cv_mses: np.ndarray           # (n_lambda,) mean CV MSE (the path MSE when folds = 1)
    mesh_spec: MeshSpec = dataclasses.field(repr=False, default=None)
    solver_config: SolverConfig = dataclasses.field(repr=False, default=DEFAULT_SOLVER)

    def predict(self, data=None, mesh=None) -> np.ndarray:
        """Fitted values of new data (predict.mvtv, MultivarTV.R:172-175;
        mbspredict, MultivarTV.cpp:55-71); data=None returns the stored
        fitted values.  mesh: an explicit (ntheta, p) knot-point matrix whose
        rows index theta_hat (the reference's mesh argument,
        MultivarTV.cpp:61-66), searched by brute force for each point's
        nearest row."""
        if data is None:
            return self.fitted
        dev = self.mesh_spec.deltas.device
        data_t = torch.as_tensor(_as_2d(data), dtype=torch.float32, device=dev)
        if mesh is not None:
            pts = torch.as_tensor(_as_2d(mesh), dtype=torch.float32, device=dev)
            idx = interp_ops.nearest_pointcloud_indices(data_t, pts)
            theta_hat = torch.as_tensor(self.theta_hat, dtype=torch.float32, device=dev)
            return theta_hat[idx].cpu().numpy()
        theta = torch.as_tensor(self.theta_lattice, dtype=torch.float32, device=dev)
        idx = interp_ops.flat_knot_indices(self.mesh_spec, data_t)
        return interp_ops.gather_fitted(theta, idx).cpu().numpy()

    def plot(self, **kwargs):
        """plotting.plot_model (needs matplotlib)."""
        from multivartv_tpu_torch import plotting
        return plotting.plot_model(self, **kwargs)

    def plot_residuals(self, **kwargs):
        """plotting.plot_residuals (needs matplotlib)."""
        from multivartv_tpu_torch import plotting
        return plotting.plot_residuals(self, **kwargs)


def resolve_device(device) -> torch.device:
    """torch.device(device); a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} was asked for but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def _default_m(n: int, p: int) -> tuple:
    """floor(sqrt(N)) knots per axis (mvtv.default, MultivarTV.R:44-48)."""
    return tuple([int(np.floor(np.sqrt(n)))] * p)


def _as_2d(data) -> np.ndarray:
    data = np.asarray(data, np.float64)
    return data[:, None] if data.ndim == 1 else data


def _resolve_mesh(data: np.ndarray, m, mesh_cfg: MeshConfig, device, mesh=None):
    """The fit's mesh.  Without mesh=: a regular lattice over the eps-padded
    data range, built on the host in float64 and cast to float32
    (create_mesh / create_deltas, utils.cpp:234-263; MeshConfig.delta_mode).
    A user's mesh= is a lattice (regular or not) where
    mesh.mesh_spec_from_points accepts it, else a point cloud whose deltas
    come from the data ranges (gen_mesh's pass-through, solvers.cpp:233-244;
    create_deltas)."""
    n, p = data.shape
    m = _default_m(n, p) if m is None else tuple(int(v) for v in np.ravel(m))
    if len(m) != p:
        raise ValueError(f"m has {len(m)} entries but data has {p} columns")
    eps = mesh_cfg.eps

    def cell(j, rng):
        return rng / m[j] if mesh_cfg.delta_mode == "cpp" else rng / max(m[j] - 1, 1)

    if mesh is not None:
        try:
            return mesh_lib.mesh_spec_from_points(mesh, m, device=device)
        except ValueError:
            deltas = [cell(j, data[:, j].max() - data[:, j].min() + 2 * eps) for j in range(p)]
            return mesh_lib.PointCloudMeshSpec(
                points=torch.as_tensor(np.asarray(mesh), dtype=torch.float32, device=device),
                deltas=torch.as_tensor(deltas, dtype=torch.float32, device=device), m=m)
    knots, deltas = [], []
    for j in range(p):
        lo, hi = data[:, j].min() - eps, data[:, j].max() + eps
        knots.append(torch.as_tensor(np.linspace(lo, hi, m[j]), dtype=torch.float32,
                                     device=device))
        deltas.append(cell(j, hi - lo))
    return MeshSpec(knots=tuple(knots),
                    deltas=torch.as_tensor(deltas, dtype=torch.float32, device=device), m=m)


def _mesh_points_np(spec) -> np.ndarray:
    """The (ntheta, p) knot coordinates of a fit, reference order: the
    user's points on a point cloud, else the lattice's."""
    if isinstance(spec, mesh_lib.PointCloudMeshSpec):
        return spec.points.cpu().numpy()
    return mesh_lib.lattice_points(spec.knots, spec.m).cpu().numpy()


def _setup(data, y, m, mesh, solver_config: SolverConfig, mesh_config: MeshConfig, device):
    """(data, y as float64 host arrays, mesh spec, data, y on the device,
    operators, problem): the binning and operator build of a fit."""
    dev = resolve_device(device)
    data_np = _as_2d(data)
    y_np = np.asarray(y, np.float64).reshape(-1)
    spec = _resolve_mesh(data_np, m, mesh_config, dev, mesh)
    data_t = torch.as_tensor(data_np, dtype=torch.float32, device=dev)
    y_t = torch.as_tensor(y_np, dtype=torch.float32, device=dev)
    ops = build_operators(spec.m, spec.deltas, solver_config, dev)
    return data_np, y_np, spec, data_t, y_t, ops, build_problem(spec, data_t, y_t)


def _fresh_solve(ops, problem, lam, rho0, cfg: SolverConfig):
    """A cold solve at one lambda from the path's initial state
    (mbs_fit_optimal, solvers.cpp:261-274): (theta, fitted)."""
    state = admm.initial_state(ops, problem, rho0)
    state = admm.admm_solve(ops, problem, lam, state, cfg)
    return state.theta, path_lib.fitted_values(ops, state.theta, problem.flat_idx)


def mvtv(data, y, m=None, mesh=None, n_lambda: int = 100, ftrue=None, lambdas=None,
         folds: int = 5, verbose: bool = False, solver_config: SolverConfig = DEFAULT_SOLVER,
         path_config: Optional[PathConfig] = None, cv_config: Optional[CVConfig] = None,
         mesh_config: MeshConfig = DEFAULT_MESH, device="cuda") -> MVTVModel:
    """Cross-validated multivariate TV denoising (mbs_impl,
    solvers.cpp:305-376): build the mesh and operators once, the lambda
    grid from the full data, the warm-started path of every fold (one batch,
    B5 on the card), the lambda of least mean held-out MSE, then the path on
    the full data.  folds = 1: the full-data path alone, its MSE against y,
    and a fresh solve at the best lambda (solvers.cpp:328-335)."""
    path_config, cv_config = _fit_configs(n_lambda, folds, path_config, cv_config)
    data_np, y_np, spec, data_t, y_t, ops, problem = _setup(data, y, m, mesh, solver_config,
                                                            mesh_config, device)
    grid, path_config = _lambda_grid(ops, problem, lambdas, path_config, verbose)
    return _cross_validated_fit((data_np, y_np, spec, data_t, y_t), ops, problem, grid, WHOLE,
                                ftrue, verbose, solver_config, path_config, cv_config)


def _fit_configs(n_lambda: int, folds: int, path_config: Optional[PathConfig],
                 cv_config: Optional[CVConfig]):
    """(PathConfig, CVConfig) of a fit: the given configs, with n_lambda
    and folds merged in where they differ from their defaults."""
    if path_config is None:
        path_config = PathConfig(n_lambda=n_lambda)
    elif path_config.n_lambda != n_lambda and n_lambda != 100:
        path_config = dataclasses.replace(path_config, n_lambda=n_lambda)
    if cv_config is None:
        cv_config = CVConfig(folds=folds)
    elif cv_config.folds != folds and folds != 5:
        cv_config = dataclasses.replace(cv_config, folds=folds)
    return path_config, cv_config


def _same(x):
    return x


def _mean_mse(res: cv_lib.CVResult) -> torch.Tensor:
    return res.mean_mse


def _as_computed(final_path, best_theta, best_fitted):
    return final_path, best_theta, best_fitted


class LatticeCut(NamedTuple):
    """How a fit lays its lattice and its CV folds over processes once its
    lambda grid is set: the problem of its own part (each CV fold's, as it
    is built); a lattice array whole from its part, a leading lambda axis
    kept (parallel/fit.py gathers it to the host one lambda at a time); the
    folds this process solves, of k; the CV curve (n_lambda,) from the
    CVResult of those folds (parallel/fit.py gathers every fold's held-out
    MSEs over the fold axis before the mean); and the final path and refit
    that this process returns, from the (final path, best theta, best
    fitted) it computed (parallel/fit.py takes the first replica's over the
    fold axis, where every row group computes them)."""
    problem: Callable
    gather: Callable
    folds: Callable = range
    cv_mean: Callable = _mean_mse
    replica: Callable = _as_computed


WHOLE = LatticeCut(_same, _same)


def _lambda_grid(ops, problem, lambdas, path_config: PathConfig, verbose: bool,
                 share: Callable = _same):
    """(grid, path_config): lambda_max (float64) and the descending grid from
    the whole problem, or the given lambdas with n_lambda set to their
    number.  share: how every process gets the same grid (parallel/fit.py
    broadcasts rank 0's)."""
    if lambdas is None:
        lmax = path_lib.lam_max(ops, problem, path_config)
        grid = share(path_lib.create_lambdas(lmax, path_config))
        if verbose:
            print(f"Lambda_max = {float(lmax):.6g}")
        return grid, path_config
    grid = torch.as_tensor(np.asarray(lambdas, np.float64), dtype=torch.float32,
                           device=problem.y.device).reshape(-1)
    return grid, dataclasses.replace(path_config, n_lambda=int(grid.shape[0]))


def _cross_validated_fit(samples, ops, problem, grid, cut: LatticeCut, ftrue, verbose: bool,
                         solver_config: SolverConfig, path_config: PathConfig,
                         cv_config: CVConfig) -> MVTVModel:
    """mvtv's body once the grid is set (_lambda_grid): the path, the folds
    and the refit on ops and problem, the whole lattice's or one part's
    (parallel/fit.py cuts them into slabs; the folds then run one after
    another, cv_config.vmap_folds False, each fold's problem cut as it is
    built, and on a mesh with a fold axis each row group solves its block
    of folds, cut.folds).  samples: _setup's (data, y as float64 host
    arrays, mesh spec, data, y on the device)."""
    data_np, y_np, spec, data_t, y_t = samples
    ftrue_t = (y_t if ftrue is None
               else torch.as_tensor(np.asarray(ftrue, np.float64), dtype=torch.float32,
                                    device=y_t.device).reshape(-1))
    folds = cv_config.folds
    best_theta = None

    if folds == 1:
        final_path = path_lib.solve_path(ops, problem, grid, solver_config, path_config,
                                         ftrue=ftrue_t, progress=verbose)
        cv_mses = _per_lambda_mse_vs_y(final_path, problem).cpu().numpy()
        best = int(np.argmin(cv_mses))
        best_theta, best_fitted = _fresh_solve(ops, problem, grid[best], grid[0] / 5.0,
                                               solver_config)
    else:
        labels = cv_lib.kfold_indices(y_np.shape[0], folds, cv_config.seed)
        problems = cv_lib.fold_problems(spec, data_t, y_t, labels, folds, fold_map=cut.problem,
                                        fold_ids=cut.folds(folds))
        res = cv_lib.cross_validate(ops, problems, grid, solver_config, path_config, cv_config)
        del problems
        cv_mses = cut.cv_mean(res).cpu().numpy()
        best = int(np.argmin(cv_mses))
        final_path = path_lib.solve_path(ops, problem, grid, solver_config, path_config,
                                         ftrue=ftrue_t, progress=verbose)
        if final_path.thetas is not None:
            best_fitted = final_path.fitted[best]
        else:
            best_theta, best_fitted = _fresh_solve(ops, problem, grid[best], grid[0] / 5.0,
                                                   solver_config)
    final_path, best_theta, best_fitted = cut.replica(final_path, best_theta, best_fitted)
    if verbose:
        print(f"Best lambda = {float(grid[best]):.6g}")
    if final_path.thetas is not None:
        final_path = final_path._replace(thetas=cut.gather(final_path.thetas))
    best_theta = final_path.thetas[best] if best_theta is None else cut.gather(best_theta)
    return _assemble_model(data_np, y_np, spec, final_path, grid, best, best_theta,
                           best_fitted, cv_mses, solver_config)


def _per_lambda_mse_vs_y(path_res: path_lib.PathResult, problem) -> torch.Tensor:
    if path_res.fitted is not None:
        return torch.mean(torch.square(path_res.fitted - problem.y[None, :]), dim=1)
    return path_res.train_mse


def _assemble_model(data_np, y_np, spec, final_path, lambda_grid, best_ind, best_theta,
                    best_fitted, cv_mses, solver_config) -> MVTVModel:
    fitted = best_fitted.cpu().numpy()
    lambdas_np = lambda_grid.cpu().numpy()
    n_lambda = lambdas_np.shape[0]
    path_mses = final_path.train_mse.cpu().numpy()
    path_iters = final_path.iters.cpu().numpy()
    path_thetas = (None if final_path.thetas is None
                   else torch.stack([mesh_lib.flatten_ref_order(t)
                                     for t in final_path.thetas]).cpu().numpy())
    path_fitted = None if final_path.fitted is None else final_path.fitted.cpu().numpy()
    models = []
    for i in range(n_lambda):
        entry = {"lambda": float(lambdas_np[i]), "mse": float(path_mses[i]),
                 "iters": int(path_iters[i])}
        if path_thetas is not None:
            entry["theta_hat"] = path_thetas[i]
            entry["fitted"] = path_fitted[i]
        models.append(entry)
    # lambda.1se (mvtv.default, MultivarTV.R:55-58): the sd of the CV curve
    # over sqrt(n_lambda); the LAST candidate with cv <= min + se wins (the
    # smallest lambda of the descending grid, as the reference picks it).
    se1 = float(np.std(cv_mses, ddof=1) / np.sqrt(n_lambda)) if n_lambda > 1 else 0.0
    cands = np.nonzero(cv_mses <= cv_mses[best_ind] + se1)[0]
    lambda_1se = float(lambdas_np[cands[-1]]) if cands.size else float(lambdas_np[best_ind])
    return MVTVModel(
        data=data_np, y=y_np, m=spec.m,
        mesh=_mesh_points_np(spec),
        theta_hat=mesh_lib.flatten_ref_order(best_theta).cpu().numpy(),
        theta_lattice=best_theta.cpu().numpy(), fitted=fitted, residuals=y_np - fitted,
        lambdas=lambdas_np, models=models, lambda_minmse_ind=best_ind,
        lambda_minmse=float(lambdas_np[best_ind]), lambda_1se=lambda_1se, cv_mses=cv_mses,
        mesh_spec=spec, solver_config=solver_config)


def mvtv_one(data, y, m=None, mesh=None, lam: Optional[float] = None,
             solver_config: SolverConfig = DEFAULT_SOLVER,
             path_config: PathConfig = DEFAULT_PATH,
             mesh_config: MeshConfig = DEFAULT_MESH, device="cuda") -> dict:
    """Single-lambda fit.  With lam=None, lambda = lambda_max (theta then
    collapses to mean(y), as in the reference).  Returns {mesh, mesh_spec,
    theta_hat, theta_lattice, fitted, counter, lambda, m, y, data,
    diagnostics}, host arrays except mesh_spec."""
    data_np, y_np, spec, _, y_t, ops, problem = _setup(
        data, y, m, mesh, solver_config, mesh_config, device)
    dev = y_t.device
    if lam is None:
        lam_t = path_lib.lam_max(ops, problem, path_config)
    else:
        lam_t = torch.tensor(float(lam), dtype=torch.float32, device=dev)
    state = admm.initial_state(ops, problem, lam_t)
    state = admm.admm_solve(ops, problem, lam_t, state, solver_config)
    fitted = interp_ops.gather_fitted(state.theta, problem.flat_idx)
    return {
        "mesh": _mesh_points_np(spec),
        "mesh_spec": spec,
        "theta_hat": mesh_lib.flatten_ref_order(state.theta).cpu().numpy(),
        "theta_lattice": state.theta.cpu().numpy(),
        "fitted": fitted.cpu().numpy(),
        "counter": int(state.counter),
        "lambda": float(lam_t),
        "m": spec.m,
        "y": y_np,
        "data": data_np,
        "diagnostics": admm.solver_diagnostics(state),
    }


def predict_mvtv(model, data=None) -> np.ndarray:
    """Fitted values of new data for an ``MVTVModel`` or an ``mvtv_one``
    result (predict_mvtv, MultivarTV.cpp:54-71), on the device of the fit's
    mesh."""
    if isinstance(model, MVTVModel):
        return model.predict(data)
    if data is None:
        return model["fitted"]
    spec = model["mesh_spec"]
    dev = spec.deltas.device
    theta = torch.as_tensor(model["theta_lattice"], dtype=torch.float32, device=dev)
    data_t = torch.as_tensor(_as_2d(data), dtype=torch.float32, device=dev)
    idx = interp_ops.flat_knot_indices(spec, data_t)
    return interp_ops.gather_fitted(theta, idx).cpu().numpy()
