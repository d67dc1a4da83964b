"""lambda_max, the lambda grid and the warm-started lambda path.

Counterpart of ``multivartv_tpu/solver/path.py``.  lambda_max =
lam_max_scale * ||D (D'D)^+ O'y||_inf (the reference C++ scaling,
utils.cpp:354), with the pseudo-inverse exact through the DCT
diagonalization of D'D, taken through the FFT DCT in float64 as the
reference takes it in double.  The JAX package takes it in float32, where
the mixed block's second difference of the very smooth (D'D)^+ O'y
cancels.  On bench.py's data (y ~ N(0, 1)) its dense-matrix route, used up
to 2048 per axis, lies 2.6e-4 high at 1024^2 and 67 % high at 2048^2
(9280 against 5545.51, on the CPU); the FFT route above 2048 per axis,
15 % high at 4096^2 (12480 against 10813.77, on an H100).  A CPU test
pins the 1024^2 case (tests/test_torch_spectral.py).  So the port's grid,
and every fit on it, departs from the JAX package's there (ROADMAP Queue
C).  The path solves a descending grid, warm-starting theta, u and rho
from one lambda to the next with rho_init = lambdas[0] / 5 (mbs_path,
solvers.cpp:204-222); the JAX ``lax.scan`` is a Python loop.
``solve_path_batch`` runs the same path for a batch of problems (the CV
folds) through ``admm_solve_batched``; ``solve_path_checkpointed`` solves
it in chunks that it saves and resumes (utils/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from multivartv_tpu_torch.config import PathConfig, SolverConfig
from multivartv_tpu_torch.ops import dct as dct_ops
from multivartv_tpu_torch.ops import diff as diff_ops
from multivartv_tpu_torch.ops.interp import gather_fitted, gather_fitted_batch
from multivartv_tpu_torch.solver import admm
from multivartv_tpu_torch.solver.admm import ADMMState
from multivartv_tpu_torch.solver.problem import Operators, Problem
from multivartv_tpu_torch.utils.logging import get_logger, log_progress


def lam_max(ops: Operators, problem: Problem, pcfg: PathConfig) -> torch.Tensor:
    """lambda_max in float64 (see module doc), returned in the problem's
    type: ||D (D'D)^+ O'y||_inf times lam_max_scale ("cpp") or times
    prod(deltas) ("py", code/solvers.py:116)."""
    f64 = torch.float64
    pinv_oty = dct_ops.gram_pinv_apply(problem.oty.to(f64), ops.gram_eigs.to(f64))
    tune = diff_ops.blocks_abs_max(ops.apply_D(pinv_oty))
    if pcfg.lam_max_mode == "cpp":
        lmax = pcfg.lam_max_scale * tune
    else:
        lmax = tune * torch.prod(ops.deltas.to(f64))
    return lmax.to(problem.oty.dtype)


def create_lambdas(lambda_max: torch.Tensor, pcfg: PathConfig) -> torch.Tensor:
    """Descending log grid from lambda_max to lambda_min_ratio * lambda_max
    (create_lambdas, solvers.cpp:191)."""
    lo = torch.log(lambda_max * pcfg.lambda_min_ratio)
    hi = torch.log(lambda_max)
    steps = torch.linspace(0.0, 1.0, pcfg.n_lambda, dtype=lambda_max.dtype,
                           device=lambda_max.device)
    logs = lo + (hi - lo) * steps
    if pcfg.n_lambda > 1:
        logs[-1] = hi     # the end point exactly, as jnp.linspace sets it
    # one point: jnp.linspace(lo, hi, 1) is [lo], lambda_max * lambda_min_ratio
    return torch.exp(logs).flip(0)


# store="fitted" keeps n_lambda x (ntheta + n) floats per problem on the
# device; past this many elements (1 GiB of float32) the path keeps only the
# MSEs, with a logged warning (path.py:60-85 of the JAX package).
STORE_BUDGET_ELEMS = 1 << 28


def _effective_store(ops: Operators, problem: Problem, lambdas: torch.Tensor,
                     pcfg: PathConfig, batch: int = 1) -> PathConfig:
    if pcfg.store != "fitted":
        return pcfg
    n_lambda = int(lambdas.shape[0])
    n = int(problem.y.shape[-1])
    elems = batch * n_lambda * (ops.ntheta + n)
    if elems > STORE_BUDGET_ELEMS:
        get_logger().warning(
            "store='fitted' would keep %.2f G elements (%d lambdas x (%d knots + %d samples) "
            "x batch %d); auto-degrading to store='mse'.  Pass PathConfig(store='mse') or "
            "solve fewer lambdas to silence this.", elems / 1e9, n_lambda, ops.ntheta, n, batch)
        return dataclasses.replace(pcfg, store="mse")
    return pcfg


class PathResult(NamedTuple):
    """Per-lambda outputs of a path solve (leading axis lambda; a batched
    path puts the batch axis first).  chunked_iters, exact_iters and
    escaped are the port's route split per lambda (ADMMState)."""

    lambdas: torch.Tensor
    train_mse: torch.Tensor       # MSE of fitted vs ftrue over the training samples
    test_mse: torch.Tensor        # MSE over the held-out samples (0 without a test set)
    iters: torch.Tensor           # ADMM iterations per lambda
    cg_iters: torch.Tensor        # CG steps per lambda
    thetas: Optional[torch.Tensor]    # (n_lambda, *m) if stored
    fitted: Optional[torch.Tensor]    # (n_lambda, n) if stored
    final_state: ADMMState
    chunked_iters: Optional[torch.Tensor] = None
    exact_iters: Optional[torch.Tensor] = None
    escaped: Optional[torch.Tensor] = None


def _masked_mse(fits: torch.Tensor, target: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """MSE over the trailing sample axis, over the samples where mask is 1
    (JAX's _masked_mse and, with a leading batch axis, _masked_mse_batch)."""
    if mask is None:
        return torch.mean(torch.square(fits - target), dim=-1)
    denom = torch.clamp_min(torch.sum(mask, dim=-1), 1.0)
    return torch.sum(torch.square(fits - target) * mask, dim=-1) / denom


def fitted_values(ops: Operators, theta: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """O theta, every sample's fitted value; from the row slabs of a
    sharded solve, on every rank (parallel/halo.py)."""
    if ops.slab is None:
        return gather_fitted(theta, flat_idx)
    from multivartv_tpu_torch.parallel import halo
    return halo.gather_fitted(theta, flat_idx, ops.slab)


def _reset_counters(state: ADMMState) -> ADMMState:
    """The carry into the next lambda: the warm state with its counts,
    norms (1) and eps (0) reset, so that each lambda's counts describe it.
    The tiled route's carries are dropped (JAX path.py:158-172): the next
    solve seeds them again from the refreshed alpha, not from the stale
    in-loop one."""
    if isinstance(state.counter, int):
        zero, no = 0, False
    else:
        zero = torch.zeros_like(state.counter)
        no = torch.zeros_like(state.escaped)
    one = torch.ones_like(state.primal_norm)
    return dataclasses.replace(
        state, counter=zero, cg_iters=zero, primal_norm=one, dual_norm=one,
        eps_primal=one * 0.0, eps_dual=one * 0.0, chunked_iters=zero, exact_iters=zero,
        escaped=no, dta=None, dtu=None)


def _path_result(lambdas, outs, final_state, batched: bool) -> PathResult:
    """Stack the per-lambda outputs (lambda axis second when batched)."""
    dim = 1 if batched else 0

    def stack(name, dtype=None):
        if name not in outs[0]:
            return None
        vals = [o[name] for o in outs]
        if not isinstance(vals[0], torch.Tensor):
            return torch.tensor(vals, dtype=dtype, device=lambdas.device)
        return torch.stack(vals, dim=dim)

    return PathResult(
        lambdas=lambdas, train_mse=stack("train_mse"), test_mse=stack("test_mse"),
        iters=stack("iters", torch.int64), cg_iters=stack("cg_iters", torch.int64),
        thetas=stack("theta"), fitted=stack("fitted"), final_state=final_state,
        chunked_iters=stack("chunked_iters", torch.int64),
        exact_iters=stack("exact_iters", torch.int64), escaped=stack("escaped", torch.bool))


def _step_outputs(state: ADMMState, fits, ftrue, problem: Problem, store_theta: bool) -> dict:
    train_mask = problem.train_mask
    out = dict(
        train_mse=_masked_mse(fits, ftrue, train_mask),
        test_mse=(_masked_mse(fits, problem.y, 1.0 - train_mask) if train_mask is not None
                  else torch.zeros(fits.shape[:-1], dtype=fits.dtype, device=fits.device)),
        iters=state.counter, cg_iters=state.cg_iters, chunked_iters=state.chunked_iters,
        exact_iters=state.exact_iters, escaped=state.escaped)
    if store_theta:
        out["theta"] = state.theta
        out["fitted"] = fits
    return out


def solve_path(ops: Operators, problem: Problem, lambdas: torch.Tensor, cfg: SolverConfig,
               pcfg: PathConfig, ftrue: Optional[torch.Tensor] = None,
               init_state: Optional[ADMMState] = None, progress: bool = False) -> PathResult:
    """The warm-started lambda path of one problem.  ftrue: the per-sample
    target of the train MSE (reference gen_ftrue, solvers.cpp:248-257;
    default y).  The held-out MSE (test_mse, solvers.cpp:278-288) is taken
    over the samples where train_mask is 0.  init_state: the carry to
    resume from.  progress: log a line per lambda (the reference's verbose
    counter, solvers.cpp:134)."""
    ftrue = problem.y if ftrue is None else ftrue.to(problem.y.dtype).reshape(-1)
    rho0 = lambdas[0] / 5.0
    state = admm.initial_state(ops, problem, rho0) if init_state is None else init_state
    store_theta = _effective_store(ops, problem, lambdas, pcfg).store == "fitted"
    outs = []
    for i in range(int(lambdas.shape[0])):
        state = admm.admm_solve(ops, problem, lambdas[i], state, cfg)
        if progress:
            log_progress(float(lambdas[i]), state.counter)
        fits = fitted_values(ops, state.theta, problem.flat_idx)
        outs.append(_step_outputs(state, fits, ftrue, problem, store_theta))
        state = _reset_counters(state)
        if not pcfg.warm_start:
            state = admm.initial_state(ops, problem, rho0)
    return _path_result(lambdas, outs, state, batched=False)


def solve_path_batch(ops: Operators, problems: Problem, lambdas: torch.Tensor,
                     cfg: SolverConfig, pcfg: PathConfig,
                     ftrue: Optional[torch.Tensor] = None) -> PathResult:
    """The warm-started path for a batch of B problems at once (the CV
    folds; mbs_impl's fold loop, solvers.cpp:336-353) through
    admm_solve_batched: B5 on the kernel route, each element on the exact
    route otherwise, freezing each element at its own convergence.  Every
    field carries the batch axis first: (B, n_lambda, ...)."""
    batch = int(problems.counts.shape[0])
    ftrue_b = (problems.y if ftrue is None
               else torch.broadcast_to(ftrue.to(problems.y.dtype).reshape(1, -1),
                                       problems.y.shape))
    rho0 = (lambdas[0] / 5.0).expand(batch)
    state0 = admm.initial_state_batched(ops, problems, rho0)
    store_theta = _effective_store(ops, problems, lambdas, pcfg, batch=batch).store == "fitted"
    state, outs = state0, []
    for i in range(int(lambdas.shape[0])):
        state = admm.admm_solve_batched(ops, problems, lambdas[i].expand(batch), state, cfg)
        fits = gather_fitted_batch(state.theta, problems.flat_idx)
        outs.append(_step_outputs(state, fits, ftrue_b, problems, store_theta))
        state = state0 if not pcfg.warm_start else _reset_counters(state)
    return _path_result(lambdas, outs, state, batched=True)


_PATH_RES_FIELDS = ("train_mse", "test_mse", "iters", "cg_iters", "thetas", "fitted")


def solve_path_checkpointed(ops: Operators, problem: Problem, lambdas: torch.Tensor,
                            cfg: SolverConfig, pcfg: PathConfig, checkpoint_dir: str,
                            checkpoint_every: int = 10,
                            ftrue: Optional[torch.Tensor] = None) -> PathResult:
    """The lambda path in chunks of checkpoint_every lambdas, resumable
    (JAX path.py:287-360): after each chunk its per-lambda results and the
    warm-start carry are saved to checkpoint_dir (utils/checkpoint.py, the
    JAX package's format); a directory that holds a carry resumes after its
    lambda and returns the whole path, the saved chunks' results merged
    with the new ones.  A checkpoint that covers every lambda returns the
    saved path without solving.  Where the chunks' results were not saved
    (an older directory), the result covers only the lambdas solved now,
    with a logged warning; if that leaves none, ValueError.  The result's
    final_state is the carry after the last lambda; its route split
    (chunked_iters, exact_iters, escaped) is None, as the saved chunks do
    not hold it."""
    from multivartv_tpu_torch.utils import checkpoint as ckpt

    lambdas = torch.as_tensor(lambdas).reshape(-1)
    n = int(lambdas.shape[0])
    state = admm.initial_state(ops, problem, lambdas[0] / 5.0)
    start = 0
    restored = ckpt.load_path_state(checkpoint_dir, state)
    if restored is not None:
        state, done_idx = restored
        start = done_idx + 1

    prior = ckpt.load_path_results(checkpoint_dir, start)
    dev = lambdas.device
    pieces = [] if prior is None else [
        {k: torch.as_tensor(v, device=dev) for k, v in chunk.items()} for chunk in prior]
    result_start = start if prior is None else 0
    if prior is None and start > 0:
        get_logger().warning(
            "checkpoint at %s holds no saved chunk results; the result covers only the "
            "remaining %d lambdas", checkpoint_dir, n - start)

    i = start
    while i < n:
        j = min(i + checkpoint_every, n)
        res = solve_path(ops, problem, lambdas[i:j], cfg, pcfg, ftrue=ftrue, init_state=state)
        state = res.final_state
        fields = {f: getattr(res, f) for f in _PATH_RES_FIELDS}
        ckpt.save_path_results(checkpoint_dir, i, j, fields)
        ckpt.save_path_state(checkpoint_dir, state, j - 1, meta={"n_lambda": n})
        pieces.append(fields)
        i = j

    if not pieces:
        raise ValueError(f"the checkpoint already covers all {n} lambdas but holds no saved "
                         f"results; delete {checkpoint_dir} to solve the path again")

    def cat(field):
        vals = [p.get(field) for p in pieces]
        if any(v is None for v in vals):
            return None
        return torch.cat(vals, dim=0)

    return PathResult(
        lambdas=lambdas[result_start:], train_mse=cat("train_mse"), test_mse=cat("test_mse"),
        iters=cat("iters"), cg_iters=cat("cg_iters"), thetas=cat("thetas"),
        fitted=cat("fitted"), final_state=state)
