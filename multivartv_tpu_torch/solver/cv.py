"""K-fold cross-validation as one batched path solve.

Counterpart of ``multivartv_tpu/solver/cv.py``.  The reference loops the
folds one after another, rebuilding its sparse operators on each training
split (mbs_impl, rcpp-code .../solvers.cpp:336-353).  Matrix-free, a fold
is a 0/1 sample mask: its counts, O'y and ybar are masked scatter-adds, and
all folds solve at once as a leading batch axis (solve_path_batch, B5 on
the card).

Fold labels are shuffled (i mod k) as in kfoldinds (utils.cpp:367-376).
The JAX package shuffles with ``jax.random.permutation``, which torch
cannot reproduce; the port shuffles with numpy's RandomState seeded from
CVConfig.seed, so the two packages put samples in other folds for the same
seed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from multivartv_tpu_torch.config import CVConfig, PathConfig, SolverConfig
from multivartv_tpu_torch.mesh import MeshSpec
from multivartv_tpu_torch.solver import path as path_lib
from multivartv_tpu_torch.solver.problem import (Operators, Problem, build_problem,
                                                 problem_at, stack_problems)


def kfold_indices(n: int, k: int, seed: int) -> torch.Tensor:
    """Shuffled (i mod k) fold labels, int64 (n,) on the CPU."""
    labels = np.arange(n, dtype=np.int64) % k
    return torch.as_tensor(np.random.RandomState(seed).permutation(labels))


class CVResult(NamedTuple):
    fold_test_mse: torch.Tensor   # (folds, n_lambda) held-out MSE
    mean_mse: torch.Tensor        # (n_lambda,) mean over the folds
    fold_iters: torch.Tensor      # (folds, n_lambda) ADMM iterations


def fold_problems(spec: MeshSpec, data: torch.Tensor, y: torch.Tensor,
                  fold_labels: torch.Tensor, folds: int,
                  fold_map: Optional[Callable[[Problem], Problem]] = None,
                  fold_ids: Optional[Sequence[int]] = None) -> Problem:
    """A fold-batched Problem (leading axis fold): fold f trains on the
    samples whose label is not f.  fold_map: applied to each fold's problem
    as it is built, before the next one is (parallel/fit.py cuts it into
    this rank's slab, so that one whole fold problem exists at a time).
    fold_ids: the folds to build, in order (None: all `folds`;
    parallel/fit.py builds a row group's block of the fold axis)."""
    labels = fold_labels.to(y.device)
    keep = (lambda pr: pr) if fold_map is None else fold_map
    ids = range(folds) if fold_ids is None else fold_ids
    return stack_problems([keep(build_problem(spec, data, y,
                                              train_mask=(labels != f).to(y.dtype)))
                           for f in ids])


def cross_validate(ops: Operators, problems: Problem, lambdas: torch.Tensor,
                   cfg: SolverConfig, pcfg: PathConfig, cvcfg: CVConfig) -> CVResult:
    """The warm-started path of every fold and its held-out MSE per lambda
    (test_mse, solvers.cpp:278-288), computed inside the path, so the fold
    paths store no theta: all folds in one batched path, or with
    vmap_folds=False one after another (the sharded fit's folds, each on
    this rank's slab)."""
    mse_only = dataclasses.replace(pcfg, store="mse")
    if cvcfg.vmap_folds:
        res = path_lib.solve_path_batch(ops, problems, lambdas, cfg, mse_only)
        test_mse, iters = res.test_mse, res.iters
    else:
        p = len(ops.m)
        outs = [path_lib.solve_path(ops, problem_at(problems, f, p), lambdas, cfg, mse_only)
                for f in range(int(problems.counts.shape[0]))]
        test_mse = torch.stack([o.test_mse for o in outs])
        iters = torch.stack([o.iters for o in outs])
    return CVResult(fold_test_mse=test_mse, mean_mse=torch.mean(test_mse, dim=0),
                    fold_iters=iters)
