"""Rank processes of the sharded-fit tests (tests/test_torch_sharded_fit.py).

Each rank runs in a process of its own, spawned with torch.multiprocessing,
on gloo over the CPU; rank 0 saves the results for the test to read.  This
module imports no jax, so a spawned rank never loads it: the JAX side of
each comparison runs in the test's own process."""

import os

import numpy as np
import torch

JOIN_TIMEOUT = 120.0


def _sharded_admm(m, counts, oty, gram_diag, ybar, scales, lam, cfg):
    from multivartv_tpu_torch.config import SolverConfig
    from multivartv_tpu_torch.parallel import halo
    from multivartv_tpu_torch.parallel.sharding import make_device_mesh

    t = torch.as_tensor
    res = halo.sharded_admm_solve(make_device_mesh(), t(counts), t(oty), t(gram_diag), ybar,
                                  scales, lam, lam / 5.0, SolverConfig(**cfg))
    return {"theta": res.theta.numpy(), "iters": np.asarray(res.iters)}


def fit_data(m, seed):
    """The fits' data: test_sharded_fit.py's step surface at 8 x 8, about 3
    samples per knot of a smooth surface otherwise (a smooth volume at
    p = 3; at p = 1 a step plus a sine at sorted x, the fused lasso's)."""
    rng = np.random.RandomState(seed)
    if len(m) == 3:
        n = 3 * int(np.prod(m))
        x = rng.uniform(0, 1, (n, 3))
        return x, np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + x[:, 2] + 0.2 * rng.randn(n)
    if len(m) == 1:
        n = 3 * m[0]
        x = np.sort(rng.uniform(0, 1, n))
        return x, (x > 0.5) + 0.5 * np.sin(4 * np.pi * x) + 0.3 * rng.randn(n)
    if tuple(m) == (8, 8):
        x = rng.uniform(0, 1, (240, 2))
        f = (x[:, 0] > 0.5).astype(float) - (x[:, 1] > 0.4).astype(float)
        return x, f + rng.randn(240) * 0.2
    n = 3 * m[0] * m[1]
    x = rng.uniform(0, 1, (n, 2))
    return x, np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.2 * rng.randn(n)


def _mvtv_sharded(m, seed, n_lambda, folds, cfg, labels_file=None):
    from multivartv_tpu_torch.config import SolverConfig
    from multivartv_tpu_torch.parallel.fit import mvtv_sharded
    from multivartv_tpu_torch.solver import cv

    x, y = fit_data(m, seed)
    if labels_file is not None:     # the JAX package's fold labels
        labels = torch.as_tensor(np.load(labels_file))
        cv.kfold_indices = lambda n, k, seed: labels
    model = mvtv_sharded(x, y, m=m, n_lambda=n_lambda, folds=folds,
                         solver_config=SolverConfig(**cfg), device="cpu")
    return {"lambdas": model.lambdas, "cv_mses": model.cv_mses,
            "best": np.asarray(model.lambda_minmse_ind), "theta": model.theta_lattice,
            "fitted": model.fitted, "key": np.asarray(model.solver_config.tiled_shard_key)}


def _whole_lattice_census(m, seed, n_lambda, folds, cfg, store):
    """mvtv_sharded with a census as every ADMM solve (each fold's, the full
    path's, the refit's) starts, before its first iteration: the live torch
    tensors whose trailing shape is the whole lattice's, counted after a gc
    pass (utils.profiling.solve_census).  Each rank's largest count and
    number of solves, summed over the ranks; the model's lambdas, CV MSEs
    and theta."""
    import torch.distributed as dist
    from multivartv_tpu_torch.config import PathConfig, SolverConfig
    from multivartv_tpu_torch.parallel.fit import mvtv_sharded
    from multivartv_tpu_torch.utils.profiling import solve_census

    x, y = fit_data(m, seed)
    with solve_census(m) as (seen, _):
        model = mvtv_sharded(x, y, m=m, n_lambda=n_lambda, folds=folds,
                             solver_config=SolverConfig(**cfg),
                             path_config=PathConfig(n_lambda=n_lambda, store=store),
                             device="cpu")
    totals = torch.tensor([max(n for n, _ in seen), len(seen)], dtype=torch.int64)
    dist.all_reduce(totals)
    return {"whole": totals[0].numpy(), "solves": totals[1].numpy(),
            "lambdas": model.lambdas, "cv_mses": model.cv_mses, "theta": model.theta_lattice,
            "path_theta": np.stack([e["theta_hat"] for e in model.models])
            if "theta_hat" in model.models[0] else np.zeros(0)}


def _pieces(m, seed):
    """Each collective and row-slab operation against its single-process
    version on the whole lattice (every rank holds it): the largest
    absolute errors, and the Boyd sums' relative one."""
    from multivartv_tpu_torch.config import SolverConfig
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.parallel import halo, tiled_shard
    from multivartv_tpu_torch.parallel.fit import shard_operators
    from multivartv_tpu_torch.parallel.sharding import RowSlab, make_device_mesh
    from multivartv_tpu_torch.solver import xupdate
    from multivartv_tpu_torch.solver.problem import build_operators

    rng = np.random.RandomState(seed)
    slab = RowSlab(make_device_mesh(), m)
    grp = slab.group

    def lat():
        return torch.as_tensor(rng.randn(*m).astype(np.float32))

    cfg = SolverConfig()
    ops = build_operators(m, np.asarray([0.4, 0.9], np.float32), cfg, "cpu", with_padded=False)
    ops_s = shard_operators(ops, slab)
    theta, v, oty, dta, dtu = lat(), lat(), lat(), lat(), lat()
    u = tuple(w * (z != 0) for w, z in zip((lat(), lat(), lat()), ops.apply_D(lat())))
    alpha = tuple(w * (z != 0) for w, z in zip((lat(), lat(), lat()), ops.apply_D(lat())))
    counts = torch.as_tensor(rng.poisson(2, m).astype(np.float32))
    rho, kappa, us = torch.tensor(0.3), torch.tensor(0.05), torch.tensor(0.5)
    rows, cols = slab.rows, slab.cols
    err = {}

    def note(name, got, want):
        err[name] = max(err.get(name, 0.0), float((got - want).abs().max()))

    tops, bots = halo.halo_rows(grp, [rows(theta), rows(v)])
    lo, hi = slab.row_off, slab.row_off + slab.shape[0]
    for t, b, x in zip(tops, bots, (theta, v)):
        note("halo", t[0], x[lo - 1] if lo > 0 else torch.zeros(m[1]))
        note("halo", b[0], x[hi] if hi < m[0] else torch.zeros(m[1]))
    note("shift", halo.dist_shift_down(rows(v), grp), rows(torch.roll(v, -1, 0)))
    note("shift", halo.dist_shift_up(rows(v), grp), rows(torch.roll(v, 1, 0)))
    note("pencil", halo.rows_to_cols(rows(v), slab), cols(v))
    note("pencil", halo.cols_to_rows(cols(v), slab), rows(v))
    note("gather", halo.gather_rows(rows(v), slab), v)
    idx = torch.as_tensor(rng.randint(0, m[0] * m[1], 50))
    note("gather", halo.gather_fitted(rows(v), idx, slab), v.reshape(-1)[idx])
    for a, b in zip(ops_s.apply_D(rows(theta)), ops.apply_D(theta)):
        note("D", a, rows(b))
    note("D", ops_s.apply_Dt(tuple(map(rows, alpha))), rows(ops.apply_Dt(alpha)))
    note("D", ops_s.total(rows(v)), torch.sum(v))

    for tm in (None, (m[0] - 1, m[1] - 2)):
        got = tiled_shard.dual_update_tiled_2d_sharded(
            slab, rows(theta), tuple(map(rows, u)), kappa, ops.scales, us, tm, True, True)
        want = K.dual_update_tiled_2d_reference(theta, u, kappa, ops.scales, us, tm, True, True)
        for g, w in zip((*got[0], *got[1], *got[3:]), (*want[0], *want[1], *want[3:])):
            note("B8s", g, rows(w))
        err["B8s stats"] = max(err.get("B8s stats", 0.0),
                               float(((got[2] - want[2]).abs() / want[2].abs()).max()))
    b = oty + rho * (dta + us * dtu)
    for parts in (None, (rows(oty), rows(dta), us, rows(dtu))):
        got = tiled_shard.gram_residual_tiled_2d_sharded(slab, rows(b), rows(v), rows(counts),
                                                         rho, ops.scales, rhs_parts=parts)
        note("B9s", got, rows(K.gram_residual_tiled_2d_reference(b, v, counts, rho, ops.scales)))
    note("B9s", tiled_shard.gram_matvec_tiled_2d_sharded(slab, rows(v), rows(counts), rho,
                                                         ops.scales),
         rows(K.gram_matvec_tiled_2d_reference(v, counts, rho, ops.scales)))
    note("B11s", tiled_shard.rhs_tiled_2d_sharded(slab, tuple(map(rows, alpha)),
                                                  tuple(map(rows, u)), rows(oty), rho, us,
                                                  ops.scales),
         rows(K.rhs_2d_reference(alpha, u, oty, rho, us, ops.scales)))
    # The shard route's x-update (B9s r0, pencil DCT preconditioner, group
    # dots) against the single-process plain PCG from the same b.
    cbar = torch.sum(counts) / counts.numel()
    x_s, it_s = xupdate.solve_x(ops_s, rows(counts), cbar, None, rho, rows(theta), cfg,
                                tiled=True, rhs_parts=(rows(oty), rows(dta), us, rows(dtu)))
    x_1, it_1 = xupdate._solve_plain(ops, counts, cbar, b, rho, theta, cfg, tiled=False)
    note("solve_x", x_s, rows(x_1))
    err["solve_x iterations"] = float(abs(it_s - it_1))
    return {k: np.asarray(v) for k, v in err.items()}


def _pieces_3d(m, n1, seed):
    """The p = 3 and p = 1 collectives and slab operations against their
    single-process versions (every rank holds the whole lattice): halo
    planes and knots, the 3-D pencil transposes, the gathers, D and D',
    B12s (every flag pair, with and without true_m), B13s (b given, fused,
    matvec), the shard route's p = 3 x-update, and the partition solve on
    a chain of n1 knots whose counts vanish on one rank's segment and half
    of another's.  The largest absolute errors (relative for the Boyd sums
    and the partition solve)."""
    from multivartv_tpu_torch.config import SolverConfig
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.parallel import halo, tiled_shard
    from multivartv_tpu_torch.parallel.fit import shard_operators
    from multivartv_tpu_torch.parallel.sharding import RowSlab, make_device_mesh
    from multivartv_tpu_torch.solver import tridiag, xupdate
    from multivartv_tpu_torch.solver.problem import build_operators

    rng = np.random.RandomState(seed)
    grp = make_device_mesh()
    slab = RowSlab(grp, m)
    err = {}

    def note(name, got, want):
        err[name] = max(err.get(name, 0.0), float((got - want).abs().max()))

    def lat():
        return torch.as_tensor(rng.randn(*m).astype(np.float32))

    cfg = SolverConfig()
    ops = build_operators(m, np.asarray([0.4, 0.9, 1.3], np.float32), cfg, "cpu",
                          with_padded=False)
    ops_s = shard_operators(ops, slab)
    rows, cols = slab.rows, slab.cols
    theta, v, oty, dta, dtu = lat(), lat(), lat(), lat(), lat()
    u = tuple(w * (z != 0) for w, z in zip([lat() for _ in range(7)], ops.apply_D(lat())))
    alpha = tuple(w * (z != 0) for w, z in zip([lat() for _ in range(7)], ops.apply_D(lat())))
    counts = torch.as_tensor(rng.poisson(2, m).astype(np.float32))
    rho, kappa, us = torch.tensor(0.3), torch.tensor(0.05), torch.tensor(0.5)

    lo, hi = slab.row_off, slab.row_off + slab.shape[0]
    tops, bots = halo.halo_rows(grp, [rows(theta), rows(v)])
    zero = torch.zeros((1,) + m[1:])
    for t, b, x in zip(tops, bots, (theta, v)):
        note("halo", t, x[lo - 1:lo] if lo > 0 else zero)
        note("halo", b, x[hi:hi + 1] if hi < m[0] else zero)
    note("pencil", halo.rows_to_cols(rows(v), slab), cols(v))
    note("pencil", halo.cols_to_rows(cols(v), slab), rows(v))
    note("gather", halo.gather_rows(rows(v), slab), v)
    idx = torch.as_tensor(rng.randint(0, v.numel(), 50))
    note("gather", halo.gather_fitted(rows(v), idx, slab), v.reshape(-1)[idx])
    for a, b in zip(ops_s.apply_D(rows(theta)), ops.apply_D(theta)):
        note("D", a, rows(b))
    note("D", ops_s.apply_Dt(tuple(map(rows, alpha))), rows(ops.apply_Dt(alpha)))

    for tm in (None, (m[0] - 1, m[1] - 2, m[2] - 1)):
        for flags in ((True, False), (False, True)):
            got = tiled_shard.dual_update_tiled_3d_sharded(
                slab, rows(theta), tuple(map(rows, u)), kappa, ops.scales, us, tm, *flags)
            want = K.dual_update_tiled_3d_reference(theta, u, kappa, ops.scales, us, tm, *flags)
            for g, w in zip((*(got[0] or ()), *got[1], *got[3:]),
                            (*(want[0] or ()), *want[1], *want[3:])):
                note("B12s", g, rows(w))
            err["B12s stats"] = max(err.get("B12s stats", 0.0),
                                    float(((got[2] - want[2]).abs() / want[2].abs()).max()))
    b = oty + rho * (dta + us * dtu)
    for parts in (None, (rows(oty), rows(dta), us, rows(dtu))):
        got = tiled_shard.gram_residual_tiled_3d_sharded(
            slab, None if parts else rows(b), rows(v), rows(counts), rho, ops.scales,
            rhs_parts=parts)
        note("B13s", got, rows(K.gram_residual_tiled_3d_reference(b, v, counts, rho,
                                                                   ops.scales)))
    av = tiled_shard.gram_matvec_tiled_3d_sharded(slab, rows(v), rows(counts), rho, ops.scales)
    note("B13s", av, rows(counts * v + rho * ops.apply_gram(v)))
    # The shard route's x-update (B13s's fused r0 and matvec, the pencil
    # DCT preconditioner, group dots) against the single-process plain PCG
    # from the same b.
    cbar = torch.sum(counts) / counts.numel()
    x_s, it_s = xupdate.solve_x(ops_s, rows(counts), cbar, None, rho, rows(theta), cfg,
                                tiled=True, rhs_parts=(rows(oty), rows(dta), us, rows(dtu)))
    x_1, it_1 = xupdate._solve_plain(ops, counts, cbar, b, rho, theta, cfg, tiled=False)
    note("solve_x", x_s, rows(x_1))
    err["solve_x iterations"] = float(abs(it_s - it_1))

    # p = 1: the halo knots, D and D', and the partition solve.
    chain = RowSlab(grp, (n1,))
    ops1 = build_operators((n1,), np.asarray([0.7], np.float32), cfg, "cpu", with_padded=False)
    ops1_s = shard_operators(ops1, chain)
    c1 = torch.as_tensor(rng.poisson(1, n1).astype(np.float32))
    off = np.cumsum((0,) + chain.row_counts)
    if len(off) > 2:
        c1[off[1]:off[2]] = 0.0                           # rank 1's whole segment
    if len(off) > 3:
        c1[off[2]:off[2] + (off[3] - off[2]) // 2] = 0.0  # half of rank 2's
    b1, t1 = (torch.as_tensor(rng.randn(n1).astype(np.float32)) for _ in range(2))
    (d1,) = ops1_s.apply_D(chain.rows(t1))
    note("D p=1", d1, chain.rows(ops1.apply_D(t1)[0]))
    (w1,) = ops1.apply_D(b1)
    note("D p=1", ops1_s.apply_Dt((chain.rows(w1),)), chain.rows(ops1.apply_Dt((w1,))))
    x_p = tridiag.partition_xupdate(chain.rows(c1), chain.rows(b1), torch.tensor(0.8),
                                    ops1.scales[0], chain)
    x_w = tridiag.xupdate_tridiag(c1, b1, torch.tensor(0.8), ops1.scales[0])
    err["partition"] = float((x_p - chain.rows(x_w)).abs().max() / x_w.abs().max())
    return {k: np.asarray(v) for k, v in err.items()}


JOBS = {"sharded_admm": _sharded_admm, "mvtv_sharded": _mvtv_sharded, "pieces": _pieces,
        "pieces_3d": _pieces_3d, "whole_lattice_census": _whole_lattice_census}


def _rank(rank, world, store, jobs, out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from multivartv_tpu_torch.parallel.distributed import init_distributed

    init_distributed(f"file://{store}", world_size=world, rank=rank, device="cpu")
    try:
        results = {}
        for name, (job, kwargs) in jobs.items():
            for k, v in JOBS[job](**kwargs).items():
                results[f"{name}/{k}"] = v
        if rank == 0:
            np.savez(out, **results)
    finally:
        dist.destroy_process_group()


class Ranks:
    """world processes running jobs ({name: (job, kwargs)}), started at
    once; result() joins them (JOIN_TIMEOUT seconds in all) and returns
    rank 0's {"name/key": array}, read once."""

    def __init__(self, world, tmp_dir, jobs):
        ctx = torch.multiprocessing.get_context("spawn")
        self.out = os.path.join(tmp_dir, "results.npz")
        store = os.path.join(tmp_dir, "store")
        self.procs = [ctx.Process(target=_rank, args=(r, world, store, jobs, self.out))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def result(self):
        if getattr(self, "_result", None) is None:
            self._result = self._join()
        return self._result

    def _join(self):
        import time
        deadline = time.monotonic() + JOIN_TIMEOUT
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in self.procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        codes = [p.exitcode for p in self.procs]
        if alive or any(codes):
            raise RuntimeError(f"rank processes: exit codes {codes}, {len(alive)} killed at "
                               f"the {JOIN_TIMEOUT:g} s timeout")
        with np.load(self.out) as f:
            return dict(f)
