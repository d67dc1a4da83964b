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
    p >= 3; at p = 1 a step plus a sine at sorted x, the fused lasso's)."""
    rng = np.random.RandomState(seed)
    if len(m) >= 3:
        n = 3 * int(np.prod(m))
        x = rng.uniform(0, 1, (n, len(m)))
        return x, (np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + x[:, 2:].sum(1)
                   + 0.2 * rng.randn(n))
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


def set_gates(quarter_min_axis=None, blocked_min_half=None):
    """Lower the spectral CG's layout gates in this process (None: keep):
    solver/problem.py's QUARTER_MIN_AXIS and solver/xupdate.py's
    BLOCKED_MIN_HALF, as the single-card tests lower them."""
    from multivartv_tpu_torch.solver import problem, xupdate
    if quarter_min_axis is not None:
        problem.QUARTER_MIN_AXIS = quarter_min_axis
    if blocked_min_half is not None:
        xupdate.BLOCKED_MIN_HALF = blocked_min_half


def _mvtv_sharded(m, seed, n_lambda, folds, cfg, labels_file=None, gates=None):
    from multivartv_tpu_torch.config import SolverConfig
    from multivartv_tpu_torch.parallel.fit import mvtv_sharded
    from multivartv_tpu_torch.solver import cv

    set_gates(**(gates or {}))
    x, y = fit_data(m, seed)
    if labels_file is not None:     # the JAX package's fold labels
        labels = torch.as_tensor(np.load(labels_file))
        cv.kfold_indices = lambda n, k, seed: labels
    model = mvtv_sharded(x, y, m=m, n_lambda=n_lambda, folds=folds,
                         solver_config=SolverConfig(**cfg), device="cpu")
    return {"lambdas": model.lambdas, "cv_mses": model.cv_mses,
            "best": np.asarray(model.lambda_minmse_ind), "theta": model.theta_lattice,
            "fitted": model.fitted, "key": np.asarray(model.solver_config.tiled_shard_key)}


def _spread(v, group=None):
    """The largest |v on a rank - v on the group's first rank| over the
    group (None: the world; v: a float64 vector of one length on every
    rank)."""
    import torch.distributed as dist
    t = torch.as_tensor(v, dtype=torch.float64)
    every = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, t, group=group)
    return max(float((e - every[0]).abs().max()) for e in every)


def _mvtv_mesh(m, seed, n_lambda, folds, cfg, shape, labels_file=None, group=None,
               batch_axis="dp", gates=None, skew=0.0):
    """mvtv_sharded on make_device_mesh(shape) over a process group (None:
    the world), with the axis names of the lattice's p (("dp", "sx") at
    p = 1, ("dp", "sx", "sy") above); the model as in _mvtv_sharded, the
    mesh's dp and sx, and how far the model's arrays on any rank of the
    group are from its first rank's ("spread": 0 when every rank returns
    the same model).  With folds % dp != 0 the ValueError's message in
    place of the model.  skew: each rank's whole problem's O'y scaled by
    1 + skew * its dp index, as if each row group had binned it in its own
    order (the card's atomic adds), so that the row groups' final paths
    differ; dp index 0's O'y is left as it is."""
    import dataclasses

    from multivartv_tpu_torch import api
    from multivartv_tpu_torch.config import SolverConfig
    from multivartv_tpu_torch.parallel.fit import mvtv_sharded
    from multivartv_tpu_torch.parallel.sharding import make_device_mesh
    from multivartv_tpu_torch.solver import cv

    set_gates(**(gates or {}))
    x, y = fit_data(m, seed)
    if labels_file is not None:
        labels = torch.as_tensor(np.load(labels_file))
        cv.kfold_indices = lambda n, k, seed: labels
    names = ("dp", "sx") if len(m) == 1 else ("dp", "sx", "sy")
    mesh = make_device_mesh(shape, names, group=group)
    setup = api._setup

    def skewed(*a, **kw):
        *head, problem = setup(*a, **kw)
        scale = 1.0 + skew * (0 if mesh.fold is None else mesh.fold.rank)
        return (*head, dataclasses.replace(problem, oty=problem.oty * scale))

    api._setup = skewed if skew else setup
    try:
        model = mvtv_sharded(x, y, m=m, n_lambda=n_lambda, folds=folds, device_mesh=mesh,
                             batch_axis=batch_axis, solver_config=SolverConfig(**cfg),
                             device="cpu")
    except ValueError as exc:
        return {"raised": np.asarray(str(exc))}
    finally:
        api._setup = setup
    arrays = np.concatenate([np.ravel(a).astype(np.float64) for a in (
        model.lambdas, model.cv_mses, model.theta_lattice, model.fitted,
        [model.lambda_minmse_ind])])
    return {"lambdas": model.lambdas, "cv_mses": model.cv_mses,
            "best": np.asarray(model.lambda_minmse_ind), "theta": model.theta_lattice,
            "fitted": model.fitted, "key": np.asarray(model.solver_config.tiled_shard_key),
            "spread": np.asarray(_spread(arrays, group)),
            "dp": np.asarray(1 if mesh.fold is None else mesh.fold.size),
            "sx": np.asarray(mesh.size)}


def _fold_collectives(shape):
    """The fold axis's collectives on make_device_mesh(shape), a (dp, sx, 1)
    mesh over the world, each rank's values made from its global rank:
    gather_folds (every fold group's blocks in dp order) and broadcast_each
    (the fold group's first rank's tensors, None kept, an int64 tensor
    too); the largest absolute errors, and whether each rank's row and
    fold groups hold the ranks the mesh's row-major order gives them."""
    import torch.distributed as dist
    from multivartv_tpu_torch.parallel import halo
    from multivartv_tpu_torch.parallel.sharding import make_device_mesh

    mesh = make_device_mesh(shape, ("dp", "sx", "sy"))
    r, fold = dist.get_rank(), mesh.fold
    sx = mesh.size
    d, i = divmod(r, sx)
    got = halo.gather_folds(torch.full((1, 2), float(r)), fold)
    want = torch.tensor([[float(k * sx + i)] * 2 for k in range(fold.size)])
    a, none, b = halo.broadcast_each((torch.full((3,), float(r)), None, torch.arange(4) + r),
                                     fold)
    groups = [mesh.peer(k) for k in range(sx)] == [d * sx + k for k in range(sx)] and \
        [fold.peer(k) for k in range(fold.size)] == [k * sx + i for k in range(fold.size)]
    return {"gather_folds": np.asarray(float((got - want).abs().max())),
            "broadcast_each": np.asarray(max(float((a - i).abs().max()),
                                             float((b - torch.arange(4) - i).abs().max()))),
            "none kept": np.asarray(none is None and b.dtype == torch.int64),
            "groups": np.asarray(groups and (mesh.rank, fold.rank, mesh.world.rank) == (i, d, r))}


def _mvtv_parts(parts, fits):
    """Fits on parts of the world, each part a world of its own: parts is a
    list of rank lists, fits is {name: (k, _mvtv_mesh's kwargs)}, and the
    ranks of part k run the fits of part k over their part's group, one
    after another, while the other parts run theirs.  Every rank returns
    every fit's {"name/key": array}, each from the first rank of its
    part."""
    import torch.distributed as dist
    rank = dist.get_rank()
    groups = [dist.new_group(ranks) for ranks in parts]
    k = next(i for i, ranks in enumerate(parts) if rank in ranks)
    mine = {f"{name}/{key}": v
            for name, (part, kw) in fits.items() if part == k
            for key, v in _mvtv_mesh(group=groups[k], **kw).items()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return {key: v for ranks in parts for key, v in every[ranks[0]].items()}


def _whole_lattice_census(m, seed, n_lambda, folds, cfg, store, gates=None):
    """mvtv_sharded with a census as every ADMM solve (each fold's, the full
    path's, the refit's) starts, before its first iteration: the live torch
    tensors whose trailing shape is the whole lattice's, counted after a gc
    pass, and the solve's eigenvalue sets by bytes, each as a share of the
    whole lattice's set (utils.profiling.solve_census).  Each rank's
    largest count and number of solves, summed over the ranks; the largest
    share of any set on any rank and the sets seen (a bit each, in
    profiling.EIGEN_SETS order); the model's lambdas, CV MSEs and theta.
    gates: set_gates's, so that the blocked and quartered sets exist."""
    import torch.distributed as dist
    from multivartv_tpu_torch.config import PathConfig, SolverConfig
    from multivartv_tpu_torch.parallel.fit import mvtv_sharded
    from multivartv_tpu_torch.utils.profiling import EIGEN_SETS, solve_census

    set_gates(**(gates or {}))
    x, y = fit_data(m, seed)
    with solve_census(m) as (seen, _):
        model = mvtv_sharded(x, y, m=m, n_lambda=n_lambda, folds=folds,
                             solver_config=SolverConfig(**cfg),
                             path_config=PathConfig(n_lambda=n_lambda, store=store),
                             device="cpu")
    shares = [v for *_, sh in seen for v in sh.values()]
    sets = sum(1 << k for k, name in enumerate(EIGEN_SETS) if any(name in sh for *_, sh in seen))
    totals = torch.tensor([max(n for n, *_ in seen), len(seen)], dtype=torch.int64)
    dist.all_reduce(totals)
    top = torch.tensor([max(shares)], dtype=torch.float64)
    dist.all_reduce(top, op=dist.ReduceOp.MAX)
    return {"whole": totals[0].numpy(), "solves": totals[1].numpy(),
            "share": top[0].numpy(), "sets": np.asarray(sets),
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


def f32_operands(ops):
    """ops with the spectral CG's per-axis operands (the folded halves, the
    quartered transform's matrices) in float32 in place of bf16."""
    import dataclasses

    from multivartv_tpu_torch.ops import dct as dct_ops
    quarters = None
    if ops.dct_quarters_lp is not None:
        quarters = tuple(dct_ops.dct_quarter_mats(v, device=ops.deltas.device) for v in ops.m)
    return dataclasses.replace(ops, dct_halves_lp=ops.dct_halves, dct_quarters_lp=quarters)


def _spectral_pieces(ms, seed):
    """The shard route's x-update arms on this rank's slab against the
    single card's on the whole lattice (every rank holds it), from a warm
    x0 (the exact solution, perturbed), each lattice of ms under each
    layout (the gates lowered here and restored after) and vector type:
    the spectral CG across ranks against _solve_tiled, and with float32
    vectors once more with float32 per-axis operands on both sides
    (f32_operands); once a lattice (the
    other arms' vectors are float32 and read no layout) spectral_cg=False
    against _solve_natural (the largest errors over max|x - x0|), and
    xla_packed=False against the exact PCG with the folded halves removed
    (the largest absolute error) and against the single card's exact PCG
    (_solve_plain; the largest absolute error and the difference in CG
    steps).  The slab kernels' plain versions form r0
    (and the natural arm's matvec) at p = 2 and 3, as the single card's
    tiled route's do; at p = 4 the stencils are plain on both sides."""
    import dataclasses

    from multivartv_tpu_torch.config import SolverConfig
    from multivartv_tpu_torch.parallel import fit, halo
    from multivartv_tpu_torch.parallel.sharding import RowSlab, make_device_mesh
    from multivartv_tpu_torch.solver import problem, xupdate
    from multivartv_tpu_torch.solver.problem import build_operators

    saved = (problem.QUARTER_MIN_AXIS, xupdate.BLOCKED_MIN_HALF)
    gates = {"quartered": dict(quarter_min_axis=4),
             "blocked": dict(quarter_min_axis=1 << 20, blocked_min_half=4),
             "packed": dict(quarter_min_axis=1 << 20, blocked_min_half=1 << 20)}
    err = {"spectral": 0.0, "spectral f32": 0.0, "natural": 0.0, "exact arm": 0.0, "exact vs one card": 0.0,
           "exact iterations": 0, "cases": 0}
    grp = make_device_mesh()
    t = torch.as_tensor
    try:
        for m in ms:
            rng = np.random.RandomState(seed + len(m))
            slab = RowSlab(grp, m)
            rows = slab.rows
            counts = t(rng.poisson(3, m).astype(np.float32))
            oty = t((rng.randn(*m) * counts.numpy()).astype(np.float32))
            dta, dtu = (t((0.3 * rng.randn(*m)).astype(np.float32)) for _ in range(2))
            rho, us = t(np.float32(0.7)), t(np.float32(0.5))
            b = oty + rho * (dta + us * dtu)
            cbar = torch.sum(counts) / counts.numel()
            parts = (oty, dta, us, dtu)
            kern = len(m) in (2, 3)
            for layout, g in gates.items():
                set_gates(**g)
                for vec in (False, True):
                    cfg = SolverConfig(spectral_vec_bf16=vec)
                    ops = build_operators(m, np.linspace(0.5, 1.3, len(m)).astype(np.float32),
                                          cfg, "cpu", with_padded=False)
                    assert xupdate.spectral_layout(ops) == layout
                    x_star, _ = xupdate.solve_x(ops, counts, cbar, b, rho, torch.zeros(m),
                                                SolverConfig(use_kernels=False))
                    x0 = t((x_star.numpy() + 0.05 * rng.randn(*m)).astype(np.float32))
                    scfg = fit._sharded_solver_config(cfg, grp)
                    ops_s = fit.shard_operators(ops, slab)
                    cut = dict(tiled=True, rhs_parts=tuple(
                        v if v is us else rows(v) for v in parts)) if kern else {}
                    bs = None if kern else rows(b)

                    def sharded(o, c):
                        return xupdate.solve_x(
                            o, rows(counts), cbar, bs, rho, rows(x0), c,
                            counts_blocked=xupdate.counts_to_layout(o, rows(counts), c), **cut)

                    want = xupdate._solve_tiled(ops, counts, cbar, b, rho, x0, cfg,
                                                xupdate.counts_to_layout(ops, counts, cfg),
                                                parts if kern else None, kernel=kern)[0]
                    got = halo.gather_rows(sharded(ops_s, scfg)[0], slab)
                    scale = float((want - x0).abs().max())
                    err["spectral"] = max(err["spectral"],
                                          float((got - want).abs().max()) / scale)
                    err["cases"] += 1
                    if vec:
                        continue
                    # float32 per-axis operands on both sides: no bf16
                    # rounding point, so only the order of the sums differs
                    ops32 = f32_operands(ops)
                    want = xupdate._solve_tiled(ops32, counts, cbar, b, rho, x0, cfg,
                                                xupdate.counts_to_layout(ops32, counts, cfg),
                                                parts if kern else None, kernel=kern)[0]
                    got = halo.gather_rows(sharded(fit.shard_operators(ops32, slab), scfg)[0],
                                           slab)
                    err["spectral f32"] = max(err["spectral f32"],
                                              float((got - want).abs().max()) / scale)
                    if layout != "packed":   # the other arms read no layout
                        continue
                    nat = dataclasses.replace(scfg, spectral_cg=False)
                    want = xupdate._solve_natural(ops, counts, cbar, b, rho, x0, nat,
                                                  tiled=kern)[0]
                    got = halo.gather_rows(sharded(ops_s, nat)[0], slab)
                    err["natural"] = max(err["natural"],
                                         float((got - want).abs().max()) / scale)
                    exact_cfg = dataclasses.replace(scfg, xla_packed=False)
                    exact, it_s = sharded(ops_s, exact_cfg)
                    plain = sharded(dataclasses.replace(ops_s, dct_halves=None), scfg)[0]
                    err["exact arm"] = max(err["exact arm"], float((exact - plain).abs().max()))
                    one, it_1 = xupdate._solve_plain(ops, counts, cbar, b, rho, x0, exact_cfg,
                                                     tiled=False)
                    err["exact vs one card"] = max(err["exact vs one card"], float(
                        (halo.gather_rows(exact, slab) - one).abs().max()))
                    err["exact iterations"] = max(err["exact iterations"], abs(it_s - it_1))
    finally:
        problem.QUARTER_MIN_AXIS, xupdate.BLOCKED_MIN_HALF = saved
    return {k: np.asarray(v) for k, v in err.items()}


JOBS = {"sharded_admm": _sharded_admm, "spectral_pieces": _spectral_pieces,
        "mvtv_sharded": _mvtv_sharded, "mvtv_mesh": _mvtv_mesh, "mvtv_parts": _mvtv_parts,
        "fold_collectives": _fold_collectives,
        "pieces": _pieces,
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
