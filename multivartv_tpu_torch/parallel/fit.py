"""The cross-validated fit with the lattice cut into slabs over ranks.

Counterpart of ``multivartv_tpu/parallel/fit.py``: ``mvtv_sharded`` runs
the whole product path (lambda_max, the lambda grid, k-fold CV, the full
path, the refit; mbs_impl, solvers.cpp:305-376) with theta and every
lattice-shaped operand of the solve cut along axis 0 into slabs, one per
rank of a row group (parallel/sharding.py): row slabs at p = 2, plane
slabs at p = 3 (and slabs of p - 1 dimensions above), segments of the
chain at p = 1, with the full block set or the reduced one.  The JAX
package leaves every collective to the XLA SPMD partitioner; here the
solver's shard route (solver/admm.py) writes them out: halo rows or planes
around the slab kernels (B8s and B9s at p = 2, B12s and B13s at p = 3 with
the full block set; parallel/tiled_shard.py) or around the plain stages
(every other lattice, the JAX package's XLA stages there), the halo knot of
the plain p = 1 stages and the partition solve's gather of the segments'
end values (solver/tridiag.py), sums over the group for every dot, norm
and Boyd statistic, and the pencil transposes of the x-update's DCT
transforms (parallel/halo.py): the spectral-correction CG across ranks
(parallel/spectral.py) by default, as the JAX package runs it on a TPU,
and the natural-domain bf16 PCG and the exact float32 PCG under
SolverConfig(spectral_cg=False) and (xla_packed=False).  2-D process grids
raise NotImplementedError (ROADMAP A11).

Set-up is whole on every rank, and then dropped: each rank bins all the
data, builds the global operators and takes lambda_max (float64) from the
whole problem; global rank 0's lambda grid is broadcast over the whole mesh
so that every rank solves the same path.  Then each rank cuts its slab of
the operators and the problem and keeps no reference to the whole ones (the
JAX package rebinds them to their sharded placements, fit.py:325-326); each
CV fold's problem is cut as it is built, so one whole fold problem exists
at a time.  The CV folds run one after another through the sharded
single-problem route, as ``CVConfig(vmap_folds=False)`` does.  On a (dp,
sx, 1) mesh (parallel/sharding.py::make_device_mesh) the folds are split in blocks
over the fold axis "dp", as the JAX package shards its fold batch over that
axis (fold f on dp index f // (folds / dp)): each row group builds and
solves only its block, and the per-fold held-out MSEs come together on
every rank by an all_gather over the fold group, in fold order, before
their mean; the final path and the refit run on every row group, as the JAX
package replicates them over dp, and every rank returns dp index 0's, as
the JAX package's host reads one replica.  The path's thetas and the chosen
one go to the host one lambda at a time (halo.gather_rows_to_host), so
after the cut no rank holds a lattice-sized array on its device, and every
rank returns the same ``MVTVModel``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from multivartv_tpu_torch.config import (DEFAULT_MESH, CVConfig, MeshConfig, PathConfig,
                                         SolverConfig)
from multivartv_tpu_torch.parallel import halo, tiled_shard
from multivartv_tpu_torch.parallel.sharding import (RowGroup, RowSlab, make_device_mesh,
                                                    shard_problem)
from multivartv_tpu_torch.solver.problem import Operators
from multivartv_tpu_torch.utils.logging import get_logger


def default_lattice_mesh(p: int, dp: int = 1, group=None) -> Tuple[RowGroup, Tuple[str, ...]]:
    """(row group, axis names): the ranks of the group (None: the default
    one) on a (dp, sx) mesh at p = 1 (the JAX package's sequence-parallel
    layout) or a (dp, sx, sy) mesh with sy = 1 at p >= 2, sx = ranks / dp
    (make_device_mesh).  The JAX package factors its devices over sx and
    sy; the port cuts axis 0 only.  A world that dp does not divide raises
    ValueError, as the JAX package's reshape of its devices does."""
    import torch.distributed as dist
    size = dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1
    if dp < 1 or size % dp:
        raise ValueError(f"the fold axis dp = {dp} does not divide the {size} ranks")
    shape = (dp, size // dp) if p == 1 else (dp, size // dp, 1)
    names = ("dp", "sx") if p == 1 else ("dp", "sx", "sy")
    return make_device_mesh(shape, names, group=group), names


def _sharded_solver_config(cfg: SolverConfig, device_mesh: Optional[RowGroup] = None,
                           spatial_axes: Optional[Sequence] = None) -> SolverConfig:
    """Adapt a SolverConfig for the row-sharded fit, LOUDLY: every field
    changed is logged at WARNING and stays visible on the returned model's
    solver_config.  tiled_shard_key: the key of the row group
    (device_mesh; None: every rank of the default group), as the JAX package
    registers its mesh; jacobi_pcg without cg_fixed_iters gets 10 steps, as
    in the JAX package.  The x-solver is kept: dct_pcg's preconditioner
    runs through the pencil transpose.  Column sharding (spatial_axes
    naming the group's axis for axis 1) raises: it is ROADMAP work."""
    changes = {}
    if cfg.x_solver == "jacobi_pcg" and cfg.cg_fixed_iters is None:
        changes["cg_fixed_iters"] = 10
    if device_mesh is None:
        device_mesh = make_device_mesh()
    if spatial_axes is not None and len(spatial_axes) > 1 and device_mesh.size > 1 \
            and device_mesh.axis_name in tuple(spatial_axes)[1:]:
        raise NotImplementedError("the port cuts lattices along axis 0; sharding another "
                                  "axis (a 2-D process grid) is not ported (ROADMAP A11)")
    key = tiled_shard.register_shard_mesh(device_mesh)
    if cfg.tiled_shard_key != key:
        changes["tiled_shard_key"] = key
    if changes:
        get_logger().warning(
            "mvtv_sharded adapted SolverConfig for lattice sharding: %s (original: "
            "use_kernels=%s, x_solver=%s, cg_fixed_iters=%s, tiled_shard_key=%s)", changes,
            cfg.use_kernels, cfg.x_solver, cfg.cg_fixed_iters, cfg.tiled_shard_key)
        return dataclasses.replace(cfg, **changes)
    return cfg


def shard_operators(ops: Operators, slab: RowSlab) -> Operators:
    """The operators of one rank's slab.  Lattice-sized operands are cut:
    gram_eigs and the spectral CG's eigenvalue sets (packed, blocked,
    quartered and their bf16 copies) to the rank's pencil (the layout in
    which the x-update divides by them; parallel/spectral.py), gram_diagonal
    to its slab; at p = 1, which has no pencil, gram_eigs stays whole.  The
    per-axis transform operands (the dense DCT matrices, the folded halves
    and the quartered operands, O(sum m_j^2)) stay whole on every rank, as
    the JAX package replicates them (fit.py:139-200).  At p = 1 the
    partition solve reads the scales only."""
    if tuple(ops.m) != tuple(slab.m):
        raise ValueError(f"operators of {ops.m} cut over a layout of {slab.m}")
    from multivartv_tpu_torch.parallel import spectral
    p = len(ops.m)

    def pencil(blocks, div):
        return None if blocks is None else tuple(spectral.pencil_cut(e, slab, div)
                                                  for e in blocks)

    return dataclasses.replace(
        ops, gram_eigs=ops.gram_eigs if p == 1 else slab.cols(ops.gram_eigs),
        gram_diagonal=None if ops.gram_diagonal is None else slab.rows(ops.gram_diagonal),
        dct_mats_lp=None,
        gram_eigs_packed=None if ops.gram_eigs_packed is None else slab.cols(
            ops.gram_eigs_packed),
        gram_eigs_blocked=pencil(ops.gram_eigs_blocked, 2),
        gram_eigs_blocked_lp=pencil(ops.gram_eigs_blocked_lp, 2),
        gram_eigs_quartered=pencil(ops.gram_eigs_quartered, 4),
        gram_eigs_quartered_lp=pencil(ops.gram_eigs_quartered_lp, 4), padded=None, slab=slab)


def _broadcast(x: torch.Tensor, grp: RowGroup) -> torch.Tensor:
    """The group's rank 0's x on every rank of the group."""
    if grp.size == 1:
        return x
    import torch.distributed as dist
    out = x.clone().contiguous()
    dist.broadcast(out, src=grp.peer(0), group=grp.group)
    return out


def mvtv_sharded(data, y, m=None, mesh=None, n_lambda: int = 100, ftrue=None, lambdas=None,
                 folds: int = 5, verbose: bool = False, device_mesh: Optional[RowGroup] = None,
                 spatial_axes: Optional[Sequence[str]] = None, batch_axis: Optional[str] = "dp",
                 solver_config: Optional[SolverConfig] = None,
                 path_config: Optional[PathConfig] = None, cv_config: Optional[CVConfig] = None,
                 mesh_config: MeshConfig = DEFAULT_MESH, device="cuda"):
    """mvtv (api.mvtv's arguments and MVTVModel) with the lattice cut into
    slabs along axis 0 over a row group (any p, either block set); every
    rank calls it with the same data and returns the same model (see the
    module doc).

    device_mesh: a RowGroup (parallel.sharding.make_device_mesh); None:
        every rank of the default process group (parallel.distributed.
        init_distributed first for more than one process; without one, this
        process alone).  Each rank's device is ``device`` (with NCCL, one card
        per rank: pass "cuda:<rank>" or set the current device).
    spatial_axes: mesh-axis names per lattice axis; only axis 0 may be
        cut.  batch_axis: the mesh axis the CV folds are split over ("dp":
        device_mesh.fold, a block of folds per row group; folds > 1 must be
        a multiple of its size, else ValueError, as in the JAX package); None
        or a mesh without that axis: every row group solves every fold.
        Within a row group the folds run one after another.  On a mesh
        whose fold axis has more than one rank every rank returns dp index
        0's final path and refit, whatever batch_axis is."""
    from multivartv_tpu_torch.api import (LatticeCut, _cross_validated_fit, _fit_configs,
                                          _lambda_grid, _setup)

    if solver_config is None:
        solver_config = SolverConfig()
    path_config, cv_config = _fit_configs(n_lambda, folds, path_config, cv_config)
    cv_config = dataclasses.replace(cv_config, vmap_folds=False)
    data_np, y_np, spec, data_t, y_t, ops, problem = _setup(data, y, m, mesh, solver_config,
                                                            mesh_config, device)
    if device_mesh is None:
        device_mesh, _ = default_lattice_mesh(len(spec.m))
    fold = device_mesh.fold if batch_axis == "dp" else None
    folds = cv_config.folds
    if fold is not None and folds > 1 and folds % fold.size:
        raise ValueError(f"{folds} CV folds do not split evenly over the {fold.size} ranks of "
                         "the fold axis 'dp'")
    solver_config = _sharded_solver_config(solver_config, device_mesh, spatial_axes)
    slab = RowSlab(device_mesh, spec.m)
    grid, path_config = _lambda_grid(ops, problem, lambdas, path_config, verbose,
                                     share=lambda g: _broadcast(g, device_mesh.world))
    # From here on only this rank's slab of the operators and the problem
    # is alive: rebinding drops the whole ones (shard_operators cuts every
    # lattice-sized operand to the rank's slab or pencil).
    ops, problem = shard_operators(ops, slab), shard_problem(problem, slab)
    cut = LatticeCut(problem=lambda pr: shard_problem(pr, slab),
                     gather=lambda t: halo.gather_rows_to_host(t, slab))
    replicas = device_mesh.fold
    if replicas is not None and replicas.size > 1:
        def replica(final_path, best_theta, best_fitted):
            """The final path and refit of dp index 0 on every rank: each row
            group computes them (the JAX package's replicas over dp), and
            on the card the replicas can differ in their last bits (each
            row group bins O'y by atomic adds of its own); JAX's host reads
            one replica."""
            mse, iters, thetas, fitted, theta, best_f = halo.broadcast_each(
                (final_path.train_mse, final_path.iters, final_path.thetas, final_path.fitted,
                 best_theta, best_fitted), replicas)
            return (final_path._replace(train_mse=mse, iters=iters, thetas=thetas,
                                        fitted=fitted), theta, best_f)

        cut = cut._replace(replica=replica)
    if fold is not None and fold.size > 1:
        def block(k):
            per = k // fold.size
            return range(fold.rank * per, (fold.rank + 1) * per)

        cut = cut._replace(folds=block, cv_mean=lambda res: torch.mean(
            halo.gather_folds(res.fold_test_mse, fold), dim=0))
    return _cross_validated_fit((data_np, y_np, spec, data_t, y_t), ops, problem, grid, cut,
                                ftrue, verbose, solver_config, path_config, cv_config)
