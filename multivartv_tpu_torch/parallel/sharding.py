"""Row groups and row slabs: how the sharded fit cuts a lattice over ranks.

Counterpart of ``multivartv_tpu/parallel/sharding.py``.  The JAX package
places global arrays on a device mesh with NamedShardings and lets the
XLA SPMD partitioner insert every collective.  PyTorch has no partitioner,
so the port holds each rank's part of a lattice as a tensor of its own and
writes every collective out (parallel/halo.py).  Its one layout is the one
in which the JAX package runs its shard kernels (parallel/fit.py,
``_sharded_solver_config``): a lattice cut along axis 0 into slabs, one per
rank of a row group, the other axes whole on every rank.  At p = 2 the
slabs are row slabs, at p = 3 plane slabs (and slabs of p - 1 dimensions
above), at p = 1 segments of the chain (the JAX package's sequence-parallel
regime, fit.py:52-72).

  * ``RowGroup``: a torch.distributed process group (None: the default
    group) whose ranks each hold one row slab; the counterpart of a mesh
    with one lattice axis.  A group of size 1 needs no initialized process
    group and makes no collective call.  On a (dp, sx, 1) mesh
    (``make_device_mesh``) each rank's row group is the sx ranks of its
    index along the fold axis "dp", and it carries its fold group (the dp
    ranks of its index along sx, which split the CV folds between them)
    and the whole mesh's group.
  * ``RowSlab``: the layout of one lattice of dims m (any p >= 1) over a
    row group.  Axes 0 and 1 are split as evenly as ``np.array_split``
    splits them; a rank's slab is indices [row_off, row_off + rows) of
    axis 0, every other axis whole.  At p >= 2 the DCT transforms of axis 0
    run in the "pencil" layout, indices [col_off, col_off + cols) of axis 1
    with every other axis whole; p = 1 has no pencil.
  * ``shard_problem`` and ``shard_state`` cut lattice arrays (counts, O'y,
    theta, every alpha and u block, the adjoint carries) to this rank's
    slab; per-sample arrays (flat_idx, y, train_mask) and scalars stay whole
    on every rank, as the JAX package replicates them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, Optional, Sequence, Tuple

import numpy as np
import torch

if TYPE_CHECKING:  # the solver imports this module's layouts
    from multivartv_tpu_torch.solver.admm import ADMMState
    from multivartv_tpu_torch.solver.problem import Problem


@dataclasses.dataclass(frozen=True)
class RowGroup:
    """The ranks that hold the row slabs of one lattice.  group: a
    torch.distributed process group, None for the default one; rank and
    size within it; axis_name: the mesh axis it stands for (the JAX
    package's "sx")."""

    rank: int
    size: int
    group: Optional[object] = None
    axis_name: str = "sx"
    fold: Optional["RowGroup"] = None
    mesh: Optional["RowGroup"] = None

    @property
    def world(self) -> "RowGroup":
        """Every rank of the mesh: this group when the fold axis has size 1,
        else the dp x sx ranks of ``mesh``."""
        return self if self.mesh is None else self.mesh

    def peer(self, r: int) -> int:
        """The global rank of this group's rank r (point-to-point calls
        take global ranks)."""
        if self.group is None:
            return r
        import torch.distributed as dist
        return dist.get_global_rank(self.group, r)


@functools.lru_cache(maxsize=None)
def _split(n: int, parts: int) -> Tuple[int, ...]:
    return tuple(len(c) for c in np.array_split(np.arange(n), parts))


@dataclasses.dataclass(frozen=True)
class RowSlab:
    """This rank's slab of a lattice of dims m over a row group (see the
    module doc)."""

    group: RowGroup
    m: Tuple[int, ...]

    def __post_init__(self):
        p, n = len(self.m), self.group.size
        if p < 1:
            raise ValueError(f"the slab layout cuts lattices of p >= 1, got m = {self.m}")
        if p == 1 and self.m[0] < 2 * n:
            raise ValueError(f"a chain of {self.m[0]} knots has fewer than two for each of the "
                             f"{n} ranks of its row group")
        if p > 1 and min(self.m[:2]) < n:
            raise ValueError(f"a {self.m} lattice has fewer indices along axis 0 or 1 than the "
                             f"{n} ranks of its row group")

    @property
    def row_counts(self) -> Tuple[int, ...]:
        return _split(self.m[0], self.group.size)

    @property
    def col_counts(self) -> Tuple[int, ...]:
        """The pencil layout's cut of axis 1 (p >= 2)."""
        return _split(self.m[1], self.group.size)

    @property
    def row_off(self) -> int:
        return sum(self.row_counts[:self.group.rank])

    @property
    def col_off(self) -> int:
        return sum(self.col_counts[:self.group.rank])

    @property
    def shape(self) -> Tuple[int, ...]:
        """The local slab's shape."""
        return (self.row_counts[self.group.rank],) + tuple(self.m[1:])

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slab of a global lattice array (a contiguous copy);
        a leading batch axis stays."""
        return x.narrow(x.ndim - len(self.m), self.row_off, self.shape[0]).contiguous()

    def cols(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's pencil of a global lattice array (axis 1 cut)."""
        return x.narrow(x.ndim - len(self.m) + 1, self.col_off,
                        self.col_counts[self.group.rank]).contiguous()


def make_device_mesh(shape: Sequence[int] = None, axis_names: Sequence[str] = ("sx",),
                     group=None) -> RowGroup:
    """This rank's row group over a torch.distributed group (None: the
    default one; without an initialized process group, this one process).
    shape: the JAX mesh shape it stands for.  An axis named "dp" is the
    fold axis; of the others (the spatial axes) only one may have size > 1,
    the row axis (2-D process grids are ROADMAP work).  With dp > 1 rank r
    of the group has dp index r // sx and sx index r % sx (the row-major
    order of the JAX package's reshape of its device list); the returned
    row group holds the sx ranks of its dp index and carries its fold group
    (``RowGroup.fold``: the dp ranks of its sx index) and the whole group
    (``RowGroup.mesh``).  Every rank of the group creates every sub-group
    with dist.new_group, in one order, so every rank of the group calls
    this with the same shape.  dist.new_group names a group by a count kept
    in each process: with `group` a sub-group of the default one, a rank
    outside it that later creates a process group with its ranks must have
    created as many before."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    elif group is not None:
        raise RuntimeError("a process group was given but torch.distributed is not "
                           "initialized (parallel.distributed.init_distributed)")
    else:
        rank, size = 0, 1
    axis = axis_names[0] if axis_names else "sx"
    if shape is None:
        return RowGroup(rank=rank, size=size, group=group, axis_name=axis)
    shape = tuple(int(v) for v in shape)
    if int(np.prod(shape)) != size:
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} ranks, the group "
                         f"has {size}")
    axes = dict(zip(axis_names, shape))
    dp = axes.get("dp", 1)
    spatial = [(n, a) for a, n in axes.items() if a != "dp"]
    big = [(n, a) for n, a in spatial if n > 1]
    if len(big) > 1:
        raise NotImplementedError(f"mesh shape {shape}: the port cuts lattices into row "
                                  "slabs over one spatial mesh axis only (2-D process grids: "
                                  "ROADMAP A11)")
    if big:
        axis = big[0][1]
    elif spatial:
        axis = spatial[0][1]
    if dp == 1:
        return RowGroup(rank=rank, size=size, group=group, axis_name=axis)
    if axis_names[0] != "dp":
        raise NotImplementedError(f"mesh axes {tuple(axis_names)}: the fold axis dp leads the "
                                  "mesh (its row-major rank order)")
    sx = size // dp
    glob = list(range(size)) if group is None else [dist.get_global_rank(group, r)
                                                    for r in range(size)]
    rows = [_sub_group([glob[d * sx + i] for i in range(sx)]) for d in range(dp)]
    folds = [_sub_group([glob[d * sx + i] for d in range(dp)]) for i in range(sx)]
    d, i = divmod(rank, sx)
    return RowGroup(rank=i, size=sx, group=rows[d], axis_name=axis,
                    fold=RowGroup(rank=d, size=dp, group=folds[i], axis_name="dp"),
                    mesh=RowGroup(rank=rank, size=size, group=group, axis_name="dp"))


def _sub_group(ranks):
    """A process group over the given global ranks, created by every rank
    of the mesh in one order; None for a single rank, whose group makes no
    collective call."""
    import torch.distributed as dist
    return None if len(ranks) == 1 else dist.new_group(ranks)


def shard_problem(problem: "Problem", slab: RowSlab) -> "Problem":
    """counts and O'y cut to this rank's slab; per-sample arrays and ybar
    whole (a batched problem keeps its leading axis)."""
    return dataclasses.replace(problem, counts=slab.rows(problem.counts),
                               oty=slab.rows(problem.oty))


def shard_state(state: "ADMMState", slab: RowSlab) -> "ADMMState":
    """theta, every alpha and u block and the adjoint carries cut to this
    rank's slab; the scalars and counts whole."""
    def cut(x):
        return None if x is None else slab.rows(x)

    return dataclasses.replace(
        state, theta=cut(state.theta), alpha=tuple(map(cut, state.alpha)),
        u=tuple(map(cut, state.u)), dta=cut(state.dta), dtu=cut(state.dtu))
