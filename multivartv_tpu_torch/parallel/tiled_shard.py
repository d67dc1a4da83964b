"""The slab kernels of the sharded route: halo exchange, kernel, sum.

Counterpart of ``multivartv_tpu/parallel/tiled_shard.py``, whose
shard_map wrappers run the tiled Pallas kernels per shard of a row-sharded
lattice.  Here each rank holds its slab as a tensor of its own, and each
wrapper (1) exchanges the halo rows (planes at p = 3) with the
neighbouring ranks (parallel/halo.py, one call for all of the kernel's
inputs; zeros at the global edges), (2) launches the slab kernel on the
slab (B8s, B9s or B11s at p = 2; B12s or B13s at p = 3; ops/kernels.py;
the plain version on CPU tensors), and (3) for B8s and B12s sums the five
Boyd partial sums over the row group (the JAX package's ``psum``).  A
group of size 1 makes no call, and the kernels then compute their
whole-lattice twins' function on the whole lattice.

Scope (``shard_supported``, the JAX package's ``_tiled_shard_active``):
the full block set, the lattice cut along axis 0 only; p = 2 as the JAX
package's shard kernels, p = 3 where the JAX package leaves the stages to
its SPMD partitioner (no Pallas kernel), and p = 1, whose stages are plain
and whose x-update is the partition solve (solver/tridiag.py; no slab
kernel here).  It picks the kernels, not the route: every other lattice
(p >= 4, the reduced block set) runs the shard route on the plain stages
of parallel/halo.py, as the JAX package runs its XLA stages there.  The
row group rides in
``SolverConfig.tiled_shard_key``
as a small integer key into a registry (``register_shard_mesh``), as the
JAX package keeps its mesh out of the frozen config; the solver's
operators carry the lattice's ``RowSlab`` (solver/problem.py), which the
wrappers take in place of the JAX package's key.
"""

from __future__ import annotations

from typing import Optional, Tuple

from multivartv_tpu_torch.ops import kernels as K
from multivartv_tpu_torch.parallel.halo import halo_pair, halo_rows, psum
from multivartv_tpu_torch.parallel.sharding import RowGroup, RowSlab

# key -> RowGroup.  Keys go into SolverConfig.tiled_shard_key.
_REGISTRY: dict = {}


def register_shard_mesh(group: RowGroup, axis_name: Optional[str] = None) -> int:
    """Register a row group and return its stable key."""
    if axis_name is not None and axis_name != group.axis_name:
        raise ValueError(f"the row group's axis is {group.axis_name!r}, not {axis_name!r}")
    for k, g in _REGISTRY.items():
        if g == group:
            return k
    key = len(_REGISTRY) + 1
    _REGISTRY[key] = group
    return key


def get_shard_ctx(key: int) -> Tuple[RowGroup, str]:
    group = _REGISTRY[key]
    return group, group.axis_name


def shard_supported(m, binaries, key: Optional[int]) -> bool:
    """The shard route's kernels apply: a registered key, and at p = 2 and
    3 the slab kernels (B8s/B9s, B12s/B13s and the dta/dtu carries) with
    the full block set and at least one index of axes 0 and 1 per rank, at
    p = 1 T1's partition solve with two knots per rank (the JAX package's
    further alignment rules are the TPU's).  Lattices it declines run the
    shard route on plain stages (module doc)."""
    if key is None or key not in _REGISTRY:
        return False
    p, size = len(m), _REGISTRY[key].size
    if p == 1:
        return int(m[0]) >= 2 * size
    if p not in (2, 3) or len(binaries) != 2 ** p - 1:
        return False
    return min(int(v) for v in m[:2]) >= size


def dual_update_tiled_2d_sharded(slab: RowSlab, theta, u, kappa, scales, u_scale=None,
                                 true_m: Optional[tuple] = None, want_adjoints: bool = False,
                                 want_alpha: bool = True):
    """B8s on this rank's slab with its halos, the stats summed over the
    group: dual_update_tiled_2d's contract on row slabs."""
    tops, bots = halo_rows(slab.group, [theta, *u])
    outs = K.dual_update_tiled_2d_shard(theta, u, tops, bots, slab.row_off, slab.m[0], kappa,
                                        scales, u_scale=u_scale, true_m=true_m,
                                        want_adjoints=want_adjoints, want_alpha=want_alpha)
    return outs[:2] + (psum(outs[2], slab.group),) + outs[3:]


def rhs_tiled_2d_sharded(slab: RowSlab, alpha, u, oty, rho, u_scale, scales):
    """B11s on this rank's slab with its halos: rhs_tiled_2d on row slabs."""
    tops, bots = halo_rows(slab.group, [*alpha, *u])
    return K.rhs_tiled_2d_shard(alpha, u, tops, bots, slab.row_off, oty, rho, u_scale, scales)


def gram_residual_tiled_2d_sharded(slab: RowSlab, b, v, counts, rho, scales, rhs_parts=None):
    """B9s on this rank's slab with v's halos: r0 = b - (counts + rho D'D) v,
    b given or formed in the kernel from rhs_parts = (oty, dta, u_scale,
    dtu)."""
    top, bot = halo_pair(v, slab.group)
    return K.gram_residual_tiled_2d_shard(b, v, top, bot, slab.row_off, slab.m[0], counts,
                                          rho, scales, rhs_parts=rhs_parts)


def gram_matvec_tiled_2d_sharded(slab: RowSlab, v, counts, rho, scales):
    """(counts + rho D'D) v on this rank's slab with v's halos (B9s's kernel
    in its matvec mode): the sharded PCG's matvec."""
    top, bot = halo_pair(v, slab.group)
    return K.gram_matvec_tiled_2d_shard(v, top, bot, slab.row_off, slab.m[0], counts, rho,
                                        scales)


def dual_update_tiled_3d_sharded(slab: RowSlab, theta, u, kappa, scales, u_scale=None,
                                 true_m: Optional[tuple] = None, want_adjoints: bool = False,
                                 want_alpha: bool = True):
    """B12s on this rank's plane slab with its halo planes, the stats summed
    over the group: dual_update_tiled_3d's contract on plane slabs."""
    tops, bots = halo_rows(slab.group, [theta, *u])
    outs = K.dual_update_tiled_3d_shard(theta, u, tops, bots, slab.row_off, slab.m[0], kappa,
                                        scales, u_scale=u_scale, true_m=true_m,
                                        want_adjoints=want_adjoints, want_alpha=want_alpha)
    return outs[:2] + (psum(outs[2], slab.group),) + outs[3:]


def gram_residual_tiled_3d_sharded(slab: RowSlab, b, v, counts, rho, scales, rhs_parts=None):
    """B13s on this rank's plane slab with v's halo planes: r0 = b - (counts
    + rho D'D) v, b given or formed in the kernel from rhs_parts = (oty,
    dta, u_scale, dtu)."""
    top, bot = halo_pair(v, slab.group)
    return K.gram_residual_tiled_3d_shard(b, v, top, bot, slab.row_off, slab.m[0], counts,
                                          rho, scales, rhs_parts=rhs_parts)


def gram_matvec_tiled_3d_sharded(slab: RowSlab, v, counts, rho, scales):
    """(counts + rho D'D) v on this rank's plane slab with v's halo planes
    (the Laplacian march of csrc/tiled3.cu): the sharded PCG's matvec at
    p = 3."""
    top, bot = halo_pair(v, slab.group)
    return K.gram_matvec_tiled_3d_shard(v, top, bot, slab.row_off, slab.m[0], counts, rho,
                                        scales)
