"""The spectral-correction CG's DCT layouts on row slabs: the x-update of
the shard route across ranks.

Counterpart of what the JAX package's SPMD partitioner makes of its
spectral CG on a sharded lattice (parallel/fit.py:139-200: the folded and
quartered per-axis operands replicated, the eigenvalue blocks sharded, the
per-axis products distributed).  The folded (packed, blocked) and
quartered transforms pair index i with index m - 1 - i along each axis
(ops/dct.py::to_blocks), and along axis 0 those rows lie on different
ranks.  So one transform runs in two layouts:

  * natural lattices (r0, the counts product, the solution) are this
    rank's row slab, (rows, m1, ..., m_{p-1});
  * the spectral blocks, the CG's vectors and the eigenvalue blocks
    (``pencil_cut``, fit.shard_operators) live in the pencil layout, axis
    0 whole and axis 1 cut;
  * ``fwd`` runs the single card's axis order, axis 0 first: the natural
    slab to its pencil (one all_to_all, halo.to_pencils), axis 0 there,
    the blocks back to slabs of their axis 0 (halo.to_slabs), axes
    1 .. p-1 on them, and every block to the pencil (one all_to_all for
    all of them);
  * ``inv`` runs it too: axis 0 on the pencil, the blocks to the slab
    (one all_to_all), then axes 1 .. p-1 there.

Each axis is transformed by the single card's per-axis transform of
ops/dct.py (the axis moved first, transformed, and moved back), so every
product takes the same bf16-rounded operands as on one card, and the
values agree with the single card's up to the order of the float32 sums
inside a product.  A CG step is four all_to_alls (three in ``fwd``, one
in ``inv``) and two sums over the group (<p, A p> and r'z); the
spectral-domain steps are elementwise on each rank's pencil.  Two
all_to_alls would do with axis 0 transformed last in ``fwd``, but that
moves the bf16 rounding points of every product, so the x-update would no
longer be the single card's (on one rank it is, bit for bit on the CPU;
tests/test_torch_shard_spectral.py).

The natural-domain arm (SolverConfig(spectral_cg=False)) takes the packed
layout's ``fwd`` and ``inv`` as its preconditioner's transforms.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch

from multivartv_tpu_torch.ops import dct as dct_ops
from multivartv_tpu_torch.parallel import halo
from multivartv_tpu_torch.parallel.sharding import RowSlab, _split

# Blocks per axis of each layout: ops/dct.py's to_blocks (2) and
# to_blocks4 (4); the packed layout keeps one array.
DIGITS = {"packed": 1, "blocked": 2, "quartered": 4}


def pencil_cut(e: torch.Tensor, slab: RowSlab, div: int = 1) -> torch.Tensor:
    """This rank's pencil of a spectral block of shape (m0 / div, m1 / div,
    ...): axis 1 cut as np.array_split cuts it over the group (a part may
    be empty)."""
    cols = _split(int(e.shape[1]), slab.group.size)
    r = slab.group.rank
    return e.narrow(1, sum(cols[:r]), cols[r]).contiguous()


def _axis_fwd(x: torch.Tensor, axis: int, layout: str, op, dtype) -> List[torch.Tensor]:
    """The layout's forward transform of one axis of x (natural along it):
    its blocks along that axis, spectral, every other axis untouched; the
    products' result type dtype (the whole transform's input type, as on
    one card)."""
    xm = x.movedim(axis, 0)
    if layout == "blocked":
        outs = dct_ops.dctn_blocked(dct_ops.to_blocks(xm, 1), (op,), dtype)
    elif layout == "quartered":
        outs = dct_ops.dctn_quartered(dct_ops.to_blocks4(xm, 1), (op,), dtype)
    else:
        outs = (dct_ops.dctn_packed(xm, (op,)),)
    return [o.movedim(-1, axis) for o in outs]


def _axis_inv(blocks: Sequence[torch.Tensor], axis: int, layout: str, op,
              dtype) -> torch.Tensor:
    """The inverse of _axis_fwd: the blocks (spectral along axis) -> one
    array, natural along it."""
    bm = [b.movedim(axis, 0) for b in blocks]
    if layout == "packed":
        return dct_ops.idctn_packed(bm[0], (op,)).movedim(-1, axis)
    if layout == "blocked":
        outs = dct_ops.idctn_blocked(bm, (op,), dtype)
        nat = dct_ops.from_blocks([o.movedim(-1, 0) for o in outs], 1)
    else:
        outs = dct_ops.idctn_quartered(bm, (op,), dtype)
        nat = dct_ops.from_blocks4([o.movedim(-1, 0) for o in outs], 1)
    return nat.movedim(0, axis)


class SlabTransforms(NamedTuple):
    """fwd: (natural slab,) -> the spectral blocks on the pencil; inv: the
    way back; eigs: the eigenvalue blocks on the pencil (float32, or their
    bf16 copies in the bf16-vector regime)."""

    fwd: Callable
    inv: Callable
    eigs: Tuple[torch.Tensor, ...]


def slab_transforms(ops, layout: str, vec_bf16: bool = False) -> SlabTransforms:
    """The transforms of a spectral layout ("packed", "blocked" or
    "quartered", xupdate.spectral_layout) on ops' row slab."""
    slab = ops.slab
    grp, p, d = slab.group, len(ops.m), DIGITS[layout]
    if layout == "quartered":
        axis_ops = ops.dct_quarters_lp
        eigs = ops.gram_eigs_quartered_lp if vec_bf16 and ops.gram_eigs_quartered_lp else \
            ops.gram_eigs_quartered
    elif layout == "blocked":
        axis_ops = ops.dct_halves_lp
        eigs = ops.gram_eigs_blocked_lp if vec_bf16 and ops.gram_eigs_blocked_lp else \
            ops.gram_eigs_blocked
    else:
        axis_ops, eigs = ops.dct_halves_lp, (ops.gram_eigs_packed,)
    w = grp.size
    rows, cols = slab.row_counts, _split(int(ops.m[1]), w)
    rows_d, cols_d = _split(int(ops.m[0]) // d, w), _split(int(ops.m[1]) // d, w)

    def fwd(t):
        dt = t[0].dtype
        x = halo.to_pencils([t[0]], grp, rows, cols)[0]
        blocks = halo.to_slabs(_axis_fwd(x, 0, layout, axis_ops[0], dt), grp, rows_d, cols)
        for ax in range(1, p):
            blocks = [o for b in blocks for o in _axis_fwd(b, ax, layout, axis_ops[ax], dt)]
        return tuple(halo.to_pencils(blocks, grp, rows_d, cols_d))

    def inv(blocks):
        dt, n = blocks[0].dtype, len(blocks) // d
        cur = [_axis_inv([blocks[k * n + j] for k in range(d)], 0, layout, axis_ops[0], dt)
               for j in range(n)]
        cur = halo.to_slabs(cur, grp, rows, cols_d)
        for ax in range(1, p):
            stride = d ** (p - 1 - ax)
            cur = [_axis_inv([cur[k * stride + j] for k in range(d)], ax, layout,
                             axis_ops[ax], dt) for j in range(stride)]
        return (cur[0],)

    return SlabTransforms(fwd=fwd, inv=inv, eigs=tuple(eigs))
