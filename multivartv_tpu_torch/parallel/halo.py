"""The collectives of the sharded fit, written out, and the explicit
row-slab ADMM solver.

Counterpart of ``multivartv_tpu/parallel/halo.py``.  The JAX package spells
its collectives out only here and leaves the product path to the XLA SPMD
partitioner; the port has no partitioner, so every collective of the
sharded fit lives in this module, on ``torch.distributed``:

  * the halo exchange: ``halo_rows`` hands each rank its neighbours'
    boundary rows (planes at p = 3, knots at p = 1) of several slabs at
    once (one ``batch_isend_irecv``), zeros at the global edges;
    ``dist_shift_down`` / ``dist_shift_up`` are the JAX package's global
    circular shifts along the row axis;
  * sums and maxima over the row group (``psum``, ``pmax``): every CG dot,
    every norm and the Boyd sums, so that each host decision (a loop
    predicate, rho adaptation, the NaN guard) reads the same value on every
    rank and no rank takes another branch;
  * the pencil transposes ``rows_to_cols`` / ``cols_to_rows`` and, for
    several arrays in one call, ``to_pencils`` / ``to_slabs``
    (``all_to_all_single``): the x-update's DCT transforms run along axes
    1 .. p - 1 on the slabs and along axis 0 on the pencils, slabs of axis
    1 with every other axis whole;
  * ``gather_rows`` (every rank gets the whole lattice), its host form
    ``gather_rows_to_host`` (the fit's thetas, one lambda at a time),
    ``gather_fitted`` (every rank gets every sample's fitted value),
    ``gather_folds`` (every rank gets every CV fold's held-out MSEs from
    the fold axis "dp") and ``broadcast_each`` (the fold axis's first
    replica of the final path on every rank).

A group of size 1 makes no call.  The stencils of the operator D on the
slabs (``slab_apply_D``, ``slab_apply_Dt``; any p and block set) exchange
one halo row, plane or knot.

``sharded_admm_solve`` is the JAX package's explicit solver: p = 2, the
full block set, Jacobi-preconditioned CG with every collective by hand,
Boyd stopping and adaptive rho, on row slabs.  The product path is
``parallel.fit.mvtv_sharded``, which runs the solver's shard route
(solver/admm.py) with the row-slab kernels (parallel/tiled_shard.py).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multivartv_tpu_torch.config import SolverConfig
from multivartv_tpu_torch.ops import diff as diff_ops
from multivartv_tpu_torch.ops import kernels as K
from multivartv_tpu_torch.parallel.sharding import RowGroup, RowSlab


# ---------------------------------------------------------------------------
# Sums, exchanges, transposes and gathers
# ---------------------------------------------------------------------------

def psum(x: torch.Tensor, grp: RowGroup) -> torch.Tensor:
    """The sum of x over the group (a new tensor)."""
    if grp.size == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=grp.group)
    return out


def pmax(x: torch.Tensor, grp: RowGroup) -> torch.Tensor:
    """The maximum of x over the group (a new tensor)."""
    if grp.size == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=grp.group)
    return out


def _exchange(grp: RowGroup, first: torch.Tensor, last: torch.Tensor, ring: bool):
    """(from_prev, from_next): the previous rank's `last` rows and the next
    rank's `first` rows; at the global edges zeros, or with ring the
    wrapped ranks' rows.  The four transfers are posted in one order on
    every rank, so that two ranks that are each other's previous and next
    (a ring of two) match them pairwise."""
    from_prev, from_next = torch.zeros_like(last), torch.zeros_like(first)
    n, r = grp.size, grp.rank
    if n == 1:
        return (last.clone(), first.clone()) if ring else (from_prev, from_next)
    prev, nxt = r - 1, r + 1
    if ring:
        prev, nxt = prev % n, nxt % n
    ops = []
    if nxt < n:
        ops.append(dist.P2POp(dist.isend, last.contiguous(), grp.peer(nxt), grp.group))
    if prev >= 0:
        ops.append(dist.P2POp(dist.irecv, from_prev, grp.peer(prev), grp.group))
        ops.append(dist.P2POp(dist.isend, first.contiguous(), grp.peer(prev), grp.group))
    if nxt < n:
        ops.append(dist.P2POp(dist.irecv, from_next, grp.peer(nxt), grp.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


def halo_rows(grp: RowGroup, xs: Sequence[torch.Tensor], depth: int = 1
              ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(tops, bots): for each row slab x of xs, the previous rank's last
    `depth` rows and the next rank's first `depth` rows, (depth, m1) each,
    zeros at the global edges (the padded-block edge-zero convention): the
    halo arrays of the row-slab kernels, all exchanged in one call."""
    first = torch.cat([x[:depth] for x in xs])
    last = torch.cat([x[-depth:] for x in xs])
    top, bot = _exchange(grp, first, last, ring=False)
    return list(top.split(depth)), list(bot.split(depth))


def halo_pair(x: torch.Tensor, grp: RowGroup, depth: int = 1):
    """(top, bot) of one row slab (halo_rows of one array)."""
    (top,), (bot,) = halo_rows(grp, [x], depth)
    return top, bot


def dist_shift_down(x: torch.Tensor, grp: RowGroup) -> torch.Tensor:
    """Global circular out[i] = x[i + 1] along the row axis."""
    _, from_next = _exchange(grp, x[:1], x[-1:], ring=True)
    return torch.cat([x[1:], from_next])


def dist_shift_up(x: torch.Tensor, grp: RowGroup) -> torch.Tensor:
    """Global circular out[i] = x[i - 1] along the row axis."""
    from_prev, _ = _exchange(grp, x[:1], x[-1:], ring=True)
    return torch.cat([from_prev, x[:-1]])


def gather_rows(x: torch.Tensor, slab: RowSlab) -> torch.Tensor:
    """The whole lattice on every rank from each rank's slab x (a leading
    batch axis stays)."""
    grp = slab.group
    if grp.size == 1:
        return x
    axis = x.ndim - len(slab.m)
    rows = slab.row_counts
    shape = list(x.shape)
    shape[axis] = max(rows)
    pad = torch.zeros(shape, dtype=x.dtype, device=x.device)
    pad.narrow(axis, 0, x.shape[axis]).copy_(x)
    out = [torch.empty_like(pad) for _ in range(grp.size)]
    dist.all_gather(out, pad, group=grp.group)
    return torch.cat([o.narrow(axis, 0, r) for o, r in zip(out, rows)], dim=axis)


def gather_rows_to_host(x: torch.Tensor, slab: RowSlab) -> torch.Tensor:
    """The whole lattice on the host (a CPU tensor) on every rank from each
    rank's slab x; a leading axis (the path's lambdas) is gathered one
    element at a time, so the device holds one gathered lattice at most,
    and only until its copy."""
    if x.ndim > len(slab.m):
        return torch.stack([gather_rows_to_host(t, slab) for t in x])
    return gather_rows(x, slab).cpu()


def rows_to_cols(x: torch.Tensor, slab: RowSlab) -> torch.Tensor:
    """(rows, m1, ...) slab -> (m0, cols, ...) pencil of the same lattice
    (p >= 2)."""
    if slab.group.size == 1:
        return x
    return to_pencils([x], slab.group, slab.row_counts, slab.col_counts)[0]


def cols_to_rows(x: torch.Tensor, slab: RowSlab) -> torch.Tensor:
    """(m0, cols, ...) pencil -> (rows, m1, ...) slab of the same lattice
    (p >= 2)."""
    if slab.group.size == 1:
        return x
    return to_slabs([x], slab.group, slab.row_counts, slab.col_counts)[0]


def to_pencils(xs: Sequence[torch.Tensor], grp: RowGroup, rows: Sequence[int],
               cols: Sequence[int]) -> List[torch.Tensor]:
    """Slabs -> pencils of several arrays of one shape in one all_to_all:
    each x is this rank's (rows[rank], n1, ...) slab of an (sum(rows), n1,
    ...) array, returned as its (sum(rows), cols[rank], ...) pencil; cols
    cuts n1 (a part may be empty)."""
    if grp.size == 1:
        return list(xs)
    me = grp.rank
    tail = tuple(xs[0].shape[2:])
    rest = int(np.prod(tail, dtype=np.int64)) * len(xs)
    stack = torch.stack(list(xs), 1)                       # (rows, B, n1, ...)
    send = torch.cat([blk.reshape(-1) for blk in stack.split(list(cols), dim=2)])
    out = torch.empty(sum(rows) * cols[me] * rest, dtype=stack.dtype, device=stack.device)
    dist.all_to_all_single(out, send, output_split_sizes=[r * cols[me] * rest for r in rows],
                           input_split_sizes=[rows[me] * c * rest for c in cols],
                           group=grp.group)
    return list(out.view((sum(rows), len(xs), cols[me]) + tail).unbind(1))


def to_slabs(xs: Sequence[torch.Tensor], grp: RowGroup, rows: Sequence[int],
             cols: Sequence[int]) -> List[torch.Tensor]:
    """Pencils -> slabs, the inverse of to_pencils."""
    if grp.size == 1:
        return list(xs)
    me = grp.rank
    tail = tuple(xs[0].shape[2:])
    rest = int(np.prod(tail, dtype=np.int64)) * len(xs)
    stack = torch.stack(list(xs), 1)                       # (m0, B, cols, ...)
    out = torch.empty(rows[me] * sum(cols) * rest, dtype=stack.dtype, device=stack.device)
    dist.all_to_all_single(out, stack.reshape(-1),
                           output_split_sizes=[rows[me] * c * rest for c in cols],
                           input_split_sizes=[r * cols[me] * rest for r in rows],
                           group=grp.group)
    parts = [blk.view((rows[me], len(xs), c) + tail)
             for blk, c in zip(out.split([rows[me] * c * rest for c in cols]), cols)]
    return list(torch.cat(parts, dim=2).unbind(1))


def gather_folds(x: torch.Tensor, grp: RowGroup) -> torch.Tensor:
    """The ranks' blocks x (k, ...) of a fold axis, concatenated along axis 0
    in rank order on every rank of the group (the fold group of
    make_device_mesh: rank d holds folds d k .. (d + 1) k - 1)."""
    if grp.size == 1:
        return x
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(grp.size)]
    dist.all_gather(out, x, group=grp.group)
    return torch.cat(out)


def broadcast_each(xs: Sequence, grp: RowGroup) -> List:
    """Each tensor of xs (None stays None) as the group's rank 0 holds it,
    on every rank of the group (new tensors; a host tensor goes through
    the device of the first device tensor of xs, for NCCL)."""
    if grp.size == 1:
        return list(xs)
    dev = next((x.device for x in xs if x is not None and x.device.type != "cpu"), None)
    out = []
    for x in xs:
        if x is None:
            out.append(None)
            continue
        t = x.to(dev).contiguous().clone() if dev is not None else x.contiguous().clone()
        dist.broadcast(t, src=grp.peer(0), group=grp.group)
        out.append(t.to(x.device))
    return out


def gather_fitted(theta: torch.Tensor, flat_idx: torch.Tensor, slab: RowSlab) -> torch.Tensor:
    """O theta on every rank from each rank's slab: each rank fills the
    samples whose knot lies in its slab, and the sum over the group (one
    nonzero term per sample) gives every value exactly."""
    lo = slab.row_off * int(np.prod(slab.m[1:], dtype=np.int64))
    local = flat_idx - lo
    mine = (local >= 0) & (local < theta.numel())
    vals = theta.reshape(-1)[local.clamp(0, theta.numel() - 1)]
    return psum(torch.where(mine, vals, torch.zeros_like(vals)), slab.group)


# ---------------------------------------------------------------------------
# D and D' on the slabs (the full block set)
# ---------------------------------------------------------------------------

def slab_apply_D(theta: torch.Tensor, slab: RowSlab, scales,
                 binaries=None) -> Tuple[torch.Tensor, ...]:
    """The blocks of D theta on this rank's slab (the row, plane or knot
    above from the next rank); binaries: the blocks in use (None: the full
    set), with their scales."""
    if len(slab.m) != 2 or (binaries is not None and len(binaries) != 3):
        return _slab_apply_D(theta, slab, scales, binaries)
    top, bot = halo_pair(theta, slab.group)
    panel = K._slab_panel(theta, top, bot)
    mask0, mask1, _ = K._slab_masks(panel, slab.row_off, slab.m[0])
    d0 = K._fwd0(panel, mask0)
    s_mix, s_ax1, s_ax0 = scales
    blocks = (s_mix * K._fwd1(d0, mask1), s_ax1 * K._fwd1(panel, mask1), s_ax0 * d0)
    return tuple(b[1:-1] for b in blocks)


def slab_apply_Dt(blocks, slab: RowSlab, scales, binaries=None) -> torch.Tensor:
    """D' of the blocks on this rank's slab (the blocks with an axis-0
    part: their row, plane or knot below from the previous rank)."""
    if len(slab.m) != 2 or (binaries is not None and len(binaries) != 3):
        return _slab_apply_Dt(blocks, slab, scales, binaries)
    b0, b1, b2 = blocks
    (t0, t2), _ = halo_rows(slab.group, [b0, b2])
    zero = torch.zeros_like(b1[:1])
    return K._adjD(torch.cat([t0, b0]), torch.cat([zero, b1]), torch.cat([t2, b2]),
                   scales)[1:]


def _slab_apply_D(theta, slab: RowSlab, scales, binaries=None):
    """slab_apply_D off the p = 2 full set: each block's forward chain on
    the slab's panel (its planes -1 .. rows), the axis-0 mask on the global
    planes, as ops/diff.py::apply_D computes it on the whole lattice."""
    if binaries is None:
        binaries = diff_ops.fd_binaries(len(slab.m))
    top, bot = halo_pair(theta, slab.group)
    panel = torch.cat([top, theta, bot])
    mask0 = K._global_mask0(panel, slab.row_off, slab.m[0])
    return tuple(s * K._panel_block(panel, b, mask0)[1:-1] for b, s in zip(binaries, scales))


def _slab_apply_Dt(blocks, slab: RowSlab, scales, binaries=None):
    """slab_apply_Dt off the p = 2 full set: each block's adjoint chain,
    the blocks with an axis-0 part on their panel (the plane below from the
    previous rank), added in the blocks' order as apply_Dt adds them."""
    if binaries is None:
        binaries = diff_ops.fd_binaries(len(slab.m))
    down = [k for k, b in enumerate(binaries) if b[0]]
    tops, _ = halo_rows(slab.group, [blocks[k] for k in down])
    below = dict(zip(down, tops))
    out = None
    for k, (a, b, s) in enumerate(zip(blocks, binaries, scales)):
        if b[0]:
            term = s * diff_ops.adjoint_block(torch.cat([below[k], a]), b)[1:]
        else:
            term = s * diff_ops.adjoint_block(a, b)
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# The explicit solver (the JAX package's sharded_admm_solve, on row slabs)
# ---------------------------------------------------------------------------

class _DistStencil2D:
    """D and D' on row slabs through the global circular shifts, as the JAX
    package's _DistStencil2D spells them (forward differences masked on the
    global last row, adjoints plain circular shifts)."""

    def __init__(self, slab: RowSlab, scales, device):
        self.slab = slab
        self.s_mix, self.s_ax1, self.s_ax0 = scales
        rows = torch.arange(slab.shape[0], device=device)[:, None] + slab.row_off
        self.edge0 = (rows < slab.m[0] - 1).float()
        self.edge1 = (torch.arange(slab.m[1], device=device) < slab.m[1] - 1).float()[None, :]

    def _fwd(self, v, axis):
        if axis == 0:
            return (dist_shift_down(v, self.slab.group) - v) * self.edge0
        return (torch.roll(v, -1, 1) - v) * self.edge1

    def _adj(self, w, axis):
        if axis == 0:
            return dist_shift_up(w, self.slab.group) - w
        return torch.roll(w, 1, 1) - w

    def apply_D(self, theta):
        d0 = self._fwd(theta, 0)
        return (self.s_mix * self._fwd(d0, 1), self.s_ax1 * self._fwd(theta, 1),
                self.s_ax0 * d0)

    def apply_Dt(self, blocks):
        b0, b1, b2 = blocks
        return (self.s_mix * self._adj(self._adj(b0, 1), 0) + self.s_ax1 * self._adj(b1, 1)
                + self.s_ax0 * self._adj(b2, 0))

    def apply_gram(self, v):
        return self.apply_Dt(self.apply_D(v))

    def psum(self, x):
        return psum(x, self.slab.group)


class ShardedADMMResult(NamedTuple):
    theta: torch.Tensor
    rho: torch.Tensor
    iters: int


def sharded_admm_solve(group: RowGroup, counts, oty, gram_diag, ybar, scales, lam, rho0,
                       cfg: SolverConfig) -> ShardedADMMResult:
    """ADMM with Boyd stopping and adaptive rho on a 2-D lattice cut into row
    slabs over group, every collective explicit (JAX halo.py:161-251):
    Jacobi-preconditioned CG of cfg.cg_fixed_iters (default 10) steps.
    counts, oty, gram_diag: the global lattice arrays, on every rank; returns
    the global theta on every rank."""
    m = tuple(int(v) for v in counts.shape)
    slab = RowSlab(group, m)
    counts_l, oty_l, gdiag_l = slab.rows(counts), slab.rows(oty), slab.rows(gram_diag)
    dtype, dev = oty.dtype, oty.device
    ntheta = m[0] * m[1]
    rows_d = float((m[0] - 1) * (m[1] - 1) + m[0] * (m[1] - 1) + (m[0] - 1) * m[1])
    sqrt_ntheta, sqrt_rowsd = math.sqrt(ntheta), math.sqrt(rows_d)
    st = _DistStencil2D(slab, scales, dev)
    tol = cfg.tol
    eps = 1e-30
    n_cg = cfg.cg_fixed_iters if cfg.cg_fixed_iters is not None else 10

    def pcg(b, x0, rho):
        def matvec(v):
            return counts_l * v + rho * st.apply_gram(v)

        inv_diag = 1.0 / (counts_l + rho * gdiag_l + 1e-30)
        r = b - matvec(x0)
        z = inv_diag * r
        rz = st.psum(torch.sum(r * z))
        p, x = z, x0
        for _ in range(n_cg):
            ap = matvec(p)
            pap = st.psum(torch.sum(p * ap))
            a = rz / torch.clamp_min(pap, eps)
            x = x + a * p
            r = r - a * ap
            z = inv_diag * r
            rz_new = st.psum(torch.sum(r * z))
            beta = rz_new / torch.clamp_min(rz, eps)
            p = z + beta * p
            rz = rz_new
        return x

    theta = torch.zeros_like(counts_l) + torch.as_tensor(ybar, dtype=dtype, device=dev)
    alpha = st.apply_D(theta)
    u = tuple(torch.zeros_like(a) for a in alpha)
    rho = torch.as_tensor(rho0, dtype=dtype, device=dev).reshape(())
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    pn = dn = torch.ones((), dtype=dtype, device=dev)
    ep = ed = torch.zeros((), dtype=dtype, device=dev)
    counter = 0
    while counter < cfg.max_iters and bool((dn > ed) | (pn > ep)):
        au = tuple(a + w for a, w in zip(alpha, u))
        b = oty_l + rho * st.apply_Dt(au)
        theta = pcg(b, theta, rho)
        d_theta = st.apply_D(theta)
        kappa = lam / rho
        alpha = tuple(K._soft(dt - w, kappa) for dt, w in zip(d_theta, u))
        res = tuple(a - dt for a, dt in zip(alpha, d_theta))
        u = tuple(w + r for w, r in zip(u, res))
        dtr = st.apply_Dt(res)
        dtu = st.apply_Dt(u)
        pn = torch.sqrt(st.psum(sum(torch.sum(r * r) for r in res)))
        dn = rho * torch.sqrt(st.psum(torch.sum(dtr * dtr)))
        dtu_n = torch.sqrt(st.psum(torch.sum(dtu * dtu)))
        dt_n = torch.sqrt(st.psum(sum(torch.sum(d * d) for d in d_theta)))
        al_n = torch.sqrt(st.psum(sum(torch.sum(a * a) for a in alpha)))
        ed = tol * (sqrt_ntheta + dtu_n)
        ep = tol * (sqrt_rowsd + torch.maximum(dt_n, al_n))
        if cfg.adapt_rho:
            grow = pn > cfg.adapt_band * dn
            shrink = dn > cfg.adapt_band * pn
            f = torch.where(grow, torch.full_like(rho, cfg.adapt_tau),
                            torch.where(shrink, torch.full_like(rho, 1.0 / cfg.adapt_tau),
                                        torch.ones_like(rho)))
            rho = rho * f
            u = tuple(w / f for w in u)
        counter += 1
    return ShardedADMMResult(theta=gather_rows(theta, slab), rho=rho, iters=counter)
