"""The exact p = 1 x-update: a cyclic-reduction tridiagonal solve.

Counterpart of ``multivartv_tpu/solver/tridiag.py``.  For p = 1 the ADMM
x-update system (diag(counts) + rho D'D) theta = b is tridiagonal: D is the
forward first difference, so D'D = tridiag(-1, [1, 2, ..., 2, 1], -1) with
Neumann ends.  The reference solves it directly (SuperLU,
rcpp-code/MultivarTV/src/solvers.cpp:113); the m = N fused-lasso mesh
(vignette MultivarTV-intro.Rmd:111-118) is a first use of it.

``cr_solve`` is the JAX package's flat cyclic reduction: the system padded
to a power of two with decoupled identity rows, log2(n) elimination
levels over halving arrays, then the back-substitution.  It is the exact
route's x-update and the plain version of the hand-written kernel
``ops/kernels.py::xupdate_tridiag`` (csrc/tridiag.cu).  The JAX package's
transposed (R, 128) layout is a TPU lane trick and is not ported.

The system is symmetric positive definite and weakly diagonally dominant
(counts >= 0, some count > 0), the class for which cyclic reduction is
backward-stable; no refinement step is taken (the JAX default, refine=0).

``partition_xupdate`` is the same solve with the chain cut into segments
over the ranks of a sharded fit (the partition method, Wang 1981; SPIKE is
its general form), where the JAX package runs the cyclic reduction under
its SPMD partitioner (tridiag.py:187-251).  Each rank solves its
segment's principal submatrix A_k of the chain's system for b_k and for
the unit vectors e_0, e_L at its ends (T1's segment mode,
``ops/kernels.py::xupdate_tridiag_segment``): y, l, r.  The chain couples
segment k to its neighbours only through -g x_{k-1}[L] in its first row
and -g x_{k+1}[0] in its last, so x_k = y + g x_{k-1}[L] l + g x_{k+1}[0] r.
Taken at the segment's two ends, that is two equations per segment in the
2W end values; every rank gathers the W segments' six end values
(``all_gather``), solves the 2W-unknown banded system in float64 on its
own device and back-substitutes its own segment, in one launch
(``ops/kernels.py::partition_finish``; the same inputs and operations on
every rank give every rank the same answer, and nothing goes to the
host).  Its plain version, ``partition_finish``, is a dense float64 solve
and the back-substitution in eager PyTorch.  A_k is
a principal submatrix of an SPD matrix, so it is SPD wherever the counts
are (a segment with no counts included); a segment needs two knots.
"""

from __future__ import annotations

import torch


def _pad_pow2(a, b, c, d):
    """The system padded to the next power of two with identity rows
    (b = 1, a = c = d = 0), which solve to 0 and couple to nothing."""
    n = a.shape[-1]
    size = 1 << (n - 1).bit_length()
    if size == n:
        return a, b, c, d

    def pad(v, fill):
        return torch.cat([v, torch.full((size - n,), fill, dtype=v.dtype, device=v.device)])

    return pad(a, 0.0), pad(b, 1.0), pad(c, 0.0), pad(d, 0.0)


def _shift_up(v, fill):
    """v[1:] followed by fill: the next even row of each kept row."""
    return torch.cat([v[1:], torch.full((1,), fill, dtype=v.dtype, device=v.device)])


def _reduce(a, b, c, d):
    """One cyclic-reduction level: eliminate the even-indexed unknowns;
    returns the half-size system over the odd ones and the even rows."""
    ae, be, ce, de = a[0::2], b[0::2], c[0::2], d[0::2]
    ao, bo, co, do_ = a[1::2], b[1::2], c[1::2], d[1::2]
    be_n, ae_n = _shift_up(be, 1.0), _shift_up(ae, 0.0)
    ce_n, de_n = _shift_up(ce, 0.0), _shift_up(de, 0.0)
    alpha = ao / be
    gamma = co / be_n
    b2 = bo - alpha * ce - gamma * ae_n
    a2 = -alpha * ae
    c2 = -gamma * ce_n
    d2 = do_ - alpha * de - gamma * de_n
    return (a2, b2, c2, d2), (ae, be, ce, de)


def _backsub(y, evens):
    """The even-indexed unknowns from the solved odd ones."""
    ae, be, ce, de = evens
    y_prev = torch.cat([torch.zeros(1, dtype=y.dtype, device=y.device), y[:-1]])
    xe = (de - ae * y_prev - ce * y) / be
    return torch.stack([xe, y], dim=-1).reshape(-1)


def cr_solve(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Solve the tridiagonal system with sub-, main and super-diagonal
    (a, b, c) (a[0] = c[-1] = 0) for the right-hand side d."""
    n = a.shape[-1]
    a, b, c, d = _pad_pow2(a, b, c, d)
    stack = []
    while a.shape[-1] > 1:
        (a, b, c, d), evens = _reduce(a, b, c, d)
        stack.append(evens)
    x = d / b
    for evens in reversed(stack):
        x = _backsub(x, evens)
    return x[:n]


def _system(counts: torch.Tensor, rho, scale: float, open_lo: bool = False,
            open_hi: bool = False):
    """(a, b, c) of diag(counts) + g T, g = (rho s) s; T's diagonal is
    2 - [i = 0] - [i = n - 1], less at an open end (one inside a longer
    chain, whose T diagonal stays 2)."""
    n = counts.shape[-1]
    g = rho * scale * scale
    diag_t = torch.full((n,), 2.0, dtype=counts.dtype, device=counts.device)
    if not open_lo:
        diag_t[0] -= 1.0
    if not open_hi:
        diag_t[n - 1] -= 1.0
    off = (-g) * torch.ones(n, dtype=counts.dtype, device=counts.device)
    zero = torch.zeros(1, dtype=counts.dtype, device=counts.device)
    a = torch.cat([zero, off[1:]])       # subdiagonal, a[0] unused
    c = torch.cat([off[:-1], zero])      # superdiagonal, c[-1] unused
    return a, counts + g * diag_t, c


def xupdate_tridiag(counts: torch.Tensor, b_rhs: torch.Tensor, rho, scale: float) -> torch.Tensor:
    """The exact p = 1 x-update: x with (diag(counts) + g T) x = b_rhs,
    g = (rho s) s, s the single block's delta scale (ops/diff.py::
    delta_scales).  T is the Neumann second difference: its diagonal
    2 - [i = 0] - [i = n - 1] (0 at n = 1, where D has no rows), its
    off-diagonals -1."""
    a, b, c = _system(counts, rho, scale)
    return cr_solve(a, b, c, b_rhs)


def segment_solve(counts: torch.Tensor, b_rhs: torch.Tensor, rho, scale: float,
                  open_lo: bool, open_hi: bool) -> torch.Tensor:
    """(3, n): a segment's principal submatrix of the chain's system
    (``_system`` with its open ends) solved for b_rhs, e_0 and e_{n-1}; the
    plain version of T1's segment mode."""
    a, b, c = _system(counts, rho, scale, open_lo, open_hi)
    units = torch.zeros((2,) + tuple(b_rhs.shape), dtype=b_rhs.dtype, device=b_rhs.device)
    units[0, 0] = 1.0
    units[1, -1] = 1.0
    return torch.stack([cr_solve(a, b, c, d) for d in (b_rhs, units[0], units[1])])


def segment_ends(ylr: torch.Tensor) -> torch.Tensor:
    """The six end values (y[0], y[L], l[0], l[L], r[0], r[L]) of a segment
    solve's (3, n) output."""
    return ylr[:, [0, -1]].reshape(-1)


def partition_finish(every: torch.Tensor, rank: int, scale, ylr: torch.Tensor) -> torch.Tensor:
    """Segment ``rank``'s x from every rank's six ends and rho (W, 7) and
    its segment solve ylr (3, n); the plain version of ``ops/kernels.py::
    partition_finish``.  g is taken from rank 0's rho as T1 rounds it.  The
    unknowns z[2k] = x_k[0], z[2k + 1] = x_k[L] of the interface system
    solve z[2k + e] - g l_e z[2k - 1] - g r_e z[2k + 2] = y_e (e = 0 for
    the first row, 1 for the last; no terms past the chain's ends), as a
    dense float64 ``solve_ex``; then x = y + (g x_{k-1}[L]) l +
    (g x_{k+1}[0]) r, each weight rounded to float32 once."""
    g = ((every[0, 6] * scale) * scale).double()
    ends = every[:, :6].double()
    w, dev = ends.shape[0], ends.device
    a = torch.eye(2 * w, dtype=torch.float64, device=dev)
    inner = torch.arange(1, w, device=dev)     # segments with a left neighbour
    for e in (0, 1):
        a[2 * inner + e, 2 * inner - 1] = -g * ends[1:, 2 + e]
        a[2 * inner - 2 + e, 2 * inner] = -g * ends[:-1, 4 + e]
    z = torch.linalg.solve_ex(a, ends[:, :2].reshape(-1, 1))[0].reshape(-1)
    zero = z.new_zeros(())
    cl = g * (z[2 * rank - 1] if rank > 0 else zero)
    cr = g * (z[2 * rank + 2] if rank < w - 1 else zero)
    return (ylr[0] + cl.to(ylr.dtype) * ylr[1]) + cr.to(ylr.dtype) * ylr[2]


def partition_xupdate(counts: torch.Tensor, b_rhs: torch.Tensor, rho, scale: float,
                      slab) -> torch.Tensor:
    """The exact p = 1 x-update on this rank's segment (a RowSlab of a 1-D
    lattice; see the module doc): T1's segment mode, an all_gather of the
    six end values and rho, and the finish kernel (the interface solve and
    the back-substitution).  A group of one runs T1 on the whole chain."""
    from multivartv_tpu_torch.ops import kernels

    grp = slab.group
    if grp.size == 1:
        return kernels.xupdate_tridiag(counts, b_rhs, rho, scale)
    import torch.distributed as dist

    lo = slab.row_off
    ylr = kernels.xupdate_tridiag_segment(counts, b_rhs, rho, scale, lo > 0,
                                          lo + counts.shape[0] < slab.m[0])
    mine = torch.cat([segment_ends(ylr), torch.as_tensor(rho, dtype=ylr.dtype,
                                                         device=ylr.device).reshape(1)])
    every = [torch.empty_like(mine) for _ in range(grp.size)]
    dist.all_gather(every, mine, group=grp.group)
    return kernels.partition_finish(torch.stack(every), grp.rank, scale, ylr)


def tridiag_applies(ops, cfg) -> bool:
    """Whether the exact CR x-update serves the problem: p = 1 with the
    dct_pcg x-solver (the other x_solver values are a user's explicit
    choice and keep their meaning)."""
    return len(ops.m) == 1 and len(ops.binaries) == 1 and cfg.x_solver == "dct_pcg"
