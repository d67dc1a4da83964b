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


def xupdate_tridiag(counts: torch.Tensor, b_rhs: torch.Tensor, rho, scale: float) -> torch.Tensor:
    """The exact p = 1 x-update: x with (diag(counts) + g T) x = b_rhs,
    g = (rho s) s, s the single block's delta scale (ops/diff.py::
    delta_scales).  T is the Neumann second difference: its diagonal
    2 - [i = 0] - [i = n - 1] (0 at n = 1, where D has no rows), its
    off-diagonals -1."""
    n = counts.shape[-1]
    g = rho * scale * scale
    diag_t = torch.full((n,), 2.0, dtype=counts.dtype, device=counts.device)
    diag_t[0] -= 1.0
    diag_t[n - 1] -= 1.0
    off = (-g) * torch.ones(n, dtype=counts.dtype, device=counts.device)
    zero = torch.zeros(1, dtype=counts.dtype, device=counts.device)
    a = torch.cat([zero, off[1:]])       # subdiagonal, a[0] unused
    c = torch.cat([off[:-1], zero])      # superdiagonal, c[-1] unused
    return cr_solve(a, counts + g * diag_t, c, b_rhs)


def tridiag_applies(ops, cfg) -> bool:
    """Whether the exact CR x-update serves the problem: p = 1 with the
    dct_pcg x-solver (the other x_solver values are a user's explicit
    choice and keep their meaning)."""
    return len(ops.m) == 1 and len(ops.binaries) == 1 and cfg.x_solver == "dct_pcg"
