"""The hand-written CUDA kernels of the ADMM path, their wrappers and
their plain PyTorch versions.

Counterpart of every TPU kernel of ``multivartv_tpu/ops/pallas_kernels.py``:
the eight whole-lattice kernels (up to 2^20 knots), the four tiled kernels
of the large-lattice 2-D route (above 2^20 knots), the three of p = 3 and
the three row-slab kernels of the sharded route:

  ============================  ===========================================  =======================
  wrapper                       replaces (pallas_kernels.py)                 CUDA source (csrc/)
  ============================  ===========================================  =======================
  dual_update_2d                _dual_update_kernel (B1)                     dual.cu
  rhs_2d                        _rhs_kernel (B2)                             rhs.cu
  xupdate_pcg_2d_packed         _xupdate_kernel_packed (B3)                  xupdate.cu, dct_fold.cu
  admm_iters_2d                 _admm_iters_kernel/_admm_chain (B4)          chain.cu (+ the above)
  admm_iters_2d_batched         _admm_iters_batched_kernel/_admm_chain (B5)  chain.cu (+ the above)
  xupdate_pcg_2d                _xupdate_kernel (B6)                         xupdate.cu, dct_mma.cu
  gram_matvec_2d                _gram_matvec_kernel (B7)                     tiled.cu
  dual_update_tiled_2d          _tiled_dual_kernel (B8)                      tiled.cu, dual.cu
  gram_residual_tiled_2d        _tiled_gram_res_kernel (B9)                  tiled.cu
  gram_matvec_tiled_2d          _tiled_gram_kernel (B10)                     tiled.cu
  rhs_tiled_2d                  _tiled_rhs_kernel (B11)                      rhs.cu
  dual_update_tiled_3d          _tiled3_dual_kernel (B12)                    tiled3.cu
  rhs_tiled_3d                  _tiled3_rhs_kernel (B14)                     tiled3.cu
  gram_residual_tiled_3d        _tiled3_gram_res_kernel (B13)                tiled3.cu
  dual_update_tiled_2d_shard    _tiled_dual_kernel, sharded (B8s)            dual.cu
  gram_residual_tiled_2d_shard  _tiled_gram_res_kernel, sharded (B9s)        tiled.cu
  rhs_tiled_2d_shard            _tiled_rhs_kernel, sharded (B11s)            rhs.cu
  dual_update_tiled_3d_shard    none: XLA under SPMD in JAX (B12s)           tiled3.cu
  gram_residual_tiled_3d_shard  none: XLA under SPMD in JAX (B13s)           tiled3.cu
  xupdate_tridiag               none: XLA in JAX, solver/tridiag.py:208 (T1) tridiag.cu
  ============================  ===========================================  =======================

B4 is the B = 1 case of B5's launcher: one persistent cooperative launch
runs K whole iterations of B problems, each stage a grid-stride loop over
the items of every problem with a grid barrier after it
(csrc/chain.cu; ``chain_plan`` sizes its grid and lays out its partial
sums).  B3-B5's folded DCT products run on the tensor cores from padded
bf16 operands, the spectral scale fused into the forward transform
(csrc/fold.cuh: B3's stage kernels in csrc/dct_fold.cu and B4/B5's
kernel share one tile function).  B6 is B3's chain with the dense
bf16 DCT matrices (any axes), its products on the tensor cores; B7 is B10's
row march (on 16-byte aligned rows) in a mode that also sums <v, A v>, its
last CTA adding the partials, one launch.  B8 is B1's stage kernel with two
template flags, B8s the same kernel in its slab mode; B9s, its matvec mode
and B10 (on 16-byte aligned rows) are one row march (csrc/tiled.cu).  B2
is one launch, and B11 is B2's kernel, which takes any m0, m1.  B11, B14
and B11s have no ADMM caller, as in the JAX package.
``gram_matvec_tiled_2d_shard`` is B9s's kernel in its matvec mode, the
sharded PCG's matvec (the JAX package leaves it to XLA).  B12s and B13s
are B12's and B13's plane marches in a slab mode (one rank's plane slab of
a 3-D lattice, the halo planes read in place of the wrapped ones), and
``gram_matvec_tiled_3d_shard``, the sharded p = 3 PCG's matvec, is a march
of its own over the same slab: (counts + rho D'D) v as per-axis Neumann
Laplacians, 9-point stencils within a plane and a 3-plane one along the
march (csrc/tiled3.cu, ``lap3_matvec_kernel``).
``xupdate_tridiag_segment`` is T1 in its segment mode: one rank's segment
of a chain, solved for b and the unit vectors at its two ends in one
launch (the p = 1 partition solve, solver/tridiag.py); ``partition_finish``
is that solve's last step, the interface system of the gathered segment
ends and this rank's back-substitution, in one launch.
``xupdate_tridiag`` (T1) is the exact p = 1 x-update, which the JAX package
runs as one fused XLA program: one launch of the segment solve (each CTA
a segment of rows in shared memory, a grid barrier between) up to ~1.6 M
knots, a multi-level partition solve above (csrc/tridiag.cu); its plain
version is the cyclic reduction of solver/tridiag.py.
``stream_copy`` and ``dual_struct`` (csrc/probe.cu) are measurement probes
that no path launches.

Each wrapper dispatches on the device of the tensors it is given: CPU
tensors go to the plain version (``<name>_reference``), CUDA tensors launch
the kernel on the current stream, or raise if it fails to build or launch;
any other device raises.  There is no fallback from the card to the plain
version.  Each launch adds one to ``launch_counts[<name>]``.

Lattices are float32, C-contiguous (m0, m1) or (m0, m1, m2); blocks follow
fd_binaries(2) = ((1,1), (0,1), (1,0)) and fd_binaries(3) = BINARIES3; the
DCT halves and dense matrices are bf16.  The plain
versions compute what the kernels compute, in the TPU kernels' operation
order; the DCT products round their operands to bf16 and multiply in
float32 (ops/dct.py::dct2_packed).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from multivartv_tpu_torch.ops import _build
from multivartv_tpu_torch.ops import dct as dct_ops
from multivartv_tpu_torch.ops import diff as diff_ops
from multivartv_tpu_torch.solver import tridiag

# Slots of the kernels' scalar buffer (csrc/common.cuh).
S_LAM, S_RHO, S_USCALE, S_CBAR, S_KAPPA, S_STATS, S_CG = 0, 1, 2, 3, 4, 5, 11
EPS = 1e-30

KERNELS = ("dual_update_2d", "rhs_2d", "xupdate_pcg_2d_packed", "admm_iters_2d",
           "admm_iters_2d_batched", "xupdate_pcg_2d", "gram_matvec_2d", "dual_update_tiled_2d",
           "gram_residual_tiled_2d", "gram_matvec_tiled_2d", "rhs_tiled_2d",
           "dual_update_tiled_3d", "gram_residual_tiled_3d", "rhs_tiled_3d",
           "dual_update_tiled_2d_shard", "gram_residual_tiled_2d_shard",
           "gram_matvec_tiled_2d_shard", "rhs_tiled_2d_shard", "dual_struct",
           "xupdate_tridiag", "dual_update_tiled_3d_shard", "gram_residual_tiled_3d_shard",
           "gram_matvec_tiled_3d_shard", "xupdate_tridiag_segment", "partition_finish")
# The p = 3 block set in fd_binaries(3) order (pallas_kernels.py:1930).
BINARIES3 = ((1, 1, 1), (0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1), (1, 1, 0))
launch_counts = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# Plain versions (the TPU kernels' arithmetic, in the same order)
# ---------------------------------------------------------------------------

def _masks(shape, dtype, device):
    m0, m1 = shape
    mask0 = (torch.arange(m0, device=device) < m0 - 1).to(dtype)[:, None]
    mask1 = (torch.arange(m1, device=device) < m1 - 1).to(dtype)[None, :]
    return mask0, mask1


def _wmasks2(shape, true_m, dtype, device, row0: int = 0):
    """Per-block TRUE-problem row masks (w_mix, w_ax1, w_ax0) of the exact
    padded route, or None (pallas_kernels.py:_wmasks2); row0: the global
    row of row 0 (a slab's panel)."""
    if true_m is None:
        return None
    t0, t1 = int(true_m[0]), int(true_m[1])
    row = torch.arange(shape[0], device=device)[:, None] + row0
    col = torch.arange(shape[1], device=device)[None, :]
    rA, rB = (row < t0 - 1).to(dtype), (row < t0).to(dtype)
    cA, cB = (col < t1 - 1).to(dtype), (col < t1).to(dtype)
    return (rA * cA, rB * cA, rA * cB)


def _slab_panel(x, top, bot):
    """A row slab with its halo rows: (m0 + 2, m1), rows -1 .. m0."""
    return torch.cat([top[-1:], x, bot[:1]])


def _panel_rows(panel, row_off: int):
    """The global rows of a slab's panel, a column."""
    return torch.arange(panel.shape[0], device=panel.device)[:, None] + (row_off - 1)


def _slab_masks(panel, row_off: int, m0_global: int):
    """(mask0, mask1, valid) of a slab's panel: the axis-0 difference's
    mask on global rows (0 above the lattice and on its last row) and the
    TPU kernels' `valid` (0 above the lattice)."""
    g = _panel_rows(panel, row_off)
    mask0 = ((g >= 0) & (g < m0_global - 1)).to(panel.dtype)
    m1 = panel.shape[1]
    mask1 = (torch.arange(m1, device=panel.device) < m1 - 1).to(panel.dtype)[None, :]
    return mask0, mask1, (g >= 0).to(panel.dtype)


def _fwd0(v, mask0):
    return (torch.roll(v, -1, 0) - v) * mask0


def _fwd1(v, mask1):
    return (torch.roll(v, -1, 1) - v) * mask1


def _adj0(w):
    return torch.roll(w, 1, 0) - w


def _adj1(w):
    return torch.roll(w, 1, 1) - w


def _adjD(w0, w1, w2, scales):
    s_mix, s_ax1, s_ax0 = scales
    return s_mix * _adj0(_adj1(w0)) + s_ax1 * _adj1(w1) + s_ax0 * _adj0(w2)


def _gram_g(v, counts, g, masks):
    """counts v + sum_b g_b adj_b(fwd_b(v)), g = rho s_b^2 per block."""
    g_mix, g_ax1, g_ax0 = g
    mask0, mask1 = masks
    d1 = _fwd1(v, mask1)
    d0 = _fwd0(v, mask0)
    dm = _fwd1(d0, mask1)
    acc = g_ax1 * _adj1(d1) + g_ax0 * _adj0(d0) + g_mix * _adj0(_adj1(dm))
    return counts * v + acc


def _gram(v, counts, rho, scales, masks):
    """(diag(counts) + rho D'D) v, with the whole-lattice kernels' scalars
    (rho s) s."""
    return _gram_g(v, counts, tuple(rho * s * s for s in scales), masks)


def _gram_tiled(v, counts, rho, scales):
    """(diag(counts) + rho D'D) v with the tiled kernels' scalars rho (s^2)
    (pallas_kernels.py:1736-1741, s^2 rounded to float32)."""
    g = tuple(rho * float(np.float32(s) * np.float32(s)) for s in scales)
    return _gram_g(v, counts, g, _masks(v.shape, v.dtype, v.device))


def _soft(z, k):
    return torch.sign(z) * torch.clamp_min(torch.abs(z) - k, 0.0)


def rhs_2d_reference(alpha, u, oty, rho, u_scale, scales):
    """b = oty + rho D'(alpha + u_scale u)."""
    us = 1.0 if u_scale is None else u_scale
    w = [a + us * v for a, v in zip(alpha, u)]
    return oty + rho * _adjD(*w, scales)


def _dual_stage(theta, u, kappa, scales, u_scale, wm, masks, valid=None, rows=slice(None)):
    """The z/dual stage (alpha, u_new, stats, dtu) on theta and u with the
    axis masks (mask0, mask1), the true-row masks wm and, on a slab's panel,
    the `valid` mask; alpha and u_new cover every row, the stats and dtu =
    D'u_new the rows `rows` (a panel's own rows)."""
    s_mix, s_ax1, s_ax0 = scales
    mask0, mask1 = masks
    d0 = _fwd0(theta, mask0)
    dt = (s_mix * _fwd1(d0, mask1), s_ax1 * _fwd1(theta, mask1), s_ax0 * d0)
    us = 1.0 if u_scale is None else u_scale
    ue = tuple(us * v for v in u)
    if valid is not None:
        dt = (dt[0], dt[1] * valid, dt[2])
        ue = tuple(e * valid for e in ue)
    ks = (kappa,) * 3 if wm is None else tuple(kappa * w for w in wm)
    alpha = tuple(_soft(d - e, k) for d, e, k in zip(dt, ue, ks))
    r = tuple(a - d for a, d in zip(alpha, dt))
    u_new = tuple(e + rr for e, rr in zip(ue, r))
    sd, sa = (dt, alpha) if wm is None else (
        tuple(d * w for d, w in zip(dt, wm)), tuple(a * w for a, w in zip(alpha, wm)))
    dtr = _adjD(*r, scales)[rows]
    dtu = _adjD(*u_new, scales)[rows]
    stats = torch.stack([
        sum(torch.sum(x[rows] * x[rows]) for x in r),
        sum(torch.sum(x[rows] * x[rows]) for x in sd),
        sum(torch.sum(x[rows] * x[rows]) for x in sa),
        torch.sum(dtr * dtr),
        torch.sum(dtu * dtu),
    ])
    return alpha, u_new, stats, dtu


def dual_update_2d_reference(theta, u, kappa, scales, u_scale=None, true_m=None):
    """(alpha (3), u_new (3), stats (5,)): the z/dual stage, stats =
    [|r|^2, |D theta|^2, |alpha|^2, |D'r|^2, |D'u_new|^2]."""
    masks = _masks(theta.shape, theta.dtype, theta.device)
    wm = _wmasks2(theta.shape, true_m, theta.dtype, theta.device)
    alpha, u_new, stats, _ = _dual_stage(theta, u, kappa, scales, u_scale, wm, masks)
    return alpha, u_new, stats


def _pcg_packed(r, x, counts, halves_lp, eigs_packed, rho, cbar, scales, n_steps):
    """PCG from an already formed residual r; returns (x, |r|^2)."""
    h0, h1 = halves_lp
    return _pcg(r, x, counts, lambda v: dct_ops.dct2_packed(v, h0, h1, mat_dtype=torch.bfloat16),
                lambda v: dct_ops.idct2_packed(v, h0, h1, mat_dtype=torch.bfloat16),
                eigs_packed, rho, cbar, scales, n_steps)


def _pcg(r, x, counts, fwd, inv, eigs, rho, cbar, scales, n_steps):
    """n_steps of PCG from the residual r, preconditioned by the spectral
    solve inv(fwd(r) / (cbar + rho eigs)); returns (x, |r|^2)."""
    masks = _masks(r.shape, r.dtype, r.device)
    w = cbar + rho * eigs

    def precond(v):
        rhat = fwd(v)
        zhat = rhat / w
        return inv(zhat), torch.sum(rhat * zhat)

    z, rz = precond(r)
    p = z
    for step in range(n_steps):
        ap = _gram(p, counts, rho, scales, masks)
        al = rz / torch.clamp_min(torch.sum(p * ap), EPS)
        x = x + al * p
        r = r - al * ap
        if step + 1 < n_steps:   # the last step's preconditioner is dead
            z, rz_new = precond(r)
            p = z + (rz_new / torch.clamp_min(rz, EPS)) * p
            rz = rz_new
    return x, torch.sum(r * r)


def xupdate_pcg_2d_packed_reference(b, x0, counts, halves_lp, eigs_packed, rho, cbar,
                                    scales, n_steps):
    """n_steps of folded-DCT-preconditioned CG on (diag(counts) + rho D'D)
    x = b from x0.  Returns (x, |r|^2 after the last step)."""
    masks = _masks(b.shape, b.dtype, b.device)
    r = b - _gram(x0, counts, rho, scales, masks)
    return _pcg_packed(r, x0, counts, halves_lp, eigs_packed, rho, cbar, scales, n_steps)


def xupdate_pcg_2d_reference(b, x0, counts, mats_lp, eigs, rho, cbar, scales, n_steps):
    """xupdate_pcg_2d_packed_reference with the dense bf16 DCT matrices
    (T0, T1) and the Gram eigenvalues in natural order, for any axes: each
    transform rounds its input and its first product to bf16
    (_xupdate_kernel's dct2/idct2).  Returns (x, |r|^2 after the last
    step)."""
    t0, t1 = mats_lp
    masks = _masks(b.shape, b.dtype, b.device)
    r = b - _gram(x0, counts, rho, scales, masks)
    return _pcg(r, x0, counts, lambda v: dct_ops.dct2_dense(v, t0, t1),
                lambda v: dct_ops.idct2_dense(v, t0, t1), eigs, rho, cbar, scales, n_steps)


def gram_matvec_2d_reference(v, counts, rho, scales):
    """(A v, <v, A v>), A = diag(counts) + rho D'D with the scalars rho s_b
    s_b (gram_matvec_2d folds rho into the scales, pallas_kernels.py:148-157)."""
    out = _gram(v, counts, rho, scales, _masks(v.shape, v.dtype, v.device))
    return out, torch.sum(v * out)


def adapt_rho(rho, primal_norm, dual_norm, tau, band, adapt=True, tau_shrink=None):
    """Adaptive rho (reference adapt_step, solvers.cpp:77-94): (new rho,
    u_scale), the inverse dual rescale carried as u_scale; rho grows by tau
    and shrinks by tau_shrink (None: tau).  Without adapt rho stays and
    u_scale is 1."""
    if not adapt:
        return rho, torch.ones_like(rho)
    tau_s = tau if tau_shrink is None else tau_shrink
    factor = torch.where(
        primal_norm > band * dual_norm, torch.full_like(rho, tau),
        torch.where(dual_norm > band * primal_norm, torch.full_like(rho, 1.0 / tau_s),
                    torch.ones_like(rho)))
    return rho * factor, 1.0 / factor


def admm_iters_2d_reference(theta, u, alpha, counts, oty, halves_lp, eigs_packed, lam, rho,
                            u_scale, cbar, scales, k_iters, n_steps, tau=2.0,
                            band=10.0, true_m=None, adapt=True, tau_shrink=None):
    """k_iters full ADMM iterations: returns (theta, u (3), alpha (3), rho,
    u_scale, stats (6,)), stats = the last iteration's dual-stage sums and
    the CG |r|^2."""
    masks = _masks(theta.shape, theta.dtype, theta.device)
    rho = torch.as_tensor(rho, dtype=theta.dtype, device=theta.device)
    u_scale = torch.as_tensor(u_scale, dtype=theta.dtype, device=theta.device)
    stats = None
    for _ in range(k_iters):
        b = rhs_2d_reference(alpha, u, oty, rho, u_scale, scales)
        r = b - _gram(theta, counts, rho, scales, masks)
        theta, rsq = _pcg_packed(r, theta, counts, halves_lp, eigs_packed, rho, cbar,
                                 scales, n_steps)
        alpha, u, st = dual_update_2d_reference(theta, u, lam / rho, scales, u_scale, true_m)
        stats = torch.cat([st, rsq[None]])
        rho, u_scale = adapt_rho(rho, torch.sqrt(st[0]), rho * torch.sqrt(st[3]), tau, band,
                                 adapt, tau_shrink)
    return theta, u, alpha, rho, u_scale, stats


def admm_iters_2d_batched_reference(theta, u, alpha, counts, oty, halves_lp, eigs_packed,
                                    lams, rhos, u_scales, cbars, scales, k_iters, n_steps,
                                    active=None, tau=2.0, band=10.0, true_m=None, adapt=True,
                                    tau_shrink=None):
    """k_iters ADMM iterations for each of B problems: admm_iters_2d_reference
    on every active row b, with counts[b] and oty[b] (or the shared (m0, m1)
    counts and oty).  Returns new tensors (theta, u (3), alpha (3), rhos,
    u_scales, stats (B, 6)); an inactive row keeps its state, rho and
    u_scale, and its stats row is 0."""
    shared = counts.ndim == 2
    act = [True] * theta.shape[0] if active is None else [bool(a) for a in active.tolist()]
    theta, rhos, u_scales = theta.clone(), rhos.clone(), u_scales.clone()
    u, alpha = tuple(w.clone() for w in u), tuple(a.clone() for a in alpha)
    stats = torch.zeros((theta.shape[0], 6), dtype=theta.dtype, device=theta.device)
    for b in (b for b, on in enumerate(act) if on):
        th, ub, ab, rho, us, st = admm_iters_2d_reference(
            theta[b], tuple(w[b] for w in u), tuple(a[b] for a in alpha),
            counts if shared else counts[b], oty if shared else oty[b], halves_lp, eigs_packed,
            lams[b], rhos[b], u_scales[b], cbars[b], scales, k_iters, n_steps, tau, band, true_m,
            adapt, tau_shrink)
        theta[b] = th
        for dst, src in zip(u + alpha, ub + ab):
            dst[b] = src
        rhos[b], u_scales[b], stats[b] = rho, us, st
    return theta, u, alpha, rhos, u_scales, stats


def dual_update_tiled_2d_reference(theta, u, kappa, scales, u_scale=None, true_m=None,
                                   want_adjoints=False, want_alpha=True):
    """dual_update_2d_reference, then with want_adjoints the carries dta =
    D'alpha and dtu = D'u_new; alpha is None without want_alpha."""
    alpha, u_new, stats = dual_update_2d_reference(theta, u, kappa, scales, u_scale, true_m)
    out = (alpha if want_alpha else None, u_new, stats)
    if want_adjoints:
        out += (_adjD(*alpha, scales), _adjD(*u_new, scales))
    return out


def gram_residual_tiled_2d_reference(b, v, counts, rho, scales, rhs_parts=None):
    """r0 = b - (counts + rho D'D) v; with rhs_parts = (oty, dta, u_scale,
    dtu), b = oty + rho (dta + u_scale dtu) (b is then ignored)."""
    if rhs_parts is not None:
        oty, dta, u_scale, dtu = rhs_parts
        b = oty + rho * (dta + u_scale * dtu)
    return b - _gram_tiled(v, counts, rho, scales)


def gram_matvec_tiled_2d_reference(v, counts, rho, scales):
    """(counts + rho D'D) v."""
    return _gram_tiled(v, counts, rho, scales)


# The row-slab variants (B8s, B9s, B11s; the JAX package's *_shard wrappers):
# each computes its whole-lattice twin's function on one rank's (m0, m1) row
# slab of a lattice of m0_global rows, whose row 0 is global row row_off,
# from the slab and the halo rows around it: halos_top[k] and halos_bot[k]
# are (h, m1) arrays, h >= 1, whose last and first rows are input k's rows
# above and below the slab (the neighbours' boundary rows, zeros at the
# global edges; the JAX package passes h = 8).  The plain versions work on
# the slab's panel (its rows -1 .. m0) with the TPU kernels' global masks.

def dual_update_tiled_2d_shard_reference(theta, u, halos_top, halos_bot, row_off: int,
                                         m0_global: int, kappa, scales, u_scale=None,
                                         true_m=None, want_adjoints=False, want_alpha=True):
    """B8s: dual_update_tiled_2d_reference on a slab, halos in (theta, u0,
    u1, u2) order; the stats are this slab's partial sums."""
    th = _slab_panel(theta, halos_top[0], halos_bot[0])
    ue = tuple(_slab_panel(w, t, b) for w, t, b in zip(u, halos_top[1:], halos_bot[1:]))
    mask0, mask1, valid = _slab_masks(th, row_off, m0_global)
    wm = _wmasks2(th.shape, true_m, th.dtype, th.device, row0=row_off - 1)
    rows = slice(1, th.shape[0] - 1)
    alpha, u_new, stats, dtu = _dual_stage(th, ue, kappa, scales, u_scale, wm, (mask0, mask1),
                                           valid, rows)
    out = (tuple(a[rows] for a in alpha) if want_alpha else None,
           tuple(w[rows] for w in u_new), stats)
    if want_adjoints:
        out += (_adjD(*alpha, scales)[rows], dtu)
    return out


def _gram_slab(v, halo_top, halo_bot, row_off, m0_global, counts, rho, scales):
    """(counts + rho D'D) v on a slab: _gram_tiled on its panel."""
    panel = _slab_panel(v, halo_top, halo_bot)
    mask0, mask1, _ = _slab_masks(panel, row_off, m0_global)
    g = tuple(rho * float(np.float32(s) * np.float32(s)) for s in scales)
    zero = torch.zeros_like(v[:1])
    return _gram_g(panel, torch.cat([zero, counts, zero]), g, (mask0, mask1))[1:-1]


def gram_residual_tiled_2d_shard_reference(b, v, halo_top, halo_bot, row_off: int,
                                           m0_global: int, counts, rho, scales,
                                           rhs_parts=None):
    """B9s: gram_residual_tiled_2d_reference on a slab, v's halo arrays
    given."""
    if rhs_parts is not None:
        oty, dta, u_scale, dtu = rhs_parts
        b = oty + rho * (dta + u_scale * dtu)
    return b - _gram_slab(v, halo_top, halo_bot, row_off, m0_global, counts, rho, scales)


def gram_matvec_tiled_2d_shard_reference(v, halo_top, halo_bot, row_off: int, m0_global: int,
                                         counts, rho, scales):
    """(counts + rho D'D) v on a slab: B10's function, the sharded PCG's
    matvec."""
    return _gram_slab(v, halo_top, halo_bot, row_off, m0_global, counts, rho, scales)


def rhs_tiled_2d_shard_reference(alpha, u, halos_top, halos_bot, row_off: int, oty, rho,
                                 u_scale, scales):
    """B11s: rhs_2d_reference on a slab, halos in (alpha0, alpha1, alpha2,
    u0, u1, u2) order; only the rows above the slab are read."""
    ins = (*alpha, *u)
    panels = [_slab_panel(x, t, b) for x, t, b in zip(ins, halos_top, halos_bot)]
    valid = (_panel_rows(panels[0], row_off) >= 0).to(oty.dtype)
    us = 1.0 if u_scale is None else u_scale
    w = [(a + us * v) * valid for a, v in zip(panels[:3], panels[3:])]
    return oty + rho * _adjD(*w, scales)[1:-1]


def dual_struct_reference(ins, n_out: int, prox: bool):
    """The structure probe's function (csrc/probe.cu): without prox output
    k = input k mod n_in; with it, theta = input 0, output k =
    soft((d0 if k odd else d1) - input 1 + k mod (n_in - 1), 0.01), d0 and
    d1 theta's circular forward differences, and the sum of d0^2."""
    if not prox:
        return [ins[k % len(ins)].clone() for k in range(n_out)], None
    th = ins[0]
    d0, d1 = torch.roll(th, -1, 0) - th, torch.roll(th, -1, 1) - th
    outs = [_soft((d0 if k % 2 else d1) - ins[1 + k % (len(ins) - 1)], 0.01)
            for k in range(n_out)]
    return outs, torch.sum(d0 * d0)


def dual_update_tiled_3d_reference(theta, u, kappa, scales, u_scale=None, true_m=None,
                                   want_adjoints=False, want_alpha=True):
    """The p = 3 z/dual stage over the 7 blocks of BINARIES3 (JAX
    _tiled3_dual_kernel): (alpha (7) or None, u_new (7), stats (5,)), and
    with want_adjoints (dta, dtu) = (D'alpha, D'u_new); stats as
    dual_update_2d_reference's, with the true_m row masks (_wmasks3 =
    diff.true_region_mask) on the threshold and the |D theta|^2, |alpha|^2
    sums."""
    d = diff_ops.apply_D(theta, BINARIES3, scales)
    us = 1.0 if u_scale is None else u_scale
    ue = tuple(us * w for w in u)
    wm = (None if true_m is None else
          tuple(diff_ops.true_region_mask(theta.shape, b, true_m, theta.dtype, theta.device)
                for b in BINARIES3))
    ks = (kappa,) * 7 if wm is None else tuple(kappa * w for w in wm)
    alpha = tuple(_soft(dd - e, k) for dd, e, k in zip(d, ue, ks))
    r = tuple(a - dd for a, dd in zip(alpha, d))
    u_new = tuple(e + rr for e, rr in zip(ue, r))
    sd, sa = (d, alpha) if wm is None else (
        tuple(x * w for x, w in zip(d, wm)), tuple(a * w for a, w in zip(alpha, wm)))
    dtr = diff_ops.apply_Dt(r, BINARIES3, scales)
    dtu = diff_ops.apply_Dt(u_new, BINARIES3, scales)
    stats = torch.stack([diff_ops.blocks_norm_sq(r), diff_ops.blocks_norm_sq(sd),
                         diff_ops.blocks_norm_sq(sa), torch.sum(dtr * dtr),
                         torch.sum(dtu * dtu)])
    out = (alpha if want_alpha else None, u_new, stats)
    if want_adjoints:
        out += (diff_ops.apply_Dt(alpha, BINARIES3, scales), dtu)
    return out


def gram_residual_tiled_3d_reference(b, v, counts, rho, scales, rhs_parts=None):
    """r0 = b - (counts + rho D'D) v over the 7 blocks, each scaled by
    rho (s^2) with s^2 rounded to float32 (pallas_kernels.py:2285); with
    rhs_parts = (oty, dta, u_scale, dtu), b = oty + rho (dta + u_scale dtu)
    (b is then ignored)."""
    if rhs_parts is not None:
        oty, dta, u_scale, dtu = rhs_parts
        b = oty + rho * (dta + u_scale * dtu)
    acc = None
    for bb, s in zip(BINARIES3, scales):
        s2 = float(np.float32(s) * np.float32(s))
        term = (rho * s2) * diff_ops.adjoint_block(diff_ops.apply_block(v, bb), bb)
        acc = term if acc is None else acc + term
    return b - (counts * v + acc)


def rhs_tiled_3d_reference(alpha, u, oty, rho, u_scale, scales):
    """b = oty + rho D'(alpha + u_scale u) over the 7 blocks."""
    us = 1.0 if u_scale is None else u_scale
    au = tuple(a + us * w for a, w in zip(alpha, u))
    return oty + rho * diff_ops.apply_Dt(au, BINARIES3, scales)


# The plane-slab variants of p = 3 (B12s, B13s): each computes its
# whole-lattice twin's function on one rank's (m0, m1, m2) plane slab of a
# lattice of m0_global planes, whose plane 0 is global plane row_off, from
# the slab and the halo planes around it: halos_top[k] and halos_bot[k] are
# (h, m1, m2) arrays, h >= 1, whose last and first planes are input k's
# planes below and above the slab (zeros at the global edges).  The plain
# versions work on the slab's panel (its planes -1 .. m0), every axis-0
# mask on the global plane.

def _panel3(x, top, bot):
    return torch.cat([top[-1:], x, bot[:1]])


def _global_mask0(panel, row_off: int, m0_global: int):
    """The axis-0 difference's mask on a panel's global planes (0 on the
    last plane and below the lattice), broadcast over the plane."""
    g = torch.arange(panel.shape[0], device=panel.device) + (row_off - 1)
    return ((g >= 0) & (g < m0_global - 1)).to(panel.dtype).reshape((-1,) + (1,) * (panel.ndim - 1))


def _panel_block(panel, b, mask0):
    """apply_block on a slab's panel, axis-0 masked on the global planes."""
    d = diff_ops.apply_block(panel, b)
    return d * mask0 if b[0] else d


def _panel_true_masks(panel, true_m, row_off: int):
    """_wmasks3 (diff.true_region_mask) of each block on a panel's global
    planes, or None."""
    if true_m is None:
        return None
    g = torch.arange(panel.shape[0], device=panel.device)[:, None, None] + (row_off - 1)
    rest = [torch.arange(n, device=panel.device) for n in panel.shape[1:]]
    out = []
    for b in BINARIES3:
        w = (g < int(true_m[0]) - b[0])
        w = w & (rest[0][None, :, None] < int(true_m[1]) - b[1])
        w = w & (rest[1][None, None, :] < int(true_m[2]) - b[2])
        out.append(w.to(panel.dtype))
    return tuple(out)


def dual_update_tiled_3d_shard_reference(theta, u, halos_top, halos_bot, row_off: int,
                                         m0_global: int, kappa, scales, u_scale=None,
                                         true_m=None, want_adjoints=False, want_alpha=True):
    """B12s: dual_update_tiled_3d_reference on a plane slab, halos in
    (theta, u0, .., u6) order (only theta's plane above is read); the
    stats are this slab's partial sums."""
    th = _panel3(theta, halos_top[0], halos_bot[0])
    mask0 = _global_mask0(th, row_off, m0_global)
    us = 1.0 if u_scale is None else u_scale
    ue = tuple(us * _panel3(w, t, b) for w, t, b in zip(u, halos_top[1:], halos_bot[1:]))
    d = tuple(s * _panel_block(th, b, mask0) for b, s in zip(BINARIES3, scales))
    wm = _panel_true_masks(th, true_m, row_off)
    ks = (kappa,) * 7 if wm is None else tuple(kappa * w for w in wm)
    alpha = tuple(_soft(dd - e, k) for dd, e, k in zip(d, ue, ks))
    r = tuple(a - dd for a, dd in zip(alpha, d))
    u_new = tuple(e + rr for e, rr in zip(ue, r))
    sd, sa = (d, alpha) if wm is None else (
        tuple(x * w for x, w in zip(d, wm)), tuple(a * w for a, w in zip(alpha, wm)))
    own = slice(1, th.shape[0] - 1)

    def adj(blocks):
        return diff_ops.apply_Dt(blocks, BINARIES3, scales)[own]

    def sq(blocks):
        return sum(torch.sum(torch.square(x[own])) for x in blocks)

    dtr, dtu = adj(r), adj(u_new)
    stats = torch.stack([sq(r), sq(sd), sq(sa), torch.sum(dtr * dtr), torch.sum(dtu * dtu)])
    out = (tuple(a[own] for a in alpha) if want_alpha else None,
           tuple(w[own] for w in u_new), stats)
    if want_adjoints:
        out += (adj(alpha), dtu)
    return out


def _gram3_slab(v, halo_top, halo_bot, row_off, m0_global, counts, rho, scales):
    """(counts + rho D'D) v on a plane slab, each block's term rho (s^2)
    (s^2 rounded to float32), as gram_residual_tiled_3d_reference's."""
    panel = _panel3(v, halo_top, halo_bot)
    mask0 = _global_mask0(panel, row_off, m0_global)
    acc = None
    for bb, s in zip(BINARIES3, scales):
        s2 = float(np.float32(s) * np.float32(s))
        term = (rho * s2) * diff_ops.adjoint_block(_panel_block(panel, bb, mask0), bb)
        acc = term if acc is None else acc + term
    return counts * v + acc[1:-1]


def gram_residual_tiled_3d_shard_reference(b, v, halo_top, halo_bot, row_off: int,
                                           m0_global: int, counts, rho, scales,
                                           rhs_parts=None):
    """B13s: gram_residual_tiled_3d_reference on a plane slab, v's halo
    arrays given."""
    if rhs_parts is not None:
        oty, dta, u_scale, dtu = rhs_parts
        b = oty + rho * (dta + u_scale * dtu)
    return b - _gram3_slab(v, halo_top, halo_bot, row_off, m0_global, counts, rho, scales)


def gram_matvec_tiled_3d_shard_reference(v, halo_top, halo_bot, row_off: int, m0_global: int,
                                         counts, rho, scales):
    """(counts + rho D'D) v on a plane slab, the sharded PCG's matvec at
    p = 3: the block sum of B13s's plain version."""
    return _gram3_slab(v, halo_top, halo_bot, row_off, m0_global, counts, rho, scales)


def xupdate_tridiag_segment_reference(counts, b, rho, scale, open_lo: bool, open_hi: bool):
    """T1's segment mode: (3, n) = the segment's system solved for b and the
    unit vectors at its first and last rows (solver/tridiag.py::
    segment_solve, the cyclic reduction)."""
    return tridiag.segment_solve(counts, b, rho, scale, open_lo, open_hi)


def partition_finish_reference(every, rank: int, scale, ylr):
    """This rank's x from the gathered segment ends and rho (W, 7) and its
    segment solve ylr (3, n): the dense float64 interface solve and the
    back-substitution of solver/tridiag.py::partition_finish."""
    return tridiag.partition_finish(every, rank, scale, ylr)


def xupdate_tridiag_reference(counts, b, rho, scale):
    """x with (diag(counts) + (rho s) s T) x = b: the cyclic reduction of
    solver/tridiag.py."""
    return tridiag.xupdate_tridiag(counts, b, rho, scale)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_P, _F, _I, _LL = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "mvtv_rhs_2d": [_P] * 9 + [_F] * 3 + [_P, _I, _I, _P],
    "mvtv_dual_update_2d": [_P] * 6 + [_F] * 3 + [_I, _I] + [_P] * 5 + [_I, _I, _P],
    "mvtv_xupdate_pcg_2d_packed": [_P] * 10 + [_F] * 3 + [_I] + [_P] * 4 + [_I, _I, _P],
    "mvtv_admm_iters_2d_batched": ([_P] * 9 + [_LL] + [_P] * 10 + [_F] * 3 + [_I, _I]
                                   + [_F] * 3 + [_I] * 3 + [_P] * 4 + [_I] * 3 + [_P, _P]),
    "mvtv_admm_iters_2d_batched_occupancy": [_P, _P],
    "mvtv_xupdate_pcg_2d": [_P] * 8 + [_F] * 3 + [_I] + [_P] * 4 + [_I, _I, _P],
    "mvtv_xupdate_pcg_2d_work": [_I, _I],
    "mvtv_xupdate_pcg_2d_packed_work": [_I, _I],
    "mvtv_admm_iters_2d_batched_work": [_I] * 3,
    "mvtv_gram_matvec_2d": [_P] * 3 + [_F] * 3 + [_P] * 4 + [_I, _I, _P],
    "mvtv_gram_matvec_2d_partials": [_I, _I],
    "mvtv_dual_update_tiled_2d": [_P] * 6 + [_F] * 3 + [_I] * 4 + [_P] * 7 + [_I, _I, _P],
    "mvtv_gram_tiled_2d": [_I] + [_P] * 8 + [_F] * 3 + [_P, _I, _I, _P],
    "mvtv_dual_update_tiled_3d": ([_P] * 10 + [_F] * 7 + [_I] * 5 + [_P] * 5 + [_LL, _P]
                                  + [_I] * 3 + [_P]),
    "mvtv_dual_update_tiled_3d_blocks": [_I] * 3,
    "mvtv_gram_tiled_3d": [_I] + [_P] * 8 + [_F] * 7 + [_P] + [_I] * 3 + [_P],
    "mvtv_rhs_tiled_3d": [_P] * 17 + [_F] * 7 + [_P] + [_I] * 3 + [_P],
    "mvtv_stream_copy": [_P, _P, _LL, _I, _P],
    "mvtv_dual_update_tiled_2d_shard": [_P] * 11 + [_F] * 3 + [_I] * 6 + [_P] * 7
                                       + [_I, _I, _P],
    "mvtv_gram_tiled_2d_shard": [_I] + [_P] * 10 + [_F] * 3 + [_I, _I, _P, _I, _I, _P],
    "mvtv_rhs_tiled_2d_shard": [_P] * 13 + [_F] * 3 + [_I, _P, _I, _I, _P],
    "mvtv_dual_struct": [_P, _I, _P, _I, _I, _P, _I, _I, _P],
    "mvtv_xupdate_tridiag": [_P, _P, _P, _F, _P, _P, _I, _P],
    "mvtv_xupdate_tridiag_work": [_I],
    "mvtv_dual_update_tiled_3d_shard": ([_P] * 19 + [_F] * 7 + [_I] * 7 + [_P] * 5
                                        + [_LL, _P] + [_I] * 3 + [_P]),
    "mvtv_gram_tiled_3d_shard": [_I] + [_P] * 10 + [_F] * 7 + [_I, _I, _P] + [_I] * 3 + [_P],
    "mvtv_xupdate_tridiag_segment": [_P, _P, _P, _F, _I, _P, _P, _I, _P],
    "mvtv_xupdate_tridiag_segment_work": [_I],
    "mvtv_partition_finish": [_P, _I, _I, _F, _P, _P, _I, _P],
}
# The work-size queries that return a count of floats as a long long.
_LONG_RESULTS = ("mvtv_xupdate_pcg_2d_packed_work", "mvtv_admm_iters_2d_batched_work",
                 "mvtv_xupdate_tridiag_work", "mvtv_xupdate_tridiag_segment_work")
_configured = False


def _lib():
    """The kernel library with its ctypes signatures set."""
    global _configured
    lib = _build.load()
    if not _configured:
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _LL if name in _LONG_RESULTS else ctypes.c_int
        _configured = True
    return lib


def _route(*tensors: torch.Tensor) -> str:
    """"cpu" or "cuda" from the tensors' common device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type


def _check_lattices(shape, *tensors, even: bool = False, rank: int = 2):
    shape = tuple(shape)
    if len(shape) != rank:
        raise ValueError(f"the {rank}-D kernels need a {rank}-D lattice, got shape "
                         f"{tuple(shape)}")
    if even and (shape[0] % 2 or shape[1] % 2):
        raise ValueError(f"the folded DCT needs even axes, got {tuple(shape)}")
    for t in tensors:
        if t.dtype != torch.float32 or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"expected a contiguous float32 {tuple(shape)} lattice, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _check_halves(halves_lp, shape):
    for (te, to), m in zip(halves_lp, shape):
        for h in (te, to):
            if (h.dtype != torch.bfloat16 or tuple(h.shape) != (m // 2, m // 2)
                    or not h.is_contiguous()):
                raise ValueError(f"expected contiguous bf16 ({m // 2}, {m // 2}) DCT halves")


def _check_mats(mats_lp, shape):
    for t, m in zip(mats_lp, shape):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (m, m) or not t.is_contiguous():
            raise ValueError(f"expected a contiguous bf16 ({m}, {m}) DCT matrix")


def _scalar_ptr(x, device) -> int:
    """Device pointer of a one-element float32 tensor on ``device``."""
    if not (isinstance(x, torch.Tensor) and x.numel() == 1 and x.dtype == torch.float32
            and x.device == device):
        raise TypeError(f"the CUDA kernels take scalars as float32 tensors on {device}")
    return x.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _scal_buffer(n_steps: int, device, batch: int = 1) -> torch.Tensor:
    """One row of scalars per problem (csrc/common.cuh, Slot)."""
    return torch.empty(batch * (S_CG + 2 * (n_steps + 1)), dtype=torch.float32, device=device)


def _tiles(shape) -> int:
    """The 32 x 8 stencil blocks of one (m0, m1) lattice."""
    return -(-shape[1] // 32) * -(-shape[0] // 8)


def _partials(shape, nv: int, device, batch: int = 1) -> torch.Tensor:
    """nv per-block partial sums per problem, one per 32 x 8 stencil block."""
    return torch.empty(batch * nv * _tiles(shape), dtype=torch.float32, device=device)


_TICKETS = {}


def _ticket(device, stream: int) -> int:
    """Device pointer of the last-CTA ticket of B1's dual stage
    (csrc/dual.cu) and B7 (csrc/tiled.cu) for one stream of ``device``:
    one int32, zeroed once, which every launch leaves at 0; launches on one
    stream run in order, so they share it."""
    key = (device.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[key].data_ptr()


def _dual_buffers(shape, n_lat: int, device):
    """A dual stage's buffers, two allocations: its n_lat output lattices,
    and its scalar row (the statistics at S_STATS) followed by its 5
    partial sums per 32 x 8 tile (from float S_CG on)."""
    out = torch.empty((n_lat,) + tuple(shape), dtype=torch.float32, device=device)
    return out, torch.empty(S_CG + 5 * _tiles(shape), dtype=torch.float32, device=device)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {err})")


def _launch_rhs(name: str, alpha, u, oty, rho, u_scale, scales) -> torch.Tensor:
    """B2's kernel (csrc/rhs.cu) on CUDA tensors, one launch and one
    allocation (b), counted under ``name``; u_scale None passes a null
    pointer (1 in the kernel)."""
    dev = oty.device
    b = torch.empty_like(oty)
    err = _lib().mvtv_rhs_2d(*(t.data_ptr() for t in (*alpha, *u, oty)), _scalar_ptr(rho, dev),
                             None if u_scale is None else _scalar_ptr(u_scale, dev), *scales,
                             b.data_ptr(), oty.shape[0], oty.shape[1], _stream(dev))
    _raise_on(err, name)
    launch_counts[name] += 1
    return b


def rhs_2d(alpha: Sequence[torch.Tensor], u: Sequence[torch.Tensor], oty: torch.Tensor,
           rho, u_scale, scales: Sequence[float]) -> torch.Tensor:
    """b = oty + rho D'(alpha + u_scale u) (u_scale None = 1)."""
    _check_lattices(tuple(oty.shape), oty, *alpha, *u)
    if _route(oty, *alpha, *u) == "cpu":
        return rhs_2d_reference(alpha, u, oty, rho, u_scale, scales)
    return _launch_rhs("rhs_2d", alpha, u, oty, rho, u_scale, scales)


def dual_update_2d(theta: torch.Tensor, u: Sequence[torch.Tensor], kappa,
                   scales: Sequence[float], u_scale=None,
                   true_m: Optional[Tuple[int, int]] = None):
    """The z/dual stage: (alpha (3), u_new (3), stats (5,))."""
    shape = tuple(theta.shape)
    _check_lattices(shape, theta, *u)
    if _route(theta, *u) == "cpu":
        return dual_update_2d_reference(theta, u, kappa, scales, u_scale, true_m)
    dev = theta.device
    if u_scale is None:
        u_scale = torch.ones((), dtype=torch.float32, device=dev)
    lib = _lib()
    out, work = _dual_buffers(shape, 6, dev)
    t0, t1 = (-1, -1) if true_m is None else (int(true_m[0]), int(true_m[1]))
    stream, ptr, step = _stream(dev), out.data_ptr(), 4 * shape[0] * shape[1]
    err = lib.mvtv_dual_update_2d(
        theta.data_ptr(), *(t.data_ptr() for t in u), _scalar_ptr(kappa, dev),
        _scalar_ptr(u_scale, dev), *scales, t0, t1, ptr, ptr + 3 * step,
        work.data_ptr() + 4 * S_CG, _ticket(dev, stream), work.data_ptr(), shape[0], shape[1],
        stream)
    _raise_on(err, "dual_update_2d")
    launch_counts["dual_update_2d"] += 1
    lat = out.unbind(0)
    return lat[:3], lat[3:], work[S_STATS:S_STATS + 5]


def xupdate_pcg_2d_packed(b: torch.Tensor, x0: torch.Tensor, counts: torch.Tensor,
                          halves_lp, eigs_packed: torch.Tensor, rho, cbar,
                          scales: Sequence[float], n_steps: int):
    """n_steps of folded-DCT-preconditioned CG: (x, |r|^2 after the last
    step)."""
    shape = tuple(b.shape)
    _check_lattices(shape, b, x0, counts, eigs_packed, even=True)
    _check_halves(halves_lp, shape)
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    if _route(b, x0, counts, eigs_packed, *halves_lp[0], *halves_lp[1]) == "cpu":
        return xupdate_pcg_2d_packed_reference(b, x0, counts, halves_lp, eigs_packed, rho,
                                               cbar, scales, n_steps)
    dev = b.device
    lib = _lib()
    x = torch.empty_like(b)
    # 3 lattices and the tensor-core products' padded bf16 operands
    work = torch.empty(lib.mvtv_xupdate_pcg_2d_packed_work(*shape), dtype=torch.float32,
                       device=dev)
    scal = _scal_buffer(n_steps, dev)
    partials = _partials(shape, 1, dev)
    (te0, to0), (te1, to1) = halves_lp
    err = lib.mvtv_xupdate_pcg_2d_packed(
        b.data_ptr(), x0.data_ptr(), counts.data_ptr(), te0.data_ptr(), to0.data_ptr(),
        te1.data_ptr(), to1.data_ptr(), eigs_packed.data_ptr(), _scalar_ptr(rho, dev),
        _scalar_ptr(cbar, dev), *scales, n_steps, x.data_ptr(), work.data_ptr(),
        partials.data_ptr(), scal.data_ptr(), shape[0], shape[1], _stream(dev))
    _raise_on(err, "xupdate_pcg_2d_packed")
    launch_counts["xupdate_pcg_2d_packed"] += 1
    return x, scal[S_STATS + 5]


def xupdate_pcg_2d(b: torch.Tensor, x0: torch.Tensor, counts: torch.Tensor, mats_lp,
                   eigs: torch.Tensor, rho, cbar, scales: Sequence[float], n_steps: int):
    """n_steps of CG preconditioned by the dense bf16 DCT solve, any axes
    (eigs in natural order, mats_lp the bf16 (m0, m0) and (m1, m1) DCT
    matrices): (x, |r|^2 after the last step)."""
    shape = tuple(b.shape)
    _check_lattices(shape, b, x0, counts, eigs)
    _check_mats(mats_lp, shape)
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    if _route(b, x0, counts, eigs, *mats_lp) == "cpu":
        return xupdate_pcg_2d_reference(b, x0, counts, mats_lp, eigs, rho, cbar, scales, n_steps)
    dev = b.device
    lib = _lib()
    x = torch.empty_like(b)
    # 4 lattices and the tensor-core products' padded bf16 operands
    work = torch.empty(lib.mvtv_xupdate_pcg_2d_work(*shape), dtype=torch.float32, device=dev)
    scal = _scal_buffer(n_steps, dev)
    partials = _partials(shape, 1, dev)
    t0, t1 = mats_lp
    err = lib.mvtv_xupdate_pcg_2d(
        b.data_ptr(), x0.data_ptr(), counts.data_ptr(), t0.data_ptr(), t1.data_ptr(),
        eigs.data_ptr(), _scalar_ptr(rho, dev), _scalar_ptr(cbar, dev), *scales, n_steps,
        x.data_ptr(), work.data_ptr(), partials.data_ptr(), scal.data_ptr(), shape[0], shape[1],
        _stream(dev))
    _raise_on(err, "xupdate_pcg_2d")
    launch_counts["xupdate_pcg_2d"] += 1
    return x, scal[S_STATS + 5]


@functools.lru_cache(maxsize=None)
def _gram_dot_floats(shape) -> int:
    """B7's work buffer: the dot, then the per-CTA partials of its launch."""
    return 1 + _lib().mvtv_gram_matvec_2d_partials(*shape)


def gram_matvec_2d(v: torch.Tensor, counts: torch.Tensor, rho, scales: Sequence[float]):
    """(A v, <v, A v>) with A = diag(counts) + rho D'D, any axes: the
    fused-dot PCG's matvec.  On the card one launch (csrc/tiled.cu) and two
    allocations: A v, and the dot followed by the partials."""
    shape = tuple(v.shape)
    _check_lattices(shape, v, counts)
    if _route(v, counts) == "cpu":
        return gram_matvec_2d_reference(v, counts, rho, scales)
    dev, (m0, m1) = v.device, shape
    out = torch.empty_like(v)
    work = torch.empty(_gram_dot_floats((m0, m1)), dtype=torch.float32, device=dev)
    stream, ptr = _stream(dev), work.data_ptr()
    err = _lib().mvtv_gram_matvec_2d(v.data_ptr(), counts.data_ptr(), _scalar_ptr(rho, dev),
                                     *scales, out.data_ptr(), ptr, ptr + 4,
                                     _ticket(dev, stream), m0, m1, stream)
    _raise_on(err, "gram_matvec_2d")
    launch_counts["gram_matvec_2d"] += 1
    return out, work[0]


def _check_vectors(n: int, *vectors):
    for v in vectors:
        if v.dtype != torch.float32 or tuple(v.shape) != (n,) or not v.is_contiguous():
            raise ValueError(f"expected contiguous float32 ({n},) per-problem scalars, got "
                             f"{v.dtype} {tuple(v.shape)}")


# csrc/chain.cu's Plan, in its order: how the persistent kernel cuts B
# problems into work items and where each problem's partial sums go.
CHAIN_PLAN = ("grid", "quad_cols", "quad_items", "dual_cols", "dual_steps", "dual_items",
              "fold_n", "fold_mh", "fold_m", "pstride", "p_rz", "p_pap", "p_rr", "p_dual")
_DUAL_STEPS = 8   # tiles a strip of the chain's dual stage
_FOLD_TILE = 32   # csrc/fold.cuh, kFM = kFN


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chain_plan(batch: int, m0: int, m1: int, per_sm: int, sms: int) -> dict:
    """The persistent chain's work items and partial slots for B problems on
    an (m0, m1) lattice (even axes), and its grid from the occupancy of its
    kernel (per_sm CTAs resident on each of sms SMs: csrc/chain.cu,
    ``mvtv_admm_iters_2d_batched_occupancy``).

    Items a problem: ``quad_items`` 32 x 8 tiles of the top left quadrant
    (the residual, the matvec and the CG updates: each thread at the four
    mirror points of its knot), ``dual_items`` column strips of
    ``dual_steps`` 32 x 8 tiles (the dual stage: B1's march, up to 8 tiles
    a strip, as many as the lattice has tile rows), and the products' 32 x
    32 tiles (``fold_n`` N-tiles by ``fold_mh`` or ``fold_m`` M-tiles).
    Problem b's partials are the ``pstride`` floats from b * pstride: <r,
    z> one per forward column-product tile (p_rz), <p, Ap> and |r|^2 one
    per quadrant item (p_pap, p_rr), the dual stage's five sums per strip
    (p_dual).  Every count and offset comes from the lattice alone, so
    problem b's slots, and the order of its sums (each in slot order), are
    the same in a batch of any size, and no value depends on the grid.
    The grid is every resident CTA, one an SM where the work is small, or
    fewer where no stage has that many items; the kernel refuses a grid
    that cannot be resident, and so does this."""
    if per_sm < 1 or sms < 1:
        raise RuntimeError(f"the chain's kernel cannot be resident ({per_sm} CTAs per SM on "
                           f"{sms} SMs)")
    h0, h1 = m0 // 2, m1 // 2
    rows = _cdiv(m0, 8)
    plan = dict(quad_cols=_cdiv(h1, 32), dual_cols=_cdiv(m1, 32),
                dual_steps=min(_DUAL_STEPS, rows), fold_n=_cdiv(h1, _FOLD_TILE),
                fold_mh=_cdiv(h0, _FOLD_TILE), fold_m=_cdiv(m0, _FOLD_TILE))
    plan["quad_items"] = plan["quad_cols"] * _cdiv(h0, 8)
    plan["dual_items"] = plan["dual_cols"] * _cdiv(rows, plan["dual_steps"])
    plan["p_rz"] = 0
    plan["p_pap"] = plan["fold_m"] * plan["fold_n"]
    plan["p_rr"] = plan["p_pap"] + plan["quad_items"]
    plan["p_dual"] = plan["p_rr"] + plan["quad_items"]
    plan["pstride"] = plan["p_dual"] + 5 * plan["dual_items"]
    most = max(plan["quad_items"], plan["dual_items"], 2 * plan["fold_mh"] * plan["fold_n"],
               plan["fold_m"] * plan["fold_n"])
    # One CTA an SM while the quadrant items fit twice over them: a grid
    # barrier of fewer CTAs beats the stages' idle second CTAs (on an H100
    # at 512^2, B = 1; not at 316^2, B = 5, or at 1024^2).
    per = 1 if batch * plan["quad_items"] <= 2 * sms else per_sm
    plan["grid"] = min(per * sms, batch * most)
    return plan


def chain_work_floats(batch: int, m0: int, m1: int) -> int:
    """Floats of the chain's work buffer (csrc/xupdate.cu, folded_work(6,
    ...)): 6 (B, m0, m1) lattices (u's scratch copy, r, p, Ap), 4 floats of
    slack for 16-byte alignment, then the products' padded bf16 operands
    (csrc/dct_fold.cu, folded_scratch_bytes: 4 blocks of m0 x ld1 a
    problem and the four padded halves, rows padded to 8 bf16)."""
    ld0, ld1 = _cdiv(m0 // 2, 8) * 8, _cdiv(m1 // 2, 8) * 8
    bf16_bytes = 2 * (batch * 4 * m0 * ld1 + m0 * ld0 + m1 * ld1)
    return 6 * batch * m0 * m1 + 4 + (bf16_bytes + 3) // 4


def chain_barriers(k_iters: int, n_steps: int) -> int:
    """Grid barriers of one chain call: the set-up's, then an iteration's
    residual, 4 a preconditioner apply (n_steps of them), the matvec and
    update of each CG step, and the dual stage (none after the last)."""
    return k_iters * (2 + 6 * n_steps)


_OCCUPANCY = {}


def _chain_occupancy(dev) -> Tuple[int, int]:
    """(CTAs of the chain's kernel resident per SM, SMs) on ``dev``; raises
    where the card has no cooperative launch."""
    if dev.index not in _OCCUPANCY:
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = _lib().mvtv_admm_iters_2d_batched_occupancy(ctypes.byref(per_sm),
                                                              ctypes.byref(sms))
        _raise_on(err, "admm_iters_2d_batched (occupancy)")
        _OCCUPANCY[dev.index] = (per_sm.value, sms.value)
    return _OCCUPANCY[dev.index]


def _chain_buffers(scratch: Optional[dict], dev, batch: int, m0: int, m1: int,
                   n_steps: int) -> dict:
    """The chain's buffers for (device, B, m0, m1, n_steps): work, partials,
    the dual stage's tickets and the grid barrier's two counters (zeroed
    here, left 0 by every launch), scalars, the per-problem scalar inputs,
    the activity mask, B4's stacked state and the plan (chain_plan, as
    csrc/chain.cu's Plan).  A solve keeps one scratch dict across its
    chunk calls, so they allocate once; scratch None allocates them for
    this call alone."""
    key = (dev, batch, m0, m1, n_steps)
    if scratch is not None and scratch.get("key") == key:
        return scratch
    lib = _lib()
    work = chain_work_floats(batch, m0, m1)
    if lib.mvtv_admm_iters_2d_batched_work(batch, m0, m1) != work:
        raise RuntimeError("chain_work_floats disagrees with csrc/chain.cu's work size")
    plan = chain_plan(batch, m0, m1, *_chain_occupancy(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    bufs = dict(key=key, work=torch.empty(work, **f32),
                scal=_scal_buffer(n_steps, dev, batch).reshape(batch, -1),
                partials=torch.empty(batch * plan["pstride"], **f32),
                tickets=torch.zeros(batch + 2, dtype=torch.int32, device=dev),
                inp=torch.empty((4, batch), **f32),
                act=torch.empty(batch, dtype=torch.int32, device=dev),
                state=torch.empty((7, batch, m0, m1), **f32) if batch == 1 else None,
                plan=(ctypes.c_int * len(CHAIN_PLAN))(*(plan[k] for k in CHAIN_PLAN)))
    if scratch is None:
        return bufs
    scratch.clear()
    scratch.update(bufs)
    return scratch


def _launch_chain(theta, u, alpha, counts, oty, halves_lp, eigs_packed, lams, rhos, u_scales,
                  cbars, scales, k_iters, n_steps, active, tau, band, true_m, adapt, tau_shrink,
                  bufs):
    """csrc/chain.cu on B problems, (B, m0, m1) state updated in place
    (arguments checked by the caller; bufs from _chain_buffers);
    returns (cudaError, rhos, u_scales, stats (B, 6)), the last three as
    views of a copy of the scalar buffer."""
    batch, m0, m1 = theta.shape
    dev = theta.device
    lib = _lib()
    inp = bufs["inp"]
    torch.stack([v.reshape(batch) for v in (lams, rhos, u_scales, cbars)], out=inp)
    act = None if active is None else bufs["act"]
    if act is not None:
        act.copy_(active)
    (te0, to0), (te1, to1) = halves_lp
    t0, t1 = (-1, -1) if true_m is None else (int(true_m[0]), int(true_m[1]))
    scal = bufs["scal"]
    err = lib.mvtv_admm_iters_2d_batched(
        theta.data_ptr(), *(t.data_ptr() for t in (*u, *alpha, counts, oty)),
        0 if counts.ndim == 2 else m0 * m1,
        te0.data_ptr(), to0.data_ptr(), te1.data_ptr(), to1.data_ptr(), eigs_packed.data_ptr(),
        *(v.data_ptr() for v in inp), None if act is None else act.data_ptr(), *scales, k_iters,
        n_steps, tau, band, tau if tau_shrink is None else tau_shrink, int(adapt), t0, t1,
        bufs["work"].data_ptr(), bufs["partials"].data_ptr(), bufs["tickets"].data_ptr(),
        scal.data_ptr(), batch, m0, m1, ctypes.addressof(bufs["plan"]), _stream(dev))
    scal = scal.clone()
    return err, scal[:, S_RHO], scal[:, S_USCALE], scal[:, S_STATS:S_STATS + 6]


def admm_iters_2d(theta: torch.Tensor, u: Sequence[torch.Tensor],
                  alpha: Sequence[torch.Tensor], counts: torch.Tensor, oty: torch.Tensor,
                  halves_lp, eigs_packed: torch.Tensor, lam, rho, u_scale, cbar,
                  scales: Sequence[float], k_iters: int, n_steps: int, tau: float = 2.0,
                  band: float = 10.0,
                  true_m: Optional[Tuple[int, int]] = None, adapt: bool = True,
                  tau_shrink: Optional[float] = None, scratch: Optional[dict] = None):
    """k_iters full ADMM iterations (p = 2, even axes): (theta, u (3),
    alpha (3), rho, u_scale, stats (6,)).  The inputs are not modified: the
    card runs B5's launcher with B = 1 on a copy of the state.  adapt,
    tau, tau_shrink, band: adapt_rho's.  scratch: a dict the caller keeps
    across the calls of one solve (_chain_buffers; unused on the CPU)."""
    shape = tuple(theta.shape)
    _check_lattices(shape, theta, *u, *alpha, counts, oty, eigs_packed, even=True)
    _check_halves(halves_lp, shape)
    if k_iters < 1 or n_steps < 1:
        raise ValueError("k_iters and n_steps must be >= 1")
    if _route(theta, *u, *alpha, counts, oty, eigs_packed) == "cpu":
        return admm_iters_2d_reference(theta, u, alpha, counts, oty, halves_lp, eigs_packed,
                                       lam, rho, u_scale, cbar, scales, k_iters, n_steps,
                                       tau, band, true_m, adapt, tau_shrink)
    dev = theta.device
    for x in (lam, rho, u_scale, cbar):
        _scalar_ptr(x, dev)
    bufs = _chain_buffers(scratch, dev, 1, *shape, n_steps)
    state = torch.stack([theta, *u, *alpha], out=bufs["state"][:, 0])[:, None]
    err, rho_out, us_out, stats = _launch_chain(
        state[0], state[1:4].unbind(0), state[4:7].unbind(0), counts, oty, halves_lp,
        eigs_packed, lam, rho, u_scale, cbar, scales, k_iters, n_steps, None, tau, band, true_m,
        adapt, tau_shrink, bufs)
    _raise_on(err, "admm_iters_2d")
    launch_counts["admm_iters_2d"] += 1
    state = state[:, 0].clone()
    return (state[0], tuple(state[1:4].unbind(0)), tuple(state[4:7].unbind(0)), rho_out[0],
            us_out[0], stats[0])


def admm_iters_2d_batched(theta: torch.Tensor, u: Sequence[torch.Tensor],
                          alpha: Sequence[torch.Tensor], counts: torch.Tensor,
                          oty: torch.Tensor, halves_lp, eigs_packed: torch.Tensor,
                          lams: torch.Tensor, rhos: torch.Tensor, u_scales: torch.Tensor,
                          cbars: torch.Tensor, scales: Sequence[float], k_iters: int,
                          n_steps: int, active: Optional[torch.Tensor] = None,
                          tau: float = 2.0, band: float = 10.0,
                          true_m: Optional[Tuple[int, int]] = None, adapt: bool = True,
                          tau_shrink: Optional[float] = None, scratch: Optional[dict] = None):
    """k_iters full ADMM iterations for each of B problems (p = 2, even
    axes): (theta, u (3), alpha (3), rhos (B,), u_scales (B,), stats (B, 6)).

    theta, u and alpha are (B, m0, m1) and are UPDATED IN PLACE (the JAX
    kernel aliases them); the returned lattices are the same tensors.
    counts and oty are per problem (B, m0, m1), for CV folds, or shared
    (m0, m1), for a lambda sweep of one problem.  lams, rhos, u_scales and
    cbars are float32 (B,).  active: (B,) bool or int tensor on the same
    device (None = all active); an inactive row is left untouched, its rho
    and u_scale pass through and its stats row is 0.  scratch: as
    admm_iters_2d's."""
    shape = tuple(theta.shape)
    if len(shape) != 3:
        raise ValueError(f"expected a (B, m0, m1) batch of lattices, got {shape}")
    batch, m = shape[0], shape[1:]
    _check_lattices(shape[1:], eigs_packed, even=True)
    for t in (theta, *u, *alpha):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"expected contiguous float32 {shape} state, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (counts, oty):
        if (t.dtype != torch.float32 or tuple(t.shape) not in (shape, m)
                or t.shape != counts.shape or not t.is_contiguous()):
            raise ValueError(f"counts and oty must be contiguous float32 {shape} or {m}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    _check_halves(halves_lp, m)
    _check_vectors(batch, lams, rhos, u_scales, cbars)
    if active is not None and tuple(active.shape) != (batch,):
        raise ValueError(f"active must be ({batch},), got {tuple(active.shape)}")
    if k_iters < 1 or n_steps < 1:
        raise ValueError("k_iters and n_steps must be >= 1")
    tensors = [theta, *u, *alpha, counts, oty, eigs_packed, lams, rhos, u_scales, cbars]
    if _route(*tensors, *([] if active is None else [active])) == "cpu":
        out = admm_iters_2d_batched_reference(
            theta, u, alpha, counts, oty, halves_lp, eigs_packed, lams, rhos, u_scales, cbars,
            scales, k_iters, n_steps, active, tau, band, true_m, adapt, tau_shrink)
        for dst, src in zip((theta, *u, *alpha), (out[0], *out[1], *out[2])):
            dst.copy_(src)
        return (theta, tuple(u), tuple(alpha)) + out[3:]
    err, rho_out, us_out, stats = _launch_chain(
        theta, u, alpha, counts, oty, halves_lp, eigs_packed, lams, rhos, u_scales, cbars,
        scales, k_iters, n_steps, active, tau, band, true_m, adapt, tau_shrink,
        _chain_buffers(scratch, theta.device, shape[0], *m, n_steps))
    _raise_on(err, "admm_iters_2d_batched")
    launch_counts["admm_iters_2d_batched"] += 1
    return theta, tuple(u), tuple(alpha), rho_out, us_out, stats


# ---------------------------------------------------------------------------
# The tiled kernels of the large-lattice route (above 2^20 knots)
# ---------------------------------------------------------------------------

def dual_update_tiled_2d(theta: torch.Tensor, u: Sequence[torch.Tensor], kappa,
                         scales: Sequence[float], u_scale=None,
                         true_m: Optional[Tuple[int, int]] = None,
                         want_adjoints: bool = False, want_alpha: bool = True):
    """B1's contract for lattices above 2^20 knots: (alpha (3), u_new (3),
    stats (5,)), and with want_adjoints also (dta, dtu) = (D'alpha,
    D'u_new); with want_alpha=False the alpha slot is None (the ADMM route
    never reads it, admm.py::_refresh_alpha).  On the card the kernel is
    compiled for the pairs a route launches, want_alpha != want_adjoints;
    the plain version takes all four (the JAX signature)."""
    shape = tuple(theta.shape)
    _check_lattices(shape, theta, *u)
    if _route(theta, *u) == "cpu":
        return dual_update_tiled_2d_reference(theta, u, kappa, scales, u_scale, true_m,
                                              want_adjoints, want_alpha)
    if bool(want_alpha) == bool(want_adjoints):
        raise ValueError("dual_update_tiled_2d on the card: want_alpha and want_adjoints must "
                         f"differ (got {want_alpha}, {want_adjoints})")
    dev = theta.device
    if u_scale is None:
        u_scale = torch.ones((), dtype=torch.float32, device=dev)
    lib = _lib()
    n_a, n_d = (3 if want_alpha else 0), (2 if want_adjoints else 0)
    out, work = _dual_buffers(shape, n_a + 3 + n_d, dev)
    t0, t1 = (-1, -1) if true_m is None else (int(true_m[0]), int(true_m[1]))
    stream, ptr, step = _stream(dev), out.data_ptr(), 4 * shape[0] * shape[1]
    err = lib.mvtv_dual_update_tiled_2d(
        theta.data_ptr(), *(t.data_ptr() for t in u), _scalar_ptr(kappa, dev),
        _scalar_ptr(u_scale, dev), *scales, t0, t1, int(want_alpha), int(want_adjoints),
        ptr if want_alpha else None, ptr + n_a * step,
        ptr + (n_a + 3) * step if want_adjoints else None,
        ptr + (n_a + 4) * step if want_adjoints else None,
        work.data_ptr() + 4 * S_CG, _ticket(dev, stream), work.data_ptr(), shape[0], shape[1],
        stream)
    _raise_on(err, "dual_update_tiled_2d")
    launch_counts["dual_update_tiled_2d"] += 1
    lat = out.unbind(0)
    res = (lat[:3] if want_alpha else None, lat[n_a:n_a + 3], work[S_STATS:S_STATS + 5])
    if want_adjoints:
        res += lat[n_a + 3:]
    return res


def _launch_gram(mode: int, name: str, v, counts, b, parts, rho, scales) -> torch.Tensor:
    dev = v.device
    oty, dta, u_scale, dtu = parts if parts is not None else (None, None, None, None)
    lib = _lib()
    out = torch.empty_like(v)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.mvtv_gram_tiled_2d(
        mode, v.data_ptr(), counts.data_ptr(), ptr(b), ptr(oty), ptr(dta), ptr(dtu),
        _scalar_ptr(rho, dev), None if u_scale is None else _scalar_ptr(u_scale, dev),
        *scales, out.data_ptr(), v.shape[0], v.shape[1], _stream(dev))
    _raise_on(err, name)
    launch_counts[name] += 1
    return out


def gram_residual_tiled_2d(b: Optional[torch.Tensor], v: torch.Tensor, counts: torch.Tensor,
                           rho, scales: Sequence[float], rhs_parts=None) -> torch.Tensor:
    """r0 = b - (counts + rho D'D) v in one pass.  rhs_parts = (oty, dta,
    u_scale, dtu): b = oty + rho (dta + u_scale dtu) is formed in the kernel
    and never stored (b is ignored and may be None)."""
    shape = tuple(v.shape)
    if rhs_parts is not None:
        oty, dta, u_scale, dtu = rhs_parts
        lattices = (v, counts, oty, dta, dtu)
    else:
        lattices = (v, counts, b)
    _check_lattices(shape, *lattices)
    if _route(*lattices) == "cpu":
        return gram_residual_tiled_2d_reference(b, v, counts, rho, scales, rhs_parts)
    mode = 2 if rhs_parts is not None else 1
    return _launch_gram(mode, "gram_residual_tiled_2d", v, counts,
                        None if rhs_parts is not None else b, rhs_parts, rho, scales)


def gram_matvec_tiled_2d(v: torch.Tensor, counts: torch.Tensor, rho,
                         scales: Sequence[float]) -> torch.Tensor:
    """(counts + rho D'D) v in one pass (the packed layout's r0 matvec)."""
    _check_lattices(tuple(v.shape), v, counts)
    if _route(v, counts) == "cpu":
        return gram_matvec_tiled_2d_reference(v, counts, rho, scales)
    return _launch_gram(0, "gram_matvec_tiled_2d", v, counts, None, None, rho, scales)


def rhs_tiled_2d(alpha: Sequence[torch.Tensor], u: Sequence[torch.Tensor], oty: torch.Tensor,
                 rho, u_scale, scales: Sequence[float]) -> torch.Tensor:
    """B11: B2's b = oty + rho D'(alpha + u_scale u) at any size, on B2's
    kernel.  No ADMM route launches it: the tiled loop reads the dta/dtu
    carries instead (as the JAX package's does)."""
    _check_lattices(tuple(oty.shape), oty, *alpha, *u)
    if _route(oty, *alpha, *u) == "cpu":
        return rhs_2d_reference(alpha, u, oty, rho, u_scale, scales)
    return _launch_rhs("rhs_tiled_2d", alpha, u, oty, rho, u_scale, scales)


# ---------------------------------------------------------------------------
# The row-slab kernels of the sharded route (parallel/tiled_shard.py)
# ---------------------------------------------------------------------------

def _halo_ptrs(halos_top, halos_bot, m1: int):
    """(rows above, rows below) of the slab as device pointers: the last row
    of each top halo array and the first of each bottom one, checked."""
    ptrs = []
    for k, h in enumerate((*halos_top, *halos_bot)):
        shp = h.shape
        if (h.dtype != torch.float32 or len(shp) != 2 or shp[0] < 1 or shp[1] != m1
                or not h.is_contiguous()):
            raise ValueError(f"expected contiguous float32 (h, {m1}) halo arrays, h >= 1, got "
                             f"{h.dtype} {tuple(shp)}")
        ptrs.append(h.data_ptr() + (4 * m1 * (shp[0] - 1) if k < len(halos_top) else 0))
    return ptrs[:len(halos_top)], ptrs[len(halos_top):]


def _check_slab(row_off: int, m0: int, m0_global: int) -> None:
    if not 0 <= row_off <= m0_global - m0:
        raise ValueError(f"a slab of {m0} rows at global row {row_off} does not fit a lattice "
                         f"of {m0_global} rows")


def dual_update_tiled_2d_shard(theta: torch.Tensor, u: Sequence[torch.Tensor], halos_top,
                               halos_bot, row_off: int, m0_global: int, kappa,
                               scales: Sequence[float], u_scale=None,
                               true_m: Optional[Tuple[int, int]] = None,
                               want_adjoints: bool = False, want_alpha: bool = True):
    """B8s: dual_update_tiled_2d's contract on a row slab (see above), halos
    in (theta, u0, u1, u2) order; the stats are this slab's partial sums,
    which the caller all-reduces.  On the card B8's kernel in its slab mode,
    one launch on B8's buffers; as B8, want_alpha != want_adjoints."""
    shape = tuple(theta.shape)
    _check_lattices(shape, theta, *u)
    _check_slab(row_off, shape[0], m0_global)
    top, bot = _halo_ptrs(halos_top, halos_bot, shape[1])
    if _route(theta, *u, *halos_top, *halos_bot) == "cpu":
        return dual_update_tiled_2d_shard_reference(theta, u, halos_top, halos_bot, row_off,
                                                    m0_global, kappa, scales, u_scale, true_m,
                                                    want_adjoints, want_alpha)
    if bool(want_alpha) == bool(want_adjoints):
        raise ValueError("dual_update_tiled_2d_shard on the card: want_alpha and want_adjoints "
                         f"must differ (got {want_alpha}, {want_adjoints})")
    dev = theta.device
    if u_scale is None:
        u_scale = torch.ones((), dtype=torch.float32, device=dev)
    n_a, n_d = (3 if want_alpha else 0), (2 if want_adjoints else 0)
    out, work = _dual_buffers(shape, n_a + 3 + n_d, dev)
    t0, t1 = (-1, -1) if true_m is None else (int(true_m[0]), int(true_m[1]))
    stream, ptr, step = _stream(dev), out.data_ptr(), 4 * shape[0] * shape[1]
    err = _lib().mvtv_dual_update_tiled_2d_shard(
        theta.data_ptr(), *(t.data_ptr() for t in u), top[0], bot[0], *top[1:],
        _scalar_ptr(kappa, dev), _scalar_ptr(u_scale, dev), *scales, t0, t1, int(row_off),
        int(m0_global), int(want_alpha), int(want_adjoints), ptr if want_alpha else None,
        ptr + n_a * step, ptr + (n_a + 3) * step if want_adjoints else None,
        ptr + (n_a + 4) * step if want_adjoints else None, work.data_ptr() + 4 * S_CG,
        _ticket(dev, stream), work.data_ptr(), shape[0], shape[1], stream)
    _raise_on(err, "dual_update_tiled_2d_shard")
    launch_counts["dual_update_tiled_2d_shard"] += 1
    lat = out.unbind(0)
    res = (lat[:3] if want_alpha else None, lat[n_a:n_a + 3], work[S_STATS:S_STATS + 5])
    if want_adjoints:
        res += lat[n_a + 3:]
    return res


def _launch_gram_slab(mode: int, name: str, v, top: int, bot: int, row_off, m0_global, counts,
                      b, parts, rho, scales) -> torch.Tensor:
    """B9s's kernel (csrc/tiled.cu) on CUDA tensors, the halo rows given as
    pointers (_halo_ptrs), counted under ``name``."""
    dev = v.device
    oty, dta, u_scale, dtu = parts if parts is not None else (None, None, None, None)
    out = torch.empty_like(v)
    err = _lib().mvtv_gram_tiled_2d_shard(
        mode, v.data_ptr(), top, bot, counts.data_ptr(), None if b is None else b.data_ptr(),
        None if oty is None else oty.data_ptr(), None if dta is None else dta.data_ptr(),
        None if dtu is None else dtu.data_ptr(), _scalar_ptr(rho, dev),
        None if u_scale is None else _scalar_ptr(u_scale, dev), *scales, int(row_off),
        int(m0_global), out.data_ptr(), v.shape[0], v.shape[1], _stream(dev))
    _raise_on(err, name)
    launch_counts[name] += 1
    return out


def gram_residual_tiled_2d_shard(b: Optional[torch.Tensor], v: torch.Tensor, halo_top,
                                 halo_bot, row_off: int, m0_global: int,
                                 counts: torch.Tensor, rho, scales: Sequence[float],
                                 rhs_parts=None) -> torch.Tensor:
    """B9s: gram_residual_tiled_2d on a row slab, halo_top and halo_bot v's
    halo arrays; rhs_parts as B9's (every part a slab)."""
    shape = tuple(v.shape)
    if rhs_parts is not None:
        oty, dta, u_scale, dtu = rhs_parts
        lattices = (v, counts, oty, dta, dtu)
    else:
        lattices = (v, counts, b)
    _check_lattices(shape, *lattices)
    _check_slab(row_off, shape[0], m0_global)
    (top,), (bot,) = _halo_ptrs([halo_top], [halo_bot], shape[1])
    if _route(*lattices, halo_top, halo_bot) == "cpu":
        return gram_residual_tiled_2d_shard_reference(b, v, halo_top, halo_bot, row_off,
                                                      m0_global, counts, rho, scales, rhs_parts)
    fused = rhs_parts is not None
    return _launch_gram_slab(2 if fused else 1, "gram_residual_tiled_2d_shard", v, top, bot,
                             row_off, m0_global, counts, None if fused else b, rhs_parts, rho,
                             scales)


def gram_matvec_tiled_2d_shard(v: torch.Tensor, halo_top, halo_bot, row_off: int,
                               m0_global: int, counts: torch.Tensor, rho,
                               scales: Sequence[float]) -> torch.Tensor:
    """(counts + rho D'D) v on a row slab: B9s's kernel in its matvec mode
    (B10's function), the sharded PCG's matvec."""
    shape = tuple(v.shape)
    _check_lattices(shape, v, counts)
    _check_slab(row_off, shape[0], m0_global)
    (top,), (bot,) = _halo_ptrs([halo_top], [halo_bot], shape[1])
    if _route(v, counts, halo_top, halo_bot) == "cpu":
        return gram_matvec_tiled_2d_shard_reference(v, halo_top, halo_bot, row_off, m0_global,
                                                    counts, rho, scales)
    return _launch_gram_slab(0, "gram_matvec_tiled_2d_shard", v, top, bot, row_off, m0_global,
                             counts, None, None, rho, scales)


def rhs_tiled_2d_shard(alpha: Sequence[torch.Tensor], u: Sequence[torch.Tensor], halos_top,
                       halos_bot, row_off: int, oty: torch.Tensor, rho, u_scale,
                       scales: Sequence[float]) -> torch.Tensor:
    """B11s: b = oty + rho D'(alpha + u_scale u) on a row slab, halos in
    (alpha0, alpha1, alpha2, u0, u1, u2) order.  No ADMM route launches it:
    the sharded loop reads the dta/dtu carries (as the JAX package's
    does)."""
    shape = tuple(oty.shape)
    _check_lattices(shape, oty, *alpha, *u)
    _check_slab(row_off, shape[0], row_off + shape[0])
    top, _ = _halo_ptrs(halos_top, halos_bot, shape[1])
    if _route(oty, *alpha, *u, *halos_top, *halos_bot) == "cpu":
        return rhs_tiled_2d_shard_reference(alpha, u, halos_top, halos_bot, row_off, oty, rho,
                                            u_scale, scales)
    dev = oty.device
    if u_scale is None:
        u_scale = torch.ones((), dtype=torch.float32, device=dev)
    b = torch.empty_like(oty)
    err = _lib().mvtv_rhs_tiled_2d_shard(
        *(t.data_ptr() for t in (*alpha, *u)), *(top[k] for k in (0, 2, 3, 5)),
        oty.data_ptr(), _scalar_ptr(rho, dev), _scalar_ptr(u_scale, dev), *scales,
        int(row_off), b.data_ptr(), shape[0], shape[1], _stream(dev))
    _raise_on(err, "rhs_tiled_2d_shard")
    launch_counts["rhs_tiled_2d_shard"] += 1
    return b


# ---------------------------------------------------------------------------
# The tiled kernels of p = 3 (the tiled3 route, from 2^22 knots)
# ---------------------------------------------------------------------------

def _check_blocks3(shape, scales, *block_sets):
    if len(scales) != 7 or any(len(blocks) != 7 for blocks in block_sets):
        raise ValueError("the 3-D kernels take the 7 blocks of BINARIES3 and their 7 scales")
    for blocks in block_sets:
        _check_lattices(shape, *blocks, rank=3)


def dual_update_tiled_3d(theta: torch.Tensor, u: Sequence[torch.Tensor], kappa,
                         scales: Sequence[float], u_scale=None,
                         true_m: Optional[Tuple[int, int, int]] = None,
                         want_adjoints: bool = False, want_alpha: bool = True):
    """The p = 3 z/dual stage (B1's contract over the 7 blocks):
    (alpha (7), u_new (7), stats (5,)), and with want_adjoints also (dta,
    dtu) = (D'alpha, D'u_new); with want_alpha=False the alpha slot is None.
    On the card the kernel is compiled for the pairs a route launches,
    want_alpha != want_adjoints; the plain version takes all four (the JAX
    signature).  true_m: the TRUE dims of a padded solve (row masks)."""
    shape = tuple(theta.shape)
    _check_lattices(shape, theta, rank=3)
    _check_blocks3(shape, scales, u)
    if _route(theta, *u) == "cpu":
        return dual_update_tiled_3d_reference(theta, u, kappa, scales, u_scale, true_m,
                                              want_adjoints, want_alpha)
    if bool(want_alpha) == bool(want_adjoints):
        raise ValueError("dual_update_tiled_3d on the card: want_alpha and want_adjoints must "
                         f"differ (got {want_alpha}, {want_adjoints})")
    dev = theta.device
    if u_scale is None:
        u_scale = torch.ones((), dtype=torch.float32, device=dev)
    lib = _lib()
    n_a, n_d = (7 if want_alpha else 0), (2 if want_adjoints else 0)
    out = torch.empty((n_a + 7 + n_d,) + shape, dtype=torch.float32, device=dev)
    scal = _scal_buffer(0, dev)
    # 5 partial sums per CTA of the plane march
    partials = torch.empty(5 * lib.mvtv_dual_update_tiled_3d_blocks(*shape),
                           dtype=torch.float32, device=dev)
    tm = (-1, -1, -1) if true_m is None else tuple(int(v) for v in true_m)
    err = lib.mvtv_dual_update_tiled_3d(
        theta.data_ptr(), *(t.data_ptr() for t in u), _scalar_ptr(kappa, dev),
        _scalar_ptr(u_scale, dev), *scales, *tm, int(want_alpha), int(want_adjoints),
        out[0].data_ptr() if want_alpha else None, out[n_a].data_ptr(),
        out[n_a + 7].data_ptr() if want_adjoints else None,
        out[n_a + 8].data_ptr() if want_adjoints else None,
        partials.data_ptr(), partials.numel(), scal.data_ptr(), *shape, _stream(dev))
    _raise_on(err, "dual_update_tiled_3d")
    launch_counts["dual_update_tiled_3d"] += 1
    res = (tuple(out[0:7].unbind(0)) if want_alpha else None,
           tuple(out[n_a:n_a + 7].unbind(0)), scal[S_STATS:S_STATS + 5])
    if want_adjoints:
        res += (out[n_a + 7], out[n_a + 8])
    return res


def gram_residual_tiled_3d(b: Optional[torch.Tensor], v: torch.Tensor, counts: torch.Tensor,
                           rho, scales: Sequence[float], rhs_parts=None) -> torch.Tensor:
    """r0 = b - (counts + rho D'D) v over the 7 blocks, in one pass.
    rhs_parts = (oty, dta, u_scale, dtu): b = oty + rho (dta + u_scale dtu)
    is formed in the kernel and never stored (b is ignored and may be
    None).  With b given it is (counts + rho D'D)'s residual of any b, the
    packed layout's r0."""
    shape = tuple(v.shape)
    if rhs_parts is not None:
        oty, dta, u_scale, dtu = rhs_parts
        lattices = (v, counts, oty, dta, dtu)
    else:
        lattices = (v, counts, b)
    _check_lattices(shape, *lattices, rank=3)
    _check_blocks3(shape, scales)
    if _route(*lattices) == "cpu":
        return gram_residual_tiled_3d_reference(b, v, counts, rho, scales, rhs_parts)
    dev = v.device
    lib = _lib()
    out = torch.empty_like(v)
    fused = rhs_parts is not None
    err = lib.mvtv_gram_tiled_3d(
        2 if fused else 1, v.data_ptr(), counts.data_ptr(), None if fused else b.data_ptr(),
        *((oty.data_ptr(), dta.data_ptr(), dtu.data_ptr()) if fused else (None,) * 3),
        _scalar_ptr(rho, dev), _scalar_ptr(u_scale, dev) if fused else None, *scales,
        out.data_ptr(), *shape, _stream(dev))
    _raise_on(err, "gram_residual_tiled_3d")
    launch_counts["gram_residual_tiled_3d"] += 1
    return out


def rhs_tiled_3d(alpha: Sequence[torch.Tensor], u: Sequence[torch.Tensor], oty: torch.Tensor,
                 rho, u_scale, scales: Sequence[float]) -> torch.Tensor:
    """b = oty + rho D'(alpha + u_scale u) over the 7 blocks (u_scale None
    = 1).  No ADMM route launches it: the tiled3 loop reads the dta/dtu
    carries instead (as the JAX package's does)."""
    shape = tuple(oty.shape)
    _check_lattices(shape, oty, rank=3)
    _check_blocks3(shape, scales, alpha, u)
    if _route(oty, *alpha, *u) == "cpu":
        return rhs_tiled_3d_reference(alpha, u, oty, rho, u_scale, scales)
    dev = oty.device
    if u_scale is None:
        u_scale = torch.ones((), dtype=torch.float32, device=dev)
    lib = _lib()
    b = torch.empty_like(oty)
    err = lib.mvtv_rhs_tiled_3d(*(t.data_ptr() for t in (*alpha, *u, oty)),
                                _scalar_ptr(rho, dev), _scalar_ptr(u_scale, dev), *scales,
                                b.data_ptr(), *shape, _stream(dev))
    _raise_on(err, "rhs_tiled_3d")
    launch_counts["rhs_tiled_3d"] += 1
    return b


# ---------------------------------------------------------------------------
# The plane-slab kernels of the sharded route at p = 3 (parallel/tiled_shard.py)
# ---------------------------------------------------------------------------

def _plane_ptrs(halos, first: bool, plane):
    """Device pointers of the halo arrays' planes next to the slab (the last
    plane of each top array, the first of each bottom one), checked."""
    ptrs = []
    for h in halos:
        shp = tuple(h.shape)
        if (h.dtype != torch.float32 or len(shp) != 3 or shp[0] < 1 or shp[1:] != plane
                or not h.is_contiguous()):
            raise ValueError(f"expected contiguous float32 (h, {plane[0]}, {plane[1]}) halo "
                             f"arrays, h >= 1, got {h.dtype} {shp}")
        ptrs.append(h.data_ptr() + (0 if first else 4 * plane[0] * plane[1] * (shp[0] - 1)))
    return ptrs


def dual_update_tiled_3d_shard(theta: torch.Tensor, u: Sequence[torch.Tensor], halos_top,
                               halos_bot, row_off: int, m0_global: int, kappa,
                               scales: Sequence[float], u_scale=None,
                               true_m: Optional[Tuple[int, int, int]] = None,
                               want_adjoints: bool = False, want_alpha: bool = True):
    """B12s: dual_update_tiled_3d's contract on a plane slab (see the plain
    versions), halos in (theta, u0, .., u6) order; the stats are this
    slab's partial sums, which the caller all-reduces.  On the card B12's
    plane march in its slab mode, one launch (and B12's finish pass); as
    B12, want_alpha != want_adjoints."""
    shape = tuple(theta.shape)
    _check_lattices(shape, theta, rank=3)
    _check_blocks3(shape, scales, u)
    _check_slab(row_off, shape[0], m0_global)
    if len(halos_top) != 8 or len(halos_bot) != 8:
        raise ValueError("B12s takes 8 top and 8 bottom halo arrays (theta, u0 .. u6)")
    top = _plane_ptrs(halos_top, False, shape[1:])
    bot = _plane_ptrs(halos_bot[:1], True, shape[1:])
    if _route(theta, *u, *halos_top, *halos_bot) == "cpu":
        return dual_update_tiled_3d_shard_reference(theta, u, halos_top, halos_bot, row_off,
                                                    m0_global, kappa, scales, u_scale, true_m,
                                                    want_adjoints, want_alpha)
    if bool(want_alpha) == bool(want_adjoints):
        raise ValueError("dual_update_tiled_3d_shard on the card: want_alpha and want_adjoints "
                         f"must differ (got {want_alpha}, {want_adjoints})")
    dev = theta.device
    if u_scale is None:
        u_scale = torch.ones((), dtype=torch.float32, device=dev)
    lib = _lib()
    n_a, n_d = (7 if want_alpha else 0), (2 if want_adjoints else 0)
    out = torch.empty((n_a + 7 + n_d,) + shape, dtype=torch.float32, device=dev)
    scal = _scal_buffer(0, dev)
    partials = torch.empty(5 * lib.mvtv_dual_update_tiled_3d_blocks(*shape),
                           dtype=torch.float32, device=dev)
    tm = (-1, -1, -1) if true_m is None else tuple(int(v) for v in true_m)
    err = lib.mvtv_dual_update_tiled_3d_shard(
        theta.data_ptr(), *(t.data_ptr() for t in u), top[0], bot[0], *top[1:],
        _scalar_ptr(kappa, dev), _scalar_ptr(u_scale, dev), *scales, *tm, int(row_off),
        int(m0_global), int(want_alpha), int(want_adjoints),
        out[0].data_ptr() if want_alpha else None, out[n_a].data_ptr(),
        out[n_a + 7].data_ptr() if want_adjoints else None,
        out[n_a + 8].data_ptr() if want_adjoints else None,
        partials.data_ptr(), partials.numel(), scal.data_ptr(), *shape, _stream(dev))
    _raise_on(err, "dual_update_tiled_3d_shard")
    launch_counts["dual_update_tiled_3d_shard"] += 1
    res = (tuple(out[0:7].unbind(0)) if want_alpha else None,
           tuple(out[n_a:n_a + 7].unbind(0)), scal[S_STATS:S_STATS + 5])
    if want_adjoints:
        res += (out[n_a + 7], out[n_a + 8])
    return res


def _launch_gram3_slab(mode: int, name: str, v, top: int, bot: int, row_off, m0_global, counts,
                       b, parts, rho, scales) -> torch.Tensor:
    """mvtv_gram_tiled_3d_shard (csrc/tiled3.cu) on CUDA tensors, v's halo
    planes given as pointers, counted under ``name``: B13s's plane march in
    modes 1 and 2, the Laplacian march in mode 0 (the matvec)."""
    dev = v.device
    oty, dta, u_scale, dtu = parts if parts is not None else (None, None, None, None)
    out = torch.empty_like(v)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = _lib().mvtv_gram_tiled_3d_shard(
        mode, v.data_ptr(), top, bot, counts.data_ptr(), ptr(b), ptr(oty), ptr(dta), ptr(dtu),
        _scalar_ptr(rho, dev), None if u_scale is None else _scalar_ptr(u_scale, dev),
        *scales, int(row_off), int(m0_global), out.data_ptr(), *v.shape, _stream(dev))
    _raise_on(err, name)
    launch_counts[name] += 1
    return out


def gram_residual_tiled_3d_shard(b: Optional[torch.Tensor], v: torch.Tensor, halo_top,
                                 halo_bot, row_off: int, m0_global: int,
                                 counts: torch.Tensor, rho, scales: Sequence[float],
                                 rhs_parts=None) -> torch.Tensor:
    """B13s: gram_residual_tiled_3d on a plane slab, halo_top and halo_bot
    v's halo arrays; rhs_parts as B13's (every part a slab)."""
    shape = tuple(v.shape)
    if rhs_parts is not None:
        oty, dta, u_scale, dtu = rhs_parts
        lattices = (v, counts, oty, dta, dtu)
    else:
        lattices = (v, counts, b)
    _check_lattices(shape, *lattices, rank=3)
    _check_blocks3(shape, scales)
    _check_slab(row_off, shape[0], m0_global)
    (top,), (bot,) = (_plane_ptrs([halo_top], False, shape[1:]),
                      _plane_ptrs([halo_bot], True, shape[1:]))
    if _route(*lattices, halo_top, halo_bot) == "cpu":
        return gram_residual_tiled_3d_shard_reference(b, v, halo_top, halo_bot, row_off,
                                                      m0_global, counts, rho, scales, rhs_parts)
    fused = rhs_parts is not None
    return _launch_gram3_slab(2 if fused else 1, "gram_residual_tiled_3d_shard", v, top, bot,
                              row_off, m0_global, counts, None if fused else b, rhs_parts, rho,
                              scales)


def gram_matvec_tiled_3d_shard(v: torch.Tensor, halo_top, halo_bot, row_off: int,
                               m0_global: int, counts: torch.Tensor, rho,
                               scales: Sequence[float]) -> torch.Tensor:
    """(counts + rho D'D) v on a plane slab, the sharded PCG's matvec at
    p = 3: on the card the Laplacian march (csrc/tiled3.cu), one launch;
    on the CPU its plain version, the block sum of B13s's."""
    shape = tuple(v.shape)
    _check_lattices(shape, v, counts, rank=3)
    _check_blocks3(shape, scales)
    _check_slab(row_off, shape[0], m0_global)
    (top,), (bot,) = (_plane_ptrs([halo_top], False, shape[1:]),
                      _plane_ptrs([halo_bot], True, shape[1:]))
    if _route(v, counts, halo_top, halo_bot) == "cpu":
        return gram_matvec_tiled_3d_shard_reference(v, halo_top, halo_bot, row_off, m0_global,
                                                    counts, rho, scales)
    return _launch_gram3_slab(0, "gram_matvec_tiled_3d_shard", v, top, bot, row_off, m0_global,
                              counts, None, None, rho, scales)


def stream_copy(src: torch.Tensor, dst: torch.Tensor, blocks: int = 132 * 8) -> None:
    """The streaming-copy probe (csrc/probe.cu): dst = src, float32 CUDA
    tensors of one size, a multiple of 4.  No solver path calls it."""
    if (src.dtype != torch.float32 or dst.dtype != torch.float32 or src.shape != dst.shape
            or not (src.is_contiguous() and dst.is_contiguous()) or src.numel() % 4
            or src.device.type != "cuda" or dst.device != src.device):
        raise ValueError("stream_copy takes two contiguous float32 CUDA tensors of one shape "
                         "with a multiple of 4 elements")
    _raise_on(_lib().mvtv_stream_copy(src.data_ptr(), dst.data_ptr(), src.numel(), blocks,
                                      _stream(src.device)), "stream_copy")


def dual_struct(ins: Sequence[torch.Tensor], n_out: int, prox: bool):
    """The structure probe of B8 (csrc/probe.cu, dual_struct_reference's
    function) on CUDA lattices: (outputs, sum of d0^2 or None).  No solver
    path calls it."""
    shape = tuple(ins[0].shape)
    _check_lattices(shape, *ins)
    if not (1 <= len(ins) <= 8 and 1 <= n_out <= 8 and (len(ins) >= 2 or not prox)
            and _route(*ins) == "cuda"):
        raise ValueError("dual_struct takes 1 to 8 CUDA lattices (2 with prox) and 1 to 8 "
                         "outputs")
    dev = ins[0].device
    outs = [torch.empty_like(ins[0]) for _ in range(n_out)]
    partials = _partials(shape, 1, dev)
    in_ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
    out_ptrs = (ctypes.c_void_p * n_out)(*(t.data_ptr() for t in outs))
    _raise_on(_lib().mvtv_dual_struct(in_ptrs, len(ins), out_ptrs, n_out, int(prox),
                                      partials.data_ptr(), shape[0], shape[1], _stream(dev)),
              "dual_struct")
    launch_counts["dual_struct"] += 1
    return outs, (torch.sum(partials) if prox else None)


_TRIDIAG_WORK = {}
_TRIDIAG_FLOATS = {}


def _tridiag_work(lib, n: int, device, stream: int, segment: bool = False) -> int:
    """Device pointer of T1's scratch for n rows (of its three systems in
    the segment mode) on one stream of ``device``: 8 floats a segment of
    the segment solve, or the levels of the multi-level route
    (``mvtv_xupdate_tridiag_work``, ``..._segment_work``; asked once per
    n and mode); one buffer per device and stream, grown when a call needs
    more.  Launches on one stream run in order, so they share it."""
    need = _TRIDIAG_FLOATS.get((device.index, n, segment))
    if need is None:
        need = int(lib.mvtv_xupdate_tridiag_segment_work(n) if segment
                   else lib.mvtv_xupdate_tridiag_work(n))
        if need < 0:
            _raise_on(-need, "xupdate_tridiag")
        _TRIDIAG_FLOATS[(device.index, n, segment)] = need
    key = (device.index, stream)
    buf = _TRIDIAG_WORK.get(key)
    if buf is None or buf.numel() < need:
        # at least the segment solve's most: 8 floats for each of 512 segments
        buf = torch.empty(max(need, 8 * 512), dtype=torch.float32, device=device)
        _TRIDIAG_WORK[key] = buf
    return buf.data_ptr()


def xupdate_tridiag(counts: torch.Tensor, b: torch.Tensor, rho, scale: float) -> torch.Tensor:
    """T1, the exact p = 1 x-update: x with (diag(counts) + (rho s) s T) x =
    b, T the Neumann second difference (solver/tridiag.py).  counts and b
    are contiguous float32 (n,); rho a float32 scalar tensor on their
    device, read by the kernel through its pointer.  On the card one launch
    up to N_res rows (~1.6 M on an H100: the segment solve, cooperative
    above 4,096 rows), 2 L + 1 above for L partition levels; one allocation
    (x), the scratch cached per device and stream."""
    for v in (counts, b):
        if v.dtype != torch.float32 or v.ndim != 1 or v.shape != b.shape or not v.is_contiguous():
            raise ValueError(f"expected contiguous float32 counts and b of one shape (n,), got "
                             f"{v.dtype} {tuple(v.shape)}")
    n = int(b.shape[0])
    if _route(counts, b) == "cpu":
        return xupdate_tridiag_reference(counts, b, rho, scale)
    dev = b.device
    lib = _lib()
    stream = _stream(dev)
    x = torch.empty_like(b)
    err = lib.mvtv_xupdate_tridiag(counts.data_ptr(), b.data_ptr(), _scalar_ptr(rho, dev),
                                   float(scale), x.data_ptr(), _tridiag_work(lib, n, dev, stream),
                                   n, stream)
    _raise_on(err, "xupdate_tridiag")
    launch_counts["xupdate_tridiag"] += 1
    return x


def xupdate_tridiag_segment(counts: torch.Tensor, b: torch.Tensor, rho, scale: float,
                            open_lo: bool, open_hi: bool) -> torch.Tensor:
    """T1's segment mode, one rank's segment of a chain (solver/tridiag.py::
    partition_xupdate): x of shape (3, n), the segment's principal
    submatrix of the chain's system (diag(counts) + (rho s) s T, T's
    diagonal kept at 2 at the open ends, those inside the chain) solved
    for b, e_0 and e_{n-1}.  On the card one launch while the segment solve
    holds the three systems (the multi-level route above runs them one
    after another); the kernel forms e_0 and e_{n-1} itself, so it reads
    counts and b only.  The scratch is T1's, grown to fit."""
    for v in (counts, b):
        if v.dtype != torch.float32 or v.ndim != 1 or v.shape != b.shape or not v.is_contiguous():
            raise ValueError(f"expected contiguous float32 counts and b of one shape (n,), got "
                             f"{v.dtype} {tuple(v.shape)}")
    n = int(b.shape[0])
    if _route(counts, b) == "cpu":
        return xupdate_tridiag_segment_reference(counts, b, rho, scale, open_lo, open_hi)
    dev = b.device
    lib = _lib()
    stream = _stream(dev)
    x = torch.empty((3, n), dtype=torch.float32, device=dev)
    err = lib.mvtv_xupdate_tridiag_segment(
        counts.data_ptr(), b.data_ptr(), _scalar_ptr(rho, dev), float(scale),
        int(bool(open_lo)) | (int(bool(open_hi)) << 1), x.data_ptr(),
        _tridiag_work(lib, n, dev, stream, segment=True), n, stream)
    _raise_on(err, "xupdate_tridiag_segment")
    launch_counts["xupdate_tridiag_segment"] += 1
    return x


def partition_finish(every: torch.Tensor, rank: int, scale: float,
                     ylr: torch.Tensor) -> torch.Tensor:
    """The partition solve's finish on rank ``rank`` (solver/tridiag.py::
    partition_xupdate): x of shape (n,) from every rank's six segment ends
    and rho, gathered into ``every`` (W, 7), and this rank's segment solve
    ``ylr`` (3, n, ``xupdate_tridiag_segment``'s output).  On the card one
    launch: each CTA solves the 2W-unknown interface system in float64 (g
    from rank 0's rho, as T1 rounds it) and writes its rows of
    y + (g x_{k-1}[L]) l + (g x_{k+1}[0]) r; up to 256 ranks."""
    if every.dtype != torch.float32 or every.ndim != 2 or every.shape[1] != 7 \
            or not every.is_contiguous():
        raise ValueError(f"expected contiguous float32 ends of shape (W, 7), got {every.dtype} "
                         f"{tuple(every.shape)}")
    if ylr.dtype != torch.float32 or ylr.ndim != 2 or ylr.shape[0] != 3 \
            or not ylr.is_contiguous():
        raise ValueError(f"expected a contiguous float32 segment solve of shape (3, n), got "
                         f"{ylr.dtype} {tuple(ylr.shape)}")
    w, n = int(every.shape[0]), int(ylr.shape[1])
    if not 0 <= rank < w:
        raise ValueError(f"rank {rank} outside a group of {w}")
    if _route(every, ylr) == "cpu":
        return partition_finish_reference(every, rank, scale, ylr)
    dev = ylr.device
    x = torch.empty(n, dtype=torch.float32, device=dev)
    err = _lib().mvtv_partition_finish(every.data_ptr(), w, int(rank), float(scale),
                                       ylr.data_ptr(), x.data_ptr(), n, _stream(dev))
    _raise_on(err, "partition_finish")
    launch_counts["partition_finish"] += 1
    return x
