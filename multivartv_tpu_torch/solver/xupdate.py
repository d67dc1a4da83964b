"""The ADMM x-update: solve (diag(counts) + rho D'D) theta = b.

Counterpart of ``multivartv_tpu/solver/xupdate.py``.  ``solve_x`` takes the
JAX package's branches in its order (xupdate.py:378-527): ``dct_direct``
(the exact DCT solve of (mean(counts) I + rho D'D), ``ops/dct.py::
shifted_solve``) on every route; then at p = 1 with dct_pcg the exact
tridiagonal solve (solver/tridiag.py, no CG step): ``xupdate_tridiag``
(T1) on the "tridiag" kernel route, the plain cyclic reduction on the
exact route; then for ``dct_pcg`` by route:

  * the whole-lattice route (``use_kernels``, 2-D up to 2^20 knots), where
    the dense DCT matrices exist (up to 2048 per axis): n fixed PCG steps
    preconditioned by the bf16 DCT solve of (mean(counts) I + rho D'D) in
    one launch of ``xupdate_pcg_2d_packed`` (folded halves, even axes) or
    ``xupdate_pcg_2d`` (dense matrices, an odd axis) where the one-kernel
    gate passes (``one_kernel``, the caller's admm.xupdate_supported), else
    the fused-dot PCG with ``gram_matvec_2d`` as its matvec and the dense
    preconditioner in float32 or, with ``precond_bf16``, bf16 products
    (JAX: xupdate.py:392-437; those products are plain matrix products in
    the JAX package too).  Without dense matrices and with folded halves,
    the spectral-correction CG below with a plain r0 (xupdate.py:439-487);
    ``whole_xupdate`` names the branch;
  * the tiled routes (``tiled``: 2-D above 2^20 knots, 3-D from 2^22): the
    spectral-correction CG (JAX: xupdate.py:439-487).  r0 = b - A x0 is
    formed exactly in float32 in the natural domain by
    ``gram_residual_tiled_2d`` (B9) or ``gram_residual_tiled_3d`` (B13),
    with b's assembly from the adjoint carries fused in; in the packed
    layout by ``gram_matvec_tiled_2d`` (B10) in 2-D, and in 3-D by B13 with
    b given, which is the same b - A x0 that the JAX package takes through
    its plain matvec there.  The correction dx is solved from zero in the
    spectral domain, where D'D is the diagonal of Gram eigenvalues and the
    preconditioner a diagonal scale;
  * the spectral routes (``spectral``: 3-D below 2^22 knots, p >= 4, and
    2-D with the reduced block set): the same CG with r0 = b - A x0 in plain
    PyTorch, as the JAX package runs it on such lattices with no kernel
    (its ``residual=None``, xupdate.py:376).  In every spectral-CG route the
    transforms are the bf16-operand products of ops/dct.py in the
    quartered, blocked or packed layout (``spectral_layout``), the block
    vectors float32 or, above 2^23 knots, bf16 (``spectral_vec_dtype``);
  * ``SolverConfig(spectral_cg=False)`` on the routes above (those where
    ``xla_packed_applies``): the fixed-step bf16 PCG in the natural domain,
    its preconditioner the packed DCT solve on the bf16 folded halves, its
    matvec ``gram_matvec_tiled_2d`` (B10) on the 2-D tiled route (JAX
    xupdate.py:489-500); b is formed from the carries, so B9 is not
    launched;
  * everywhere else (among others the tiled and spectral routes above
    8192 per axis, where no folded halves exist, and every route of the
    spectral CG under ``SolverConfig(xla_packed=False)``, the exact
    float32 arm with the route's kernels kept on), and for ``jacobi_pcg``
    and ``cg`` on every route, the plain PCG (fixed steps with
    ``cg_fixed_iters``, else tolerance-driven):
    preconditioned by the dense float32 DCT solve with TF32 off, or the FFT
    DCT above 2048 per axis (dct_pcg), by 1 / (counts + rho diag(D'D))
    (jacobi_pcg), or by nothing (cg); its matvec is ``gram_matvec_tiled_2d``
    on the 2-D tiled route, as the JAX package's ``tiled_ok`` makes it
    (xupdate.py:333-340, 502-527).  The exact-f32 route is this PCG.

Operators cut to slabs (a sharded fit, parallel/; the shard route) take
the same three arms as the routes above, by ``xla_packed_applies`` and
SolverConfig, as the JAX package's sharded x-update on a TPU
(xupdate.py:360-376, 439-500):

  * the spectral-correction CG across ranks (``_solve_spectral_sharded``):
    the single card's layout and vector type on the global lattice, r0
    from ``gram_residual_tiled_2d_shard`` (B9s, p = 2) or
    ``gram_residual_tiled_3d_shard`` (B13s, p = 3) with b formed in the
    kernel from the carries, or in plain PyTorch at p >= 4 and with the
    reduced block set; the transforms of parallel/spectral.py (axes
    1 .. p-1 on the slab, axis 0 on the pencil after one all_to_all; the
    spectral blocks and the eigenvalue blocks on the pencil, the counts
    product on the slab), every dot a sum over the row group;
  * ``spectral_cg=False``: the natural-domain bf16 PCG, its matvec B9s's
    matvec mode (p = 2) or the slab matvec ``gram_matvec_tiled_3d_shard``
    (p = 3; plain PyTorch elsewhere), its preconditioner the packed bf16
    DCT solve across ranks;
  * ``xla_packed=False``, odd axes and the other x-solvers: the plain PCG
    on the slabs, r0 from B9s given b or B13s with b formed from the
    carries, its matvec the same as the natural arm's, the dense float32
    DCT preconditioner through the pencil transpose (``_sharded_dct_solve``).

At p = 1 under dct_pcg the x-update is the partition solve
(solver/tridiag.py::partition_xupdate: T1 on each rank's segment).

The JAX package's ``stack_elementwise`` option (off in production) is not
ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from multivartv_tpu_torch.config import SolverConfig
from multivartv_tpu_torch.ops import dct as dct_ops
from multivartv_tpu_torch.ops import kernels
from multivartv_tpu_torch.solver import tridiag
from multivartv_tpu_torch.solver.cg import _dots, _poison_if_nonfinite, pcg, pcg_fixed, pcg_fused
from multivartv_tpu_torch.solver.problem import Operators

# Smallest half-width of every axis for the blocked layout; below it the
# packed layout runs (JAX xupdate.py:37-41).  Tests lower it.
BLOCKED_MIN_HALF = 128

_F32 = torch.float32
_EPS = 1e-30


def n_fixed_steps(cfg: SolverConfig) -> int:
    return cfg.cg_fixed_iters if cfg.cg_fixed_iters is not None else 3


def xla_packed_applies(ops: Operators, cfg: SolverConfig) -> bool:
    """Whether the x-update runs the folded bf16 DCT (JAX
    _xla_packed_applies, xupdate.py:44-58): SolverConfig.xla_packed with
    dct_pcg where the folded halves and their packed eigenvalues exist.
    The JAX package also asks for a TPU; the port asks nothing of the
    device, so it holds wherever the routes of the spectral-correction CG
    run (the tiled, tiled3 and spectral routes, and the whole route without
    dense DCT matrices).  On the whole route with dense matrices the
    kernels B3, B6 and B7 come first, as in the JAX package."""
    return (cfg.xla_packed and cfg.x_solver == "dct_pcg" and ops.dct_halves is not None
            and ops.gram_eigs_packed is not None)


def spectral_layout(ops: Operators) -> Optional[str]:
    """The spectral CG's layout: "quartered" (depth-2 fast DCT), "blocked"
    (every half-width >= BLOCKED_MIN_HALF), "packed", or None without the
    packed operand set."""
    if ops.dct_halves is None or ops.gram_eigs_packed is None:
        return None
    if ops.gram_eigs_quartered is not None and ops.dct_quarters_lp is not None:
        return "quartered"
    if ops.gram_eigs_blocked is not None and all(v // 2 >= BLOCKED_MIN_HALF for v in ops.m):
        return "blocked"
    return "packed"


def spectral_vec_dtype(ops: Operators, cfg: SolverConfig):
    """bf16 when the spectral CG stores its block vectors in bf16
    (SolverConfig.spectral_vec_bf16; None = above 2^23 knots), else None
    (the problem's float32)."""
    use = (cfg.spectral_vec_bf16 if cfg.spectral_vec_bf16 is not None
           else ops.ntheta > (1 << 23))
    return torch.bfloat16 if use else None


def counts_to_layout(ops: Operators, counts: torch.Tensor, cfg: SolverConfig):
    """counts in the spectral CG's block layout, converted once per solve
    (None in the packed layout).  In the bf16-vector regime the blocks are
    bf16 too, unless a count exceeds 256, the largest integer bf16 holds
    exactly (JAX xupdate.py:114-152; the port's counts are always concrete,
    so the rule is applied to their values)."""
    lay = spectral_layout(ops)
    p = len(ops.m)
    top = torch.max(counts)
    if ops.slab is not None and lay in ("quartered", "blocked"):
        # On slabs the counts product runs in the natural layout
        # (parallel/spectral.py); the largest count is the group's.
        from multivartv_tpu_torch.parallel.halo import pmax
        out, top = (counts,), pmax(top, ops.slab.group)
    elif lay == "quartered":
        out = dct_ops.to_blocks4(counts, p)
    elif lay == "blocked":
        out = dct_ops.to_blocks(counts, p)
    else:
        return None
    vd = spectral_vec_dtype(ops, cfg)
    if vd is not None and not float(top) > 256.0:
        out = tuple(c.to(vd) for c in out)
    return out


def _spectral_cg_generic(r0, x0, to_b, from_b, fwd, inv, eigs_blocks, rho, cbar,
                         n_steps: int, counts_b, vec_dtype=None,
                         gsum=None) -> Tuple[torch.Tensor, int]:
    """Fixed-step spectral-correction CG over a tuple-of-blocks layout from
    the natural-domain residual r0 (JAX xupdate.py:155-256, without
    stack_elementwise): vectors stored in vec_dtype, every dot and weight
    in float32, z = r / w never stored, the last step's direction update
    skipped.  Every cast is explicit: torch keeps a 0-dim float32 tensor
    times a bf16 tensor in bf16, where JAX promotes to float32.  gsum: the
    sum of a dot over the row group (slabs, parallel/spectral.py)."""
    vd = r0.dtype if vec_dtype is None else vec_dtype
    if gsum is None:
        def gsum(x):
            return x

    def bmap(f, *ts):
        return tuple(f(*xs) for xs in zip(*ts))

    def weight(e):
        return cbar + rho * e.to(_F32)

    def bdot(a, c):
        return gsum(sum(torch.sum(x.to(_F32) * y.to(_F32)) for x, y in zip(a, c)))

    def wdot(a):
        return gsum(sum(torch.sum(torch.square(x.to(_F32)) / weight(e))
                        for x, e in zip(a, eigs_blocks)))

    rh = fwd(tuple(v.to(vd) for v in to_b(r0)))
    p = bmap(lambda r, e: (r.to(_F32) / weight(e)).to(vd), rh, eigs_blocks)
    rz = wdot(rh)
    xh = tuple(torch.zeros_like(r) for r in rh)
    for step in range(n_steps):
        f = fwd(bmap(lambda c, v: (c * v.to(c.dtype)).to(vd), counts_b, inv(p)))
        ap = bmap(lambda ff, e, pp: (ff.to(_F32) + rho * e.to(_F32) * pp.to(_F32)).to(vd),
                  f, eigs_blocks, p)
        alpha_cg = rz / torch.clamp_min(bdot(p, ap), _EPS)
        xh = bmap(lambda x_, pp: (x_.to(_F32) + alpha_cg * pp.to(_F32)).to(vd), xh, p)
        rh = bmap(lambda r, a: (r.to(_F32) - alpha_cg * a.to(_F32)).to(vd), rh, ap)
        rz_new = wdot(rh)
        if step + 1 < n_steps:
            beta = rz_new / torch.clamp_min(rz, _EPS)
            p = bmap(lambda r, e, pp: (r.to(_F32) / weight(e) + beta * pp.to(_F32)).to(vd),
                     rh, eigs_blocks, p)
        rz = rz_new
    x = x0 + from_b(inv(xh)).to(x0.dtype)
    return _poison_if_nonfinite(x, rz), n_steps


def _spectral_cg_blocked(ops: Operators, r0, x0, rho, cbar, n_steps: int, counts_b,
                         vec_dtype=None):
    """The spectral CG in the blocked (2^p halves) layout."""
    p = len(ops.m)
    halves = ops.dct_halves_lp
    eigs = ops.gram_eigs_blocked
    if vec_dtype is not None and ops.gram_eigs_blocked_lp is not None:
        eigs = ops.gram_eigs_blocked_lp
    return _spectral_cg_generic(
        r0, x0, to_b=lambda v: dct_ops.to_blocks(v, p),
        from_b=lambda v: dct_ops.from_blocks(v, p),
        fwd=lambda v: dct_ops.dctn_blocked(v, halves),
        inv=lambda v: dct_ops.idctn_blocked(v, halves), eigs_blocks=eigs, rho=rho, cbar=cbar,
        n_steps=n_steps, counts_b=counts_b, vec_dtype=vec_dtype)


def _spectral_cg_quartered(ops: Operators, r0, x0, rho, cbar, n_steps: int, counts_b,
                           vec_dtype=None):
    """The spectral CG in the quartered (depth-2 fast DCT) layout."""
    p = len(ops.m)
    quarters = ops.dct_quarters_lp
    eigs = ops.gram_eigs_quartered
    if vec_dtype is not None and ops.gram_eigs_quartered_lp is not None:
        eigs = ops.gram_eigs_quartered_lp
    return _spectral_cg_generic(
        r0, x0, to_b=lambda v: dct_ops.to_blocks4(v, p),
        from_b=lambda v: dct_ops.from_blocks4(v, p),
        fwd=lambda v: dct_ops.dctn_quartered(v, quarters),
        inv=lambda v: dct_ops.idctn_quartered(v, quarters), eigs_blocks=eigs, rho=rho,
        cbar=cbar, n_steps=n_steps, counts_b=counts_b, vec_dtype=vec_dtype)


def _spectral_cg_packed(ops: Operators, counts, r0, x0, rho, cbar, n_steps: int):
    """The spectral CG in the packed (concatenated) layout, one block of
    float32 vectors (JAX xupdate.py:61-84, its fwd/inv the bf16 dctn_packed
    of any p): small-axis lattices, e.g. (192, 8192) or 128^3."""
    halves = ops.dct_halves_lp

    def fwd(t):
        return (dct_ops.dctn_packed(t[0], halves),)

    def inv(t):
        return (dct_ops.idctn_packed(t[0], halves),)

    return _spectral_cg_generic(
        r0, x0, to_b=lambda v: (v,), from_b=lambda t: t[0], fwd=fwd, inv=inv,
        eigs_blocks=(ops.gram_eigs_packed,), rho=rho, cbar=cbar, n_steps=n_steps,
        counts_b=(counts,))


def _initial_residual(ops: Operators, counts, b, rho, x0, lay: str, kernel: bool, rhs_parts):
    """r0 = b - (counts + rho D'D) x0 of the spectral CG (see module doc)."""
    if not kernel:
        return b - (counts * x0 + rho * ops.apply_gram(x0))
    three = len(ops.m) == 3
    if lay == "packed":
        if b is None:
            oty, dta, u_scale, dtu = rhs_parts
            b = oty + rho * (dta + u_scale * dtu)
        if three:
            return kernels.gram_residual_tiled_3d(b, x0, counts, rho, ops.scales)
        return b - kernels.gram_matvec_tiled_2d(x0, counts, rho, ops.scales)
    residual = kernels.gram_residual_tiled_3d if three else kernels.gram_residual_tiled_2d
    return residual(b, x0, counts, rho, ops.scales, rhs_parts=rhs_parts)


def _shard_residual(ops: Operators, counts, b, rho, x0, rhs_parts, kernel: bool):
    """r0 = b - (counts + rho D'D) x0 on slabs: B9s (p = 2) or B13s (p = 3)
    with b formed in the kernel from rhs_parts where the slab kernels run
    (kernel: the route's carries, admm._carries), else plain PyTorch with b
    given (the JAX package's residual=None)."""
    from multivartv_tpu_torch.parallel import tiled_shard
    slab = ops.slab
    if not kernel:
        return b - (counts * x0 + rho * ops.apply_gram(x0))
    residual = (tiled_shard.gram_residual_tiled_3d_sharded if len(ops.m) == 3
                else tiled_shard.gram_residual_tiled_2d_sharded)
    return residual(slab, None if rhs_parts is not None else b, x0, counts, rho, ops.scales,
                    rhs_parts=rhs_parts)


def _solve_spectral_sharded(ops: Operators, counts, cbar, b, rho, x0, cfg: SolverConfig,
                            counts_layout, rhs_parts, kernel: bool):
    """The spectral-correction CG across ranks on slabs: the single card's
    layout and vector type on the global lattice, r0 from the slab kernels
    (_shard_residual), the transforms of parallel/spectral.py (the
    spectral blocks on the pencil, the counts product on the slab), every
    dot summed over the row group."""
    from multivartv_tpu_torch.parallel import spectral
    from multivartv_tpu_torch.parallel.halo import psum
    lay = spectral_layout(ops)
    vd = None if lay == "packed" else spectral_vec_dtype(ops, cfg)
    tr = spectral.slab_transforms(ops, lay, vec_bf16=vd is not None)
    if counts_layout is None:
        counts_layout = counts_to_layout(ops, counts, cfg) or (counts,)
    r0 = _shard_residual(ops, counts, b, rho, x0, rhs_parts, kernel)
    return _spectral_cg_generic(
        r0, x0, to_b=lambda v: (v,), from_b=lambda t: t[0], fwd=tr.fwd, inv=tr.inv,
        eigs_blocks=tr.eigs, rho=rho, cbar=cbar, n_steps=n_fixed_steps(cfg),
        counts_b=counts_layout, vec_dtype=vd, gsum=lambda x: psum(x, ops.slab.group))


def _solve_tiled(ops: Operators, counts, cbar, b, rho, x0, cfg: SolverConfig, counts_blocked,
                 rhs_parts, kernel: bool = True):
    """The spectral-correction CG of the tiled (kernel: r0 from B9, B10 or
    B13) and spectral (r0 in plain PyTorch) routes (see module doc), and
    of the shard route across ranks (_solve_spectral_sharded)."""
    if ops.slab is not None:
        return _solve_spectral_sharded(ops, counts, cbar, b, rho, x0, cfg, counts_blocked,
                                       rhs_parts, kernel)
    n_steps = n_fixed_steps(cfg)
    lay = spectral_layout(ops)
    r0 = _initial_residual(ops, counts, b, rho, x0, lay, kernel, rhs_parts)
    if lay == "packed":
        return _spectral_cg_packed(ops, counts, r0, x0, rho, cbar, n_steps)
    if counts_blocked is None:
        counts_blocked = counts_to_layout(ops, counts, cfg)
    solve = _spectral_cg_quartered if lay == "quartered" else _spectral_cg_blocked
    return solve(ops, r0, x0, rho, cbar, n_steps, counts_blocked,
                 vec_dtype=spectral_vec_dtype(ops, cfg))


def whole_xupdate(ops: Operators, cfg: SolverConfig, one_kernel: bool = True) -> str:
    """The branch solve_x takes on the whole-lattice route: "direct"
    (dct_direct), "packed" (xupdate_pcg_2d_packed), "dense"
    (xupdate_pcg_2d), "fused" (gram_matvec_2d under the fused-dot PCG),
    "spectral" (the spectral-correction CG, plain r0), "natural" (the
    bf16 fixed-step PCG in the natural domain, spectral_cg=False) or "pcg"
    (the plain PCG; also xla_packed=False without dense matrices)."""
    if cfg.x_solver == "dct_direct":
        return "direct"
    if cfg.x_solver != "dct_pcg":
        return "pcg"
    if ops.dct_mats is not None:
        if not one_kernel:
            return "fused"
        return "packed" if ops.dct_halves_lp is not None else "dense"
    if not xla_packed_applies(ops, cfg):
        return "pcg"
    return "spectral" if cfg.spectral_cg else "natural"


def _solve_fused(ops: Operators, counts, cbar, b, rho, x0, cfg: SolverConfig):
    """The fused-dot PCG of the whole route past the one-kernel gate (JAX
    xupdate.py:413-437): n fixed steps with (A p, <p, A p>) from
    gram_matvec_2d and the dense DCT preconditioner, its products float32
    with TF32 off or, with precond_bf16, bf16 operands rounded to bf16 after
    every axis (dctn_mat on bf16 arrays in the JAX package)."""
    w = cbar + rho * ops.gram_eigs

    def matvec_dot(v):
        return kernels.gram_matvec_2d(v, counts, rho, ops.scales)

    if cfg.precond_bf16:
        mats = ops.dct_mats_lp

        def precond_dot(r):
            rhat = dct_ops.dctn_mat_lp(r.to(torch.bfloat16), mats).to(r.dtype)
            zhat = rhat / w
            return (dct_ops.idctn_mat_lp(zhat.to(torch.bfloat16), mats).to(r.dtype),
                    torch.sum(rhat * zhat))
    else:
        mats = ops.dct_mats

        def precond_dot(r):
            with dct_ops.exact_f32_matmul():
                rhat = dct_ops.dctn_mat(r, mats)
                zhat = rhat / w
                return dct_ops.idctn_mat(zhat, mats), torch.sum(rhat * zhat)

    res = pcg_fused(matvec_dot, precond_dot, b, x0, n_iters=n_fixed_steps(cfg))
    return res.x, res.iters


def _solve_natural(ops: Operators, counts, cbar, b, rho, x0, cfg: SolverConfig, tiled: bool):
    """SolverConfig(spectral_cg=False): n fixed PCG steps in the natural
    domain with the dots riding the operators (JAX xupdate.py:489-500):
    the preconditioner is the packed DCT solve of (mean(counts) I + rho
    D'D) on the bf16 folded halves (dctn_packed's rounding points are JAX's
    mat_dtype=bf16 ones), the vectors float32; the matvec is
    gram_matvec_tiled_2d (B10) on the 2-D tiled route, as the JAX package's
    tiled_ok makes it, and plain PyTorch elsewhere (tiled3 included).  On
    slabs the matvec is B9s's matvec mode (p = 2) or the slab matvec
    (p = 3) where the slab kernels run, plain PyTorch elsewhere; the
    preconditioner's packed transforms run across ranks
    (parallel/spectral.py) and every dot is summed over the row group."""
    halves = ops.dct_halves_lp
    w = cbar + rho * ops.gram_eigs_packed
    fwd, inv = (lambda v: dct_ops.dctn_packed(v, halves)), (
        lambda v: dct_ops.idctn_packed(v, halves))
    gsum = _identity
    if ops.slab is not None:
        from multivartv_tpu_torch.parallel import spectral
        from multivartv_tpu_torch.parallel.halo import psum
        tr = spectral.slab_transforms(ops, "packed")
        fwd, inv = (lambda v: tr.fwd((v,))[0]), (lambda v: tr.inv((v,))[0])

        def gsum(x):
            return psum(x, ops.slab.group)

        matvec = _shard_matvec(ops, counts, rho, tiled)
    elif tiled and len(ops.m) == 2:
        def matvec(v):
            return kernels.gram_matvec_tiled_2d(v, counts, rho, ops.scales)
    else:
        def matvec(v):
            return counts * v + rho * ops.apply_gram(v)

    def matvec_dot(v):
        av = matvec(v)
        return av, gsum(torch.sum(v * av))

    def precond_dot(r):
        rhat = fwd(r)
        zhat = rhat / w
        return inv(zhat), gsum(torch.sum(rhat * zhat))

    res = pcg_fused(matvec_dot, precond_dot, b, x0, n_iters=n_fixed_steps(cfg))
    return res.x, res.iters


def _identity(x):
    return x


def _shard_matvec(ops: Operators, counts, rho, kernel: bool):
    """(counts + rho D'D) v on slabs with v's halos: B9s's matvec mode
    (p = 2) or the slab matvec (gram_matvec_tiled_3d_shard, p = 3) where
    the slab kernels run (kernel), plain PyTorch elsewhere."""
    from multivartv_tpu_torch.parallel import tiled_shard
    slab = ops.slab
    if kernel:
        mv = (tiled_shard.gram_matvec_tiled_3d_sharded if len(ops.m) == 3
              else tiled_shard.gram_matvec_tiled_2d_sharded)
        return lambda v: mv(slab, v, counts, rho, ops.scales)
    return lambda v: counts * v + rho * ops.apply_gram(v)


def _solve_plain(ops: Operators, counts, cbar, b, rho, x0, cfg: SolverConfig, tiled: bool,
                 rhs_parts=None):
    """The plain PCG (JAX xupdate.py:502-527; see module doc).  On slabs
    (ops.slab, the shard route's exact arm) where the slab kernels run,
    its r0 = b - (counts + rho D'D) x0 is B9s given b (p = 2) or B13s with
    b formed from rhs_parts (p = 3, where the route passes them), its
    matvec B9s's matvec mode or the p = 3 slab matvec
    (gram_matvec_tiled_3d_shard), all with v's halos; elsewhere (p = 1,
    p >= 4, the reduced block set) r0 and the matvec are plain stencils on
    the slabs.  Every dot is a sum over the row group, and the DCT
    preconditioner runs through the pencil transpose
    (_sharded_dct_solve).  That is the JAX package's sharded x-update off
    the TPU (xupdate.py: 361-371, 502-527) and under xla_packed=False."""
    slab, r0, dots = ops.slab, None, _dots
    if slab is not None:
        from multivartv_tpu_torch.parallel.halo import psum

        matvec = _shard_matvec(ops, counts, rho, tiled)
        if tiled:
            r0 = _shard_residual(ops, counts, b, rho, x0,
                                 rhs_parts if len(ops.m) == 3 else None, kernel=True)

        def dots(pairs):
            return psum(_dots(pairs), slab.group)
    elif tiled and len(ops.m) == 2:
        def matvec(v):
            return kernels.gram_matvec_tiled_2d(v, counts, rho, ops.scales)
    else:
        def matvec(v):
            return counts * v + rho * ops.apply_gram(v)

    if cfg.x_solver == "dct_pcg":
        w, mats = cbar + rho * ops.gram_eigs, ops.dct_mats

        def precond(r):
            if slab is not None:
                return _sharded_dct_solve(ops, r, w)
            if mats is None:
                return dct_ops.idctn(dct_ops.dctn(r) / w)
            return dct_ops.idctn_mat(dct_ops.dctn_mat(r, mats) / w, mats)
    elif cfg.x_solver == "jacobi_pcg":
        inv_diag = 1.0 / (counts + rho * ops.gram_diagonal + 1e-30)

        def precond(r):
            return inv_diag * r
    else:
        precond = None

    with dct_ops.exact_f32_matmul():
        if cfg.cg_fixed_iters is not None:
            res = pcg_fixed(matvec, b, x0, precond=precond, n_iters=cfg.cg_fixed_iters, r0=r0,
                            dots=dots)
        else:
            res = pcg(matvec, b, x0, precond=precond, tol=cfg.cg_tol,
                      max_iters=cfg.cg_max_iters, r0=r0, dots=dots)
    return res.x, res.iters


def _mat_along(x: torch.Tensor, t: torch.Tensor, axis: int, inverse: bool) -> torch.Tensor:
    """The dense DCT matrix t (or, inverse, its transpose) applied along
    any axis of an array, as one matrix product on a view (no permuted
    copy): axis 0 on the (m0, rest) view, the last axis from the right,
    an inner axis batched over the axes before it on the (before, m_axis,
    after) view."""
    t = t.T if inverse else t
    if axis == 0:
        return (t @ x.reshape(x.shape[0], -1)).view(x.shape)
    if axis == x.ndim - 1:
        return x @ t.T
    lead = int(np.prod(x.shape[:axis], dtype=np.int64))
    return torch.matmul(t, x.reshape(lead, x.shape[axis], -1)).view(x.shape)


def _sharded_dct_solve(ops: Operators, r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """idctn(dctn(r) / w) on slabs: the transforms of axes 1 .. p-1 on
    this rank's slab, those of axis 0 and the division by w (the pencil of
    cbar + rho eigs) on its pencil, after the pencil transpose
    (parallel/halo.py); dense float32 matrices with TF32 off, or the FFT
    DCT above 2048 per axis, as the exact route's preconditioner.  At p = 1
    (no pencil) the chain is gathered and solved whole on every rank."""
    from multivartv_tpu_torch.parallel.halo import cols_to_rows, gather_rows, rows_to_cols
    slab = ops.slab
    if len(ops.m) == 1:
        whole = dct_ops.shifted_solve(gather_rows(r, slab), 0.0, 1.0, w, ops.dct_mats)
        return slab.rows(whole)
    with dct_ops.exact_f32_matmul():
        if ops.dct_mats is not None:
            if len(ops.m) == 2:
                t0, t1 = ops.dct_mats
                y = rows_to_cols(r @ t1.T, slab)
                z = t0.T @ ((t0 @ y) / w)
                return cols_to_rows(z, slab) @ t1
            mats = ops.dct_mats
            y = r
            for ax in range(1, len(ops.m)):
                y = _mat_along(y, mats[ax], ax, False)
            y = rows_to_cols(y, slab)
            z = _mat_along(_mat_along(y, mats[0], 0, False) / w, mats[0], 0, True)
            z = cols_to_rows(z, slab)
            for ax in range(1, len(ops.m)):
                z = _mat_along(z, mats[ax], ax, True)
            return z
        y = r
        for ax in range(1, len(ops.m)):
            y = dct_ops.dct_along(y, ax)
        y = rows_to_cols(y, slab)
        z = cols_to_rows(dct_ops.idct_along(dct_ops.dct_along(y, 0) / w, 0), slab)
        for ax in range(1, len(ops.m)):
            z = dct_ops.idct_along(z, ax)
        return z


def solve_x(ops: Operators, counts: torch.Tensor, cbar: torch.Tensor,
            b: Optional[torch.Tensor], rho: torch.Tensor, x0: torch.Tensor, cfg: SolverConfig,
            use_kernels: bool = False, tiled: bool = False, counts_blocked=None,
            rhs_parts=None, spectral: bool = False,
            one_kernel: bool = True) -> Tuple[torch.Tensor, int]:
    """Returns (theta, CG steps taken) (see module doc).  use_kernels: the
    whole-lattice route, or at p = 1 the "tridiag" route; one_kernel: its
    one-kernel gate passes; tiled: the large-lattice and shard routes, where
    rhs_parts = (oty, dta, u_scale, dtu) lets the residual kernel form b
    itself (b may then be None; every other branch forms b from them);
    spectral: the no-kernel spectral routes (b given); counts_blocked:
    counts in the spectral layout, converted once per solve by the caller.
    Operators cut to row slabs (ops.slab) take the arms on the slabs (see
    module doc)."""
    packed = xla_packed_applies(ops, cfg)
    spectral = spectral or ops.slab is not None
    if packed and cfg.spectral_cg and (tiled or spectral):
        return _solve_tiled(ops, counts, cbar, b, rho, x0, cfg, counts_blocked, rhs_parts,
                            kernel=tiled)
    if b is None:
        oty, dta, u_scale, dtu = rhs_parts
        b = oty + rho * (dta + u_scale * dtu)
    if cfg.x_solver == "dct_direct":
        if ops.slab is not None:
            return _sharded_dct_solve(ops, b, cbar + rho * ops.gram_eigs), 0
        return dct_ops.shifted_solve(b, cbar, rho, ops.gram_eigs, ops.dct_mats), 0
    if tridiag.tridiag_applies(ops, cfg):
        # p = 1: the system is tridiagonal, solved exactly by cyclic
        # reduction, no CG step (JAX xupdate.py:382-390); on a chain cut
        # into segments, the partition solve.
        if ops.slab is not None:
            return tridiag.partition_xupdate(counts, b, rho, ops.scales[0], ops.slab), 0
        solve = kernels.xupdate_tridiag if use_kernels else tridiag.xupdate_tridiag
        return solve(counts, b, rho, ops.scales[0]), 0
    kind = whole_xupdate(ops, cfg, one_kernel) if use_kernels else None
    if kind in ("packed", "dense"):
        n_steps = n_fixed_steps(cfg)
        if kind == "packed":
            x, rsq = kernels.xupdate_pcg_2d_packed(b, x0, counts, ops.dct_halves_lp,
                                                   ops.gram_eigs_packed, rho, cbar, ops.scales,
                                                   n_steps)
        else:
            x, rsq = kernels.xupdate_pcg_2d(b, x0, counts, ops.dct_mats_lp, ops.gram_eigs, rho,
                                            cbar, ops.scales, n_steps)
        return _poison_if_nonfinite(x, rsq), n_steps
    if kind == "fused":
        return _solve_fused(ops, counts, cbar, b, rho, x0, cfg)
    if kind == "spectral":
        return _solve_tiled(ops, counts, cbar, b, rho, x0, cfg, counts_blocked, None,
                            kernel=False)
    if kind == "natural" or (packed and (tiled or spectral)):
        return _solve_natural(ops, counts, cbar, b, rho, x0, cfg, tiled)
    return _solve_plain(ops, counts, cbar, b, rho, x0, cfg, tiled, rhs_parts=rhs_parts)
