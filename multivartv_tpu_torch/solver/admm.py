"""ADMM at one lambda, for one problem or a batch of B: the kernel routes
and the exact-f32 route.

Counterpart of ``multivartv_tpu/solver/admm.py`` (reference admm_update,
rcpp-code .../solvers.cpp:96-136): Boyd relative primal/dual stopping or
the reference Python prototype's max|theta - theta_old| <= tol
(``stop_rule="theta_inf"``, whose stop fields override the Boyd ones while
the Boyd norms still drive rho, JAX admm.py:399-410), adaptive rho (or a
fixed one) with the inverse dual rescale carried as ``u_scale`` and an
optional asymmetric shrink, an exact iteration cap, and the NaN fault
guard.

Routes (chosen from shapes and config, never from the device, so the CPU
tests walk the card's route; only each kernel wrapper looks at the device):

  * kernel route (``use_kernels=True``).  Under Boyd stopping with dct_pcg
    an odd lattice is padded to even axes (solver/pad.py), as the JAX
    package pads only those solves (admm.py:620-628); under the other
    knobs it is solved unpadded.  On p = 2 (the full 3-block set) the
    lattice's size picks one of the JAX package's two 2-D kernel families
    with the JAX package's own gates, evaluated as on a TPU with its 110 MB
    VMEM limit (``lattice_route``):
      - whole lattice, up to 2^20 knots, any axes: under Boyd with dct_pcg
        and the one-kernel gate (``xupdate_supported``: XUPDATE_MAX_KNOTS
        and the dense matrices' bytes) iterations run in chunks of
        AUTO_CHUNK through ``admm_iters_2d`` (``admm_fused_chunk``); the
        final < chunk iterations before the cap, ``chunk_iters=1`` and
        every other case run the per-iteration body: ``rhs_2d``, the
        x-update of ``xupdate.whole_xupdate`` (``xupdate_pcg_2d_packed``,
        ``xupdate_pcg_2d`` on an odd axis, ``gram_matvec_2d`` under the
        fused-dot PCG past the one-kernel gate, the spectral-correction CG
        with a plain r0 where no dense matrices exist, e.g. (4096, 256), or
        the plain PCG of the other x-solvers), then ``dual_update_2d``;
      - tiled, above 2^20 knots and up to 8192 per axis: one iteration at a
        time, whatever ``chunk_iters`` says (JAX runs no fused chunk
        there): the spectral-correction CG x-update with r0 from
        ``gram_residual_tiled_2d`` (or ``gram_matvec_tiled_2d`` in the
        packed layout), then ``dual_update_tiled_2d``, which carries
        dta = D'alpha and dtu = D'u to the next rhs and skips the alpha
        writes; alpha is refreshed once after the loop (``_refresh_alpha``);
        the x-solvers other than dct_pcg run the plain PCG with
        ``gram_matvec_tiled_2d`` as its matvec.
    With the reduced block set (the "python" profile) a 2-D lattice runs
    the "spectral2" route: the spectral-correction CG with a plain rhs,
    r0 and dual stage, no kernel, the JAX package's route on even axes.
    p = 3 (any block set, even axes; a lattice padded more than 4x runs the
    exact route, as in the JAX package) runs one iteration at a time on
    one of two routes (``lattice_route``), as the JAX package gates them
    (``tiled3_supported`` less its Mosaic alignment):
      - tiled3, the full 7-block set from TILED3_MIN_KNOTS = 2^22 knots: the
        spectral-correction CG with r0 from ``gram_residual_tiled_3d``,
        then ``dual_update_tiled_3d`` with the dta/dtu carries and the alpha
        stores skipped, alpha refreshed after the loop, as on the 2-D tiled
        route;
      - spectral3, below it: the same CG with a plain rhs, a plain r0 and a
        plain dual stage, no kernel (JAX xupdate.py:439-487).
    p >= 4 with even axes runs the no-kernel "spectralN" route, spectral3's
    iteration on the p-generic packed or blocked DCT (JAX's XLA route; JAX
    pads only p = 2 and 3, admm.py:611).  Above 8192 per axis no folded
    halves exist: the tiled, tiled3 and spectral routes keep their rhs and
    dual stages and take the plain PCG with the FFT DCT preconditioner as
    their x-update (JAX xupdate.py:502-527).
    An odd lattice that is not padded has no kernel route above 2^20 knots
    or on p >= 3 (no folded halves): it runs the exact route, the JAX
    package's plain fallthrough (xupdate.py:502-527).  With
    ``bf16_residual_escape`` a stalled bf16 solve (Boyd, dct_pcg) finishes
    on the exact route within the same cap, where the dense DCT matrices
    exist (up to 2048 per axis) and the x-update runs bf16 transforms
    (``_bf16_escape_applies``).  ``SolverConfig.xla_packed`` and
    ``spectral_cg`` pick the x-update of the routes that run the folded
    bf16 DCT (solver/xupdate.py): the spectral CG (both True), the
    natural-domain bf16 PCG (spectral_cg=False) or the exact float32 PCG
    (xla_packed=False, no escape there), with every stage around it on the
    route's kernels; the whole route's B3-B7 do not read them, as in the
    JAX package.  p = 1 with dct_pcg runs the "tridiag"
    route: a plain rhs and dual stage around the exact tridiagonal
    x-update ``xupdate_tridiag`` (T1), no escape (the x-update is exact
    float32, as the JAX package's cyclic reduction).
  * exact route (``use_kernels=False``): per-iteration plain PyTorch with
    the tolerance-driven float32 PCG (or the configured x-solver), the
    explicit comparison arm.
  * shard route: operators cut to slabs along axis 0 over a row group
    (parallel/fit.py::shard_operators, ``SolverConfig.tiled_shard_key``;
    the JAX package's ``_tiled_shard_active``, admm.py:158-171, at p = 2,
    its SPMD route elsewhere), any p and either block set: one iteration
    at a time.  At p = 2 and 3 with the full block set (the slab kernels,
    parallel/tiled_shard.py::shard_supported) the sharded x-update
    (xupdate.py: the spectral CG across ranks, or the arm SolverConfig
    picks; B9s's or B13s's r0), then ``dual_update_tiled_2d_shard`` (B8s)
    or ``dual_update_tiled_3d_shard`` (B12s) with the dta/dtu carries and
    the alpha stores skipped, alpha refreshed after the loop, as on the
    tiled routes; at p >= 4 and with the reduced block set a plain rhs and
    dual stage on the slabs (halo rows or planes; the Boyd sums in one call)
    around the same x-update arms, r0 in plain PyTorch; at p = 1 the plain
    stages with the halo knot around the partition solve
    (solver/tridiag.py::partition_xupdate, T1 on each segment), as the
    "tridiag" route's.  Every lattice sum runs over the row group; no
    padding; the bf16 escape as on the kernel routes (its exact tail the
    shard route's xla_packed=False arm).

Batched solves (``admm_solve_batched``: the CV folds and lambda sweeps) run
B problems at once through ``admm_iters_2d_batched`` (B5) on the kernel
route, with the semantics of ``jax.vmap(admm_solve)``: each element freezes
when its own predicate clears, the cap is exact per element, and there is
no bf16 escape (the JAX package arms it for unbatched solves only).  On
the exact route, and under a stop rule other than Boyd or an x-solver other
than dct_pcg (which the JAX package's B5 gate declines too), each element
runs ``admm_solve`` on the exact route in turn, escape off.  On the other
kernel routes (tiled above 2^20 knots, tiled3, spectral2, spectral3,
spectralN, and at p = 1 tridiag under any stop rule) each element runs
``admm_solve`` in turn on that single-problem route, escape off:
jax.vmap(admm_solve(batched=True)) element by element; the fold axis
through B8/B9, B12/B13 and T1 is a speed item (ROADMAP A13).  Operators
cut to row slabs raise NotImplementedError (mvtv_sharded runs its folds
one after another).

The JAX while loops are Python loops that read one host value per trip
(the loop predicate); nothing inside a chunk reads the device.  The
iteration and CG-step counters of a single solve are host integers; those
of a batched solve are (B,) int64 tensors on the device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from multivartv_tpu_torch.config import SolverConfig
from multivartv_tpu_torch.ops import diff as diff_ops
from multivartv_tpu_torch.ops import kernels
from multivartv_tpu_torch.ops.prox import soft_threshold_blocks
from multivartv_tpu_torch.solver import pad as pad_lib
from multivartv_tpu_torch.solver import tridiag
from multivartv_tpu_torch.solver.problem import Operators, Problem, problem_at
from multivartv_tpu_torch.solver.xupdate import (counts_to_layout, n_fixed_steps, solve_x,
                                                 whole_xupdate, xla_packed_applies)

# Convergence-check cadence of the kernel chain when chunk_iters is None.
AUTO_CHUNK = 4
# The JAX package's 2-D route gates, as on a TPU with the 110 MB VMEM limit:
# the whole-lattice kernels up to 4 MB of float32 lattice
# (pallas_kernels.py:602-607), their one-kernel x-update (and the fused
# chunks) up to XUPDATE_MAX_KNOTS while the DCT matrices 2 (m0^2 + m1^2)
# take at most 16 MB (:540-553), the tiled kernels above (the spectral CG
# where the folded DCT halves exist, up to 8192 per axis, solver/problem.py;
# the plain PCG beyond).  XUPDATE_MAX_KNOTS
# is the JAX value at 110 MB (4 MB lattices); at the 96 MB that
# _vmem_limit_bytes grants other TPU kinds it is 1 << 18 (1 MB lattices),
# and lattices between the two run gram_matvec_2d's route.  Tests and
# chip_smoke.py may lower them.
WHOLE_MAX_KNOTS = 1 << 20
XUPDATE_MAX_KNOTS = 1 << 20
WHOLE_MAX_MAT_BYTES = 16 << 20
# The 3-D tiled kernels' gate (pallas_kernels.py:1935); tests lower it.
TILED3_MIN_KNOTS = 1 << 22
# bf16 residual-floor escape: stop the bf16 loop after this many iterations
# without a >= 1% improvement of max(primal/eps_primal, dual/eps_dual).
ESCAPE_STALL_ITERS = 200
ESCAPE_IMPROVEMENT = 0.99


# The routes whose dual kernel writes the dta/dtu carries and skips alpha
# (the shard route at p >= 2, _carries), and the routes of the
# spectral-correction CG.
CARRY_ROUTES = ("tiled", "tiled3", "shard")
PLAIN_SPECTRAL_ROUTES = ("spectral2", "spectral3", "spectralN")
SPECTRAL_ROUTES = ("tiled", "tiled3") + PLAIN_SPECTRAL_ROUTES


def resolve_chunk(cfg: SolverConfig) -> int:
    return AUTO_CHUNK if cfg.chunk_iters is None else max(cfg.chunk_iters, 1)


@dataclasses.dataclass(frozen=True)
class ADMMState:
    """The effective dual variable is u_scale * u.  counter, cg_iters and
    the route counts at the end are host values; every other field is a
    tensor on the solve's device.  Of the counter's iterations,
    chunked_iters ran in admm_iters_2d chunks and exact_iters on the
    exact-f32 route; the rest ran the per-iteration kernels.  escaped: the
    bf16 loop stopped on a stall and the exact route took over.  A batched
    state carries a leading axis B on every tensor, and its counts are
    (B,) int64 tensors (bool for escaped) on the device."""

    theta: torch.Tensor
    alpha: Tuple[torch.Tensor, ...]
    u: Tuple[torch.Tensor, ...]
    rho: torch.Tensor
    counter: int
    primal_norm: torch.Tensor
    dual_norm: torch.Tensor
    eps_primal: torch.Tensor
    eps_dual: torch.Tensor
    cg_iters: int
    u_scale: torch.Tensor
    chunked_iters: int = 0
    exact_iters: int = 0
    escaped: bool = False
    # The tiled route's adjoint carries dta = D'alpha and dtu = D'u (JAX
    # admm.py:69-76): written by dual_update_tiled_2d, read by the next
    # rhs; None on every other route and after padding or cropping.
    dta: Optional[torch.Tensor] = None
    dtu: Optional[torch.Tensor] = None


def initial_state(ops: Operators, problem: Problem, rho0, u_fill=None) -> ADMMState:
    """theta = mean(y), u = 0, alpha = D theta (solvers.cpp:101,207-209).
    u_fill: fill u with this constant instead (the reference Python
    prototype's u0 = 1/lambda, code/solvers.py:62), on each block's valid
    region only, which keeps its trailing edges zero."""
    dev, dtype = problem.oty.device, problem.oty.dtype
    theta0 = problem.ybar.expand(ops.local_m).contiguous()
    one = torch.ones((), dtype=dtype, device=dev)
    u0 = diff_ops.zeros_like_blocks(ops.local_m, ops.binaries, dtype, dev)
    if u_fill is not None:
        fill = torch.as_tensor(u_fill, dtype=dtype, device=dev)
        masks = [diff_ops.edge_mask(ops.m, b, dtype, dev) for b in ops.binaries]
        if ops.slab is not None:
            masks = [ops.slab.rows(w) for w in masks]
        u0 = tuple(z + fill * w for z, w in zip(u0, masks))
    return ADMMState(
        theta=theta0,
        alpha=ops.apply_D(theta0),
        u=u0,
        rho=torch.as_tensor(rho0, dtype=dtype, device=dev).reshape(()),
        counter=0,
        primal_norm=one,
        dual_norm=one,
        eps_primal=one * 0.0,
        eps_dual=one * 0.0,
        cg_iters=0,
        u_scale=one,
    )


def lattice_route(m, full_set: bool = True) -> Optional[str]:
    """The route of a solve on lattice m (the padded one where the solve
    pads) by the JAX package's gates (see WHOLE_MAX_KNOTS and
    TILED3_MIN_KNOTS): "whole" (2-D up to 2^20 knots, any axes), "tiled"
    (2-D above), "spectral2" (2-D, reduced block set), "tiled3" or
    "spectral3" (3-D; the tiled3 kernels need the full 7-block set),
    "spectralN" (p >= 4, no kernel), or None where an odd axis leaves the
    spectral-CG routes without folded halves (the exact route, JAX's plain
    fallthrough).  Above 8192 per axis there are no folded halves either
    (JAX problem.py:168): the route keeps its dual stage (B8 or B12
    with the carries) and its x-update is the plain PCG with the FFT DCT
    preconditioner (xupdate.solve_x; JAX xupdate.py:502-527)."""
    m = tuple(int(v) for v in m)
    if len(m) == 2 and full_set and m[0] * m[1] <= WHOLE_MAX_KNOTS:
        return "whole"
    if any(v % 2 for v in m):
        return None
    if len(m) > 3:
        return "spectralN"
    if len(m) == 3:
        return "tiled3" if full_set and int(np.prod(m)) >= TILED3_MIN_KNOTS else "spectral3"
    return "tiled" if full_set else "spectral2"


def xupdate_supported(m) -> bool:
    """The one-kernel x-update's gate (pallas_kernels.py:540-553): at most
    XUPDATE_MAX_KNOTS knots and WHOLE_MAX_MAT_BYTES of dense DCT matrices."""
    m0, m1 = (int(v) for v in m)
    return m0 * m1 <= XUPDATE_MAX_KNOTS and 2 * (m0 * m0 + m1 * m1) <= WHOLE_MAX_MAT_BYTES


def _full_set(ops: Operators) -> bool:
    return len(ops.binaries) == 2 ** len(ops.m) - 1


def _boyd_dct(cfg: SolverConfig) -> bool:
    """The knobs of the JAX package's padded solves, fused chunks, bf16
    escape and batched kernel (admm.py:454, 546, 620-628, 768-775)."""
    return cfg.stop_rule == "boyd" and cfg.x_solver == "dct_pcg"


def pad_single_applies(ops: Operators, cfg: SolverConfig) -> bool:
    """Whether the solve pads an odd lattice to even axes: on the kernel
    route under Boyd stopping with dct_pcg, unless the padded lattice
    exceeds 4x the true one (the JAX package's gates, admm.py:613-628)."""
    return (cfg.use_kernels and _boyd_dct(cfg) and len(ops.m) in (2, 3)
            and ops.slab is None and pad_lib.pad_applies(ops.m))


def solve_route(ops: Operators, cfg: SolverConfig) -> Optional[str]:
    """The route of a solve on the lattice of ops (after padding): None
    (the exact-f32 route), "tridiag" (p = 1 under dct_pcg: T1), "whole",
    "tiled", "spectral2", "tiled3", "spectral3" or "spectralN"
    (lattice_route), or "shard" for operators cut to slabs (a sharded fit
    at any p, whatever use_kernels says: the slabs have no other route)."""
    if ops.slab is not None:
        from multivartv_tpu_torch.parallel import tiled_shard
        key = cfg.tiled_shard_key
        if key not in tiled_shard._REGISTRY:
            raise ValueError(f"operators cut to row slabs need a SolverConfig whose "
                             f"tiled_shard_key registers their row group (got {key}); "
                             "parallel.fit.mvtv_sharded sets it")
        if tiled_shard.get_shard_ctx(key)[0] != ops.slab.group:
            raise ValueError("the operators' row group is not tiled_shard_key's")
        return "shard"
    if not cfg.use_kernels:
        return None
    if len(ops.m) == 1:
        return "tridiag" if tridiag.tridiag_applies(ops, cfg) else None
    m = pad_lib.pad_target_m(ops.m) if pad_single_applies(ops, cfg) else ops.m
    return lattice_route(m, _full_set(ops))


def kernel_route(ops: Operators, cfg: SolverConfig) -> bool:
    """Whether the solve runs a kernel route, the routes of the JAX
    package's Pallas and bf16-transform solves (see module doc)."""
    return solve_route(ops, cfg) is not None


def fused_chunks(ops: Operators, cfg: SolverConfig) -> bool:
    """Whether a solve on ops (after padding) runs admm_iters_2d chunks:
    the whole route under Boyd with dct_pcg, folded halves and the
    one-kernel gate (JAX fused_iterations_available, admm.py:445-460)."""
    return (solve_route(ops, cfg) == "whole" and _boyd_dct(cfg)
            and ops.dct_halves_lp is not None and xupdate_supported(ops.m))


def _carries(ops: Operators, cfg: SolverConfig, route: Optional[str]) -> bool:
    """Whether a route's dual kernel carries dta/dtu: the tiled routes, and
    the shard route where its slab kernels run (tiled_shard.shard_supported
    at p = 2 and 3; elsewhere its stages are plain)."""
    if route == "shard":
        from multivartv_tpu_torch.parallel import tiled_shard
        return len(ops.m) > 1 and tiled_shard.shard_supported(ops.m, ops.binaries,
                                                              cfg.tiled_shard_key)
    return route in CARRY_ROUTES


def tiled_route(ops: Operators, cfg: SolverConfig) -> bool:
    """Whether the solve runs the tiled kernels (2-D above 2^20 knots, 3-D
    from TILED3_MIN_KNOTS, the slab kernels): the routes with the dta/dtu
    carries."""
    return _carries(ops, cfg, solve_route(ops, cfg))


def _seed_adjoints(ops: Operators, state: ADMMState) -> ADMMState:
    """The carries dta = D'alpha, dtu = D'u before a tiled loop (one plain
    adjoint pass each); a state that has them keeps them (JAX
    admm.py:174-187)."""
    if state.dta is not None and state.dtu is not None:
        return state
    return dataclasses.replace(state, dta=ops.apply_Dt(state.alpha),
                               dtu=ops.apply_Dt(state.u))


def _refresh_alpha(ops: Operators, state: ADMMState, lam) -> ADMMState:
    """alpha = soft(D theta - u_scale u, lam / rho), the exact prox of the
    final state, after a loop whose dual kernel skipped the alpha writes
    (JAX admm.py:199-214); once per solve, on the true lattice."""
    d_theta = ops.apply_D(state.theta)
    kap = torch.as_tensor(lam, dtype=state.theta.dtype, device=state.theta.device) / state.rho
    alpha = soft_threshold_blocks(
        tuple(dt - state.u_scale * w for dt, w in zip(d_theta, state.u)), kap)
    return dataclasses.replace(state, alpha=alpha)


def _true_masks(ops: Operators, true_m, dtype, device):
    if true_m is None or tuple(true_m) == tuple(ops.m):
        return None
    return tuple(diff_ops.true_region_mask(ops.m, b, true_m, dtype, device)
                 for b in ops.binaries)


def make_admm_iteration(ops: Operators, problem: Problem, lam: torch.Tensor,
                        cfg: SolverConfig, stop_ntheta: Optional[int] = None,
                        stop_rows: Optional[int] = None, true_m=None):
    """The single-iteration ADMM update.  stop_ntheta/stop_rows: the TRUE
    lattice sizes of a padded solve (Boyd constants); true_m: the TRUE dims,
    which mask the TV penalty to the true rows at the prox.  On the tiled
    and shard routes the state must carry dta/dtu (_seed_adjoints); on the
    exact route a state that carries them (the escape's tail after a tiled
    loop) forms its first rhs from them, since its alpha is stale there.
    On the shard route every lattice is this rank's row slab and every sum
    runs over the row group (parallel/halo.py), so that each rank reads the
    same norms and takes the same branches."""
    route = solve_route(ops, cfg)
    tiled = _carries(ops, cfg, route)
    kernel_stats = route == "whole" or tiled
    one_kernel = route == "whole" and xupdate_supported(ops.m)
    # counts in the spectral CG's layout, only where that CG runs (JAX
    # admm.py:279-282).
    spectral_cg = (
        (route in SPECTRAL_ROUTES + ("shard",) and cfg.spectral_cg
         and xla_packed_applies(ops, cfg))
        or (route == "whole" and whole_xupdate(ops, cfg, one_kernel) == "spectral"))
    counts_blocked = counts_to_layout(ops, problem.counts, cfg) if spectral_cg else None
    dtype = problem.oty.dtype
    sqrt_ntheta = math.sqrt(stop_ntheta if stop_ntheta is not None else ops.ntheta)
    sqrt_rowsd = math.sqrt(stop_rows if stop_rows is not None else ops.rows_d)
    tol = cfg.tol
    cbar = ops.total(problem.counts) / ops.ntheta
    wmasks = _true_masks(ops, true_m, dtype, problem.oty.device)
    kern_tm = tuple(true_m) if wmasks is not None else None
    def body(s: ADMMState) -> ADMMState:
        dta = dtu = None
        if tiled:
            # Under the spectral CG b is never formed: the residual kernel
            # assembles it from the carries (JAX admm.py:303-316, 334-345);
            # the other x-updates form it from them.
            theta, cg_it = solve_x(ops, problem.counts, cbar, None, s.rho, s.theta, cfg,
                                   tiled=True, counts_blocked=counts_blocked,
                                   rhs_parts=(problem.oty, s.dta, s.u_scale, s.dtu))
            if route == "shard":
                from multivartv_tpu_torch.parallel import tiled_shard
                dual = functools.partial(tiled_shard.dual_update_tiled_3d_sharded
                                         if len(ops.m) == 3 else
                                         tiled_shard.dual_update_tiled_2d_sharded, ops.slab)
            else:
                dual = (kernels.dual_update_tiled_3d if route == "tiled3"
                        else kernels.dual_update_tiled_2d)
            _, u, stats, dta, dtu = dual(theta, s.u, lam / s.rho, ops.scales, u_scale=s.u_scale,
                                         true_m=kern_tm, want_adjoints=True, want_alpha=False)
            alpha = s.alpha
        else:
            if route == "whole":
                b = kernels.rhs_2d(s.alpha, s.u, problem.oty, s.rho, s.u_scale, ops.scales)
            elif s.dta is not None:
                b = problem.oty + s.rho * (s.dta + s.u_scale * s.dtu)
            else:
                au = tuple(a + s.u_scale * w for a, w in zip(s.alpha, s.u))
                b = problem.oty + s.rho * ops.apply_Dt(au)
            theta, cg_it = solve_x(ops, problem.counts, cbar, b, s.rho, s.theta, cfg,
                                   use_kernels=route in ("whole", "tridiag"),
                                   spectral=route in PLAIN_SPECTRAL_ROUTES,
                                   counts_blocked=counts_blocked, one_kernel=one_kernel)
        if kernel_stats:
            if not tiled:
                alpha, u, stats = kernels.dual_update_2d(theta, s.u, lam / s.rho, ops.scales,
                                                         u_scale=s.u_scale, true_m=kern_tm)
            primal_norm = torch.sqrt(stats[0])
            d_theta_norm = torch.sqrt(stats[1])
            alpha_norm = torch.sqrt(stats[2])
            dual_norm = s.rho * torch.sqrt(stats[3])
            dtu_norm = torch.sqrt(stats[4])
        else:
            d_theta = ops.apply_D(theta)
            u_eff = tuple(s.u_scale * w for w in s.u)
            z = tuple(dt - w for dt, w in zip(d_theta, u_eff))
            kap = lam / s.rho
            if wmasks is None:
                alpha = soft_threshold_blocks(z, kap)
            else:
                alpha = tuple(torch.sign(zz) * torch.clamp_min(torch.abs(zz) - kap * wm, 0.0)
                              for zz, wm in zip(z, wmasks))
            primal_res = tuple(a - dt for a, dt in zip(alpha, d_theta))
            u = tuple(w + r for w, r in zip(u_eff, primal_res))
            dual_res = s.rho * ops.apply_Dt(primal_res)
            if wmasks is not None:
                d_theta = tuple(dt * wm for dt, wm in zip(d_theta, wmasks))
                alpha_w = tuple(a * wm for a, wm in zip(alpha, wmasks))
            else:
                alpha_w = alpha
            # The five Boyd sums, over the row group in one call on slabs.
            sums = (diff_ops.blocks_norm_sq(primal_res), torch.sum(torch.square(dual_res)),
                    torch.sum(torch.square(ops.apply_Dt(u))), diff_ops.blocks_norm_sq(d_theta),
                    diff_ops.blocks_norm_sq(alpha_w))
            if ops.slab is not None:
                from multivartv_tpu_torch.parallel.halo import psum
                sums = tuple(psum(torch.stack(sums), ops.slab.group))
            primal_norm, dual_norm, dtu_norm, d_theta_norm, alpha_norm = (
                torch.sqrt(v) for v in sums)
        eps_dual = tol * (sqrt_ntheta + dtu_norm)
        eps_primal = tol * (sqrt_rowsd + torch.maximum(d_theta_norm, alpha_norm))
        rho, new_scale = kernels.adapt_rho(s.rho, primal_norm, dual_norm, cfg.adapt_tau,
                                           cfg.adapt_band, cfg.adapt_rho, cfg.adapt_tau_shrink)
        if cfg.stop_rule == "theta_inf":
            # max|theta - theta_old| <= tol stops the loop; the dual test is
            # off (JAX admm.py:399-410).
            primal_norm = torch.max(torch.abs(theta - s.theta))
            if ops.slab is not None:
                from multivartv_tpu_torch.parallel.halo import pmax
                primal_norm = pmax(primal_norm, ops.slab.group)
            eps_primal = torch.full_like(primal_norm, tol)
            dual_norm = torch.zeros_like(primal_norm)
            eps_dual = torch.ones_like(primal_norm)
        return dataclasses.replace(
            s, theta=theta, alpha=alpha, u=u, rho=rho, counter=s.counter + 1,
            primal_norm=primal_norm, dual_norm=dual_norm, eps_primal=eps_primal,
            eps_dual=eps_dual, cg_iters=s.cg_iters + cg_it, u_scale=new_scale,
            exact_iters=s.exact_iters + (0 if route else 1), dta=dta, dtu=dtu)

    return body


def admm_fused_chunk(ops: Operators, problem: Problem, lam: torch.Tensor,
                     state: ADMMState, cfg: SolverConfig, k_iters: int,
                     stop_ntheta: Optional[int] = None, stop_rows: Optional[int] = None,
                     true_m=None, scratch: Optional[dict] = None) -> ADMMState:
    """k_iters full ADMM iterations through ``admm_iters_2d``; the same
    math, iteration for iteration, as make_admm_iteration's kernel route.
    scratch: the solve's chain buffers (kernels.admm_iters_2d)."""
    sqrt_ntheta = math.sqrt(stop_ntheta if stop_ntheta is not None else ops.ntheta)
    sqrt_rowsd = math.sqrt(stop_rows if stop_rows is not None else ops.rows_d)
    cbar = torch.sum(problem.counts) / ops.ntheta
    n_steps = n_fixed_steps(cfg)
    kern_tm = (tuple(true_m) if true_m is not None and tuple(true_m) != tuple(ops.m)
               else None)
    theta, u, alpha, rho, u_scale, stats = kernels.admm_iters_2d(
        state.theta, state.u, state.alpha, problem.counts, problem.oty, ops.dct_halves_lp,
        ops.gram_eigs_packed, lam, state.rho, state.u_scale, cbar, ops.scales,
        k_iters=k_iters, n_steps=n_steps, tau=cfg.adapt_tau, band=cfg.adapt_band,
        true_m=kern_tm, adapt=cfg.adapt_rho, tau_shrink=cfg.adapt_tau_shrink, scratch=scratch)
    primal_norm = torch.sqrt(stats[0])
    # The last iteration's dual norm used its pre-adaptation rho: with
    # factor = 1/u_scale, that rho is rho_out * u_scale.
    rho_pre = rho * u_scale
    dual_norm = rho_pre * torch.sqrt(stats[3])
    eps_primal = cfg.tol * (sqrt_rowsd + torch.maximum(torch.sqrt(stats[1]),
                                                       torch.sqrt(stats[2])))
    eps_dual = cfg.tol * (sqrt_ntheta + torch.sqrt(stats[4]))
    # NaN poison: a non-finite CG residual poisons the norms (the loop
    # predicate stops) and theta itself.
    bad = ~torch.isfinite(stats[5])
    primal_norm = torch.where(bad, torch.full_like(primal_norm, float("nan")), primal_norm)
    theta = torch.where(bad, torch.full_like(theta, float("nan")), theta)
    return dataclasses.replace(
        state, theta=theta, alpha=alpha, u=u, rho=rho, counter=state.counter + k_iters,
        primal_norm=primal_norm, dual_norm=dual_norm, eps_primal=eps_primal,
        eps_dual=eps_dual, cg_iters=state.cg_iters + n_steps * k_iters, u_scale=u_scale,
        chunked_iters=state.chunked_iters + k_iters)


def _bf16_escape_applies(ops: Operators, cfg: SolverConfig, route: Optional[str]) -> bool:
    """Whether a single solve arms the bf16 escape (JAX admm.py:537-555):
    Boyd with dct_pcg on a kernel route or the shard route where the dense
    float32 DCT matrices exist (up to 2048 per axis) and the x-update runs
    bf16 transforms: the folded bf16 DCT (xla_packed_applies; not under
    xla_packed=False) or the whole route's one-kernel x-update.  The
    escape's tail runs the exact float32 PCG (xla_packed=False): the exact
    route, or on slabs the shard route's exact arm."""
    if not (route not in (None, "tridiag") and cfg.bf16_residual_escape
            and _boyd_dct(cfg) and ops.dct_mats is not None):
        return False
    return xla_packed_applies(ops, cfg) or (route == "whole" and xupdate_supported(ops.m))


def _not_converged_dev(s: ADMMState) -> torch.Tensor:
    """Device part of the loop predicate: not yet Boyd-converged and
    finite (a NaN/Inf residual stops the solve; see solver_diagnostics)."""
    not_done = (s.dual_norm > s.eps_dual) | (s.primal_norm > s.eps_primal)
    return not_done & torch.isfinite(s.primal_norm) & torch.isfinite(s.dual_norm)


def _not_converged(s: ADMMState, max_iters: int) -> bool:
    """The while-loop predicate: one host read (none once at the cap)."""
    return s.counter < max_iters and bool(_not_converged_dev(s))


def _while(cond, body, state: ADMMState) -> ADMMState:
    while cond(state):
        state = body(state)
    return state


def _stalled_while(max_iters: int, body, state: ADMMState, step: int) -> ADMMState:
    """The loop of ``_not_converged(s, max_iters)`` that also stops after
    ESCAPE_STALL_ITERS iterations without a >= 1% improvement of the worst
    residual ratio; step = iterations per body call.  The stall counter
    stays on the device and joins the one host read per trip; one more
    read at the end records whether the stall ended the loop."""
    best = torch.full_like(state.rho, float("inf"))
    since = torch.zeros((), dtype=torch.int64, device=state.rho.device)
    while state.counter < max_iters and bool(_not_converged_dev(state)
                                             & (since < ESCAPE_STALL_ITERS)):
        state = body(state)
        ratio = torch.maximum(
            state.primal_norm / torch.clamp_min(state.eps_primal, 1e-30),
            state.dual_norm / torch.clamp_min(state.eps_dual, 1e-30))
        improved = ratio < ESCAPE_IMPROVEMENT * best
        best = torch.minimum(best, ratio)
        since = torch.where(improved, torch.zeros_like(since), since + step)
    stalled = state.counter < max_iters and bool(_not_converged_dev(state)
                                                 & (since >= ESCAPE_STALL_ITERS))
    return dataclasses.replace(state, escaped=stalled)


def _pad_for_single(ops: Operators, problem: Problem, state: ADMMState,
                    cfg: SolverConfig):
    """(ops', problem', state', crop, (stop_ntheta, stop_rows, true_m)):
    the identity unless the solve pads.  The Boyd constants and the masks
    use the TRUE sizes."""
    if not pad_single_applies(ops, cfg):
        return ops, problem, state, (lambda s: s), (None, None, None)
    return _padded(ops, problem, state)


def _padded(ops: Operators, problem: Problem, state: ADMMState):
    ops_p = ops.padded
    problem_p = pad_lib.pad_problem(problem, ops.m, ops_p.m)
    state_p = pad_lib.pad_state(state, ops.m, ops_p.m)
    crop = functools.partial(pad_lib.crop_state, ops=ops)
    return ops_p, problem_p, state_p, crop, (ops.ntheta, ops.rows_d, ops.m)


def _tiled_setup(ops_true: Operators, ops: Operators, state: ADMMState, crop, lam):
    """(state, crop) of a tiled loop: carries seeded, alpha refreshed after
    the crop."""
    return _seed_adjoints(ops, state), lambda s: _refresh_alpha(ops_true, crop(s), lam)


def admm_solve(ops: Operators, problem: Problem, lam: torch.Tensor, state: ADMMState,
               cfg: SolverConfig) -> ADMMState:
    """Run ADMM at one lambda until the stop rule holds or the cap.  Where
    the fused chunks run (fused_chunks) iterations run in chunks with
    convergence checked every chunk (overshooting convergence by at most
    chunk-1 iterations, never the cap); the final < chunk iterations before
    the cap run one at a time.  Every other route checks every iteration."""
    chunk = resolve_chunk(cfg)
    ops_true = ops
    ops, problem, state, crop, (s_nt, s_rd, t_m) = _pad_for_single(ops, problem, state, cfg)
    route = solve_route(ops, cfg)
    if _carries(ops, cfg, route):
        state, crop = _tiled_setup(ops_true, ops, state, crop, lam)
    per_iter_body = make_admm_iteration(ops, problem, lam, cfg, stop_ntheta=s_nt,
                                        stop_rows=s_rd, true_m=t_m)

    def tail_cond(s):
        return _not_converged(s, cfg.max_iters)

    escape = _bf16_escape_applies(ops, cfg, route)
    if escape:
        f32_cfg = dataclasses.replace(cfg, use_kernels=False, xla_packed=False, chunk_iters=1)
        tail_body = make_admm_iteration(ops, problem, lam, f32_cfg, stop_ntheta=s_nt,
                                        stop_rows=s_rd, true_m=t_m)
    else:
        tail_body = per_iter_body

    if chunk > 1 and fused_chunks(ops, cfg):
        scratch = {}

        def chunk_body(s):
            return admm_fused_chunk(ops, problem, lam, s, cfg, chunk, stop_ntheta=s_nt,
                                    stop_rows=s_rd, true_m=t_m, scratch=scratch)

        # Only take a full chunk when it cannot overshoot the cap.
        chunk_cap = cfg.max_iters - chunk + 1
        if escape:
            state = _stalled_while(chunk_cap, chunk_body, state, chunk)
        else:
            state = _while(lambda s: _not_converged(s, chunk_cap), chunk_body, state)
        return crop(_while(tail_cond, tail_body, state))
    if escape:
        state = _stalled_while(cfg.max_iters, per_iter_body, state, 1)
        return crop(_while(tail_cond, tail_body, state))
    return crop(_while(tail_cond, per_iter_body, state))


def admm_fixed_iterations(ops: Operators, problem: Problem, lam: torch.Tensor,
                          state: ADMMState, cfg: SolverConfig, n_iters: int) -> ADMMState:
    """Exactly n_iters iterations (benchmarking), in chunks of the same
    cadence admm_solve uses where the fused chunks run; every other route
    runs one iteration at a time.  Reads nothing from the device inside
    the loop."""
    ops_true = ops
    ops, problem, state, crop, (s_nt, s_rd, t_m) = _pad_for_single(ops, problem, state, cfg)
    route = solve_route(ops, cfg)
    if _carries(ops, cfg, route):
        state, crop = _tiled_setup(ops_true, ops, state, crop, lam)
    elif fused_chunks(ops, cfg):
        chunk = min(resolve_chunk(cfg), n_iters)
        full, rem = divmod(n_iters, chunk)
        scratch = {}
        for k in [chunk] * full + ([rem] if rem else []):
            state = admm_fused_chunk(ops, problem, lam, state, cfg, k, stop_ntheta=s_nt,
                                     stop_rows=s_rd, true_m=t_m, scratch=scratch)
        return crop(state)
    body = make_admm_iteration(ops, problem, lam, cfg, stop_ntheta=s_nt, stop_rows=s_rd,
                               true_m=t_m)
    for _ in range(n_iters):
        state = body(state)
    return crop(state)


def solver_diagnostics(state: ADMMState) -> dict:
    """Host-side health and convergence report for a finished solve."""
    pn = float(state.primal_norm)
    dn = float(state.dual_norm)
    finite = bool(np.isfinite(pn) and np.isfinite(dn)
                  and np.isfinite(float(torch.sum(state.theta))))
    return {
        "iterations": int(state.counter),
        "cg_iterations": int(state.cg_iters),
        "primal_norm": pn,
        "dual_norm": dn,
        "eps_primal": float(state.eps_primal),
        "eps_dual": float(state.eps_dual),
        "rho": float(state.rho),
        "chunked_iterations": state.chunked_iters,
        "exact_iterations": state.exact_iters,
        "escaped": state.escaped,
        "converged": finite and pn <= float(state.eps_primal)
                     and dn <= float(state.eps_dual),
        "diverged": not finite,
    }


def objective(ops: Operators, problem: Problem, theta: torch.Tensor):
    """(fidelity, penalty) of theta: 0.5 ||y - O theta||^2 over the training
    samples via sum y^2 - 2 <O'y, theta> + <counts, theta^2>, and
    ||D theta||_1."""
    w = problem.train_mask
    y = problem.y if w is None else problem.y * w
    fid = 0.5 * (torch.sum(problem.y * y) - 2.0 * ops.total(problem.oty * theta)
                 + ops.total(problem.counts * torch.square(theta)))
    return fid, ops.total(diff_ops.blocks_abs_sum(ops.apply_D(theta)))


# ---------------------------------------------------------------------------
# Batched solves: B problems at once (CV folds, lambda sweeps) through B5.
# ---------------------------------------------------------------------------

def stack_states(states) -> ADMMState:
    """One batched state from B single states."""
    dev = states[0].theta.device

    def counts(name, dtype=torch.int64):
        return torch.tensor([getattr(s, name) for s in states], dtype=dtype, device=dev)

    return ADMMState(
        theta=torch.stack([s.theta for s in states]),
        alpha=tuple(torch.stack(x) for x in zip(*(s.alpha for s in states))),
        u=tuple(torch.stack(x) for x in zip(*(s.u for s in states))),
        rho=torch.stack([s.rho for s in states]),
        counter=counts("counter"),
        primal_norm=torch.stack([s.primal_norm for s in states]),
        dual_norm=torch.stack([s.dual_norm for s in states]),
        eps_primal=torch.stack([s.eps_primal for s in states]),
        eps_dual=torch.stack([s.eps_dual for s in states]),
        cg_iters=counts("cg_iters"),
        u_scale=torch.stack([s.u_scale for s in states]),
        chunked_iters=counts("chunked_iters"),
        exact_iters=counts("exact_iters"),
        escaped=counts("escaped", torch.bool),
    )


def state_at(state: ADMMState, b: int) -> ADMMState:
    """Element b of a batched state, with host counts (one read each)."""
    def host(x):
        return bool(x[b]) if x.dtype == torch.bool else int(x[b])

    return ADMMState(
        theta=state.theta[b], alpha=tuple(a[b] for a in state.alpha),
        u=tuple(w[b] for w in state.u), rho=state.rho[b], counter=host(state.counter),
        primal_norm=state.primal_norm[b], dual_norm=state.dual_norm[b],
        eps_primal=state.eps_primal[b], eps_dual=state.eps_dual[b],
        cg_iters=host(state.cg_iters), u_scale=state.u_scale[b],
        chunked_iters=host(state.chunked_iters), exact_iters=host(state.exact_iters),
        escaped=host(state.escaped))


def initial_state_batched(ops: Operators, problems: Problem, rho0: torch.Tensor) -> ADMMState:
    """initial_state of every element: rho0 is (B,); a shared problem
    (counts of rank p) starts every element from the same state."""
    p = len(ops.m)
    return stack_states([initial_state(ops, problem_at(problems, b, p), rho0[b])
                         for b in range(int(rho0.shape[0]))])


def batched_kernel_route(ops: Operators, problem: Problem, cfg: SolverConfig) -> bool:
    """Whether a batched solve runs B5 (the counterpart of JAX's
    fused_batched_available): where the single whole-lattice kernel route
    applies (see kernel_route, which raises where no kernel route exists),
    with counts per element (rank p + 1, CV folds) or shared (rank p, a
    lambda sweep), under Boyd stopping with dct_pcg (B5's statistics are
    Boyd's, JAX admm.py:768-775; B5 does not read xla_packed or
    spectral_cg, as JAX's fused_batched_available).  JAX's 1 MB VMEM gate
    (pallas_kernels.py:1056-1066) is a TPU rule with no counterpart here.
    On the other kernel routes (tiled above 2^20 knots, tiled3, spectral2,
    spectral3, spectralN) it is False: admm_solve_batched runs each element
    on that single-problem route (_element_config).  Operators cut to row
    slabs raise NotImplementedError: parallel.fit.mvtv_sharded runs its
    folds one after another."""
    if not (_boyd_dct(cfg) and kernel_route(ops, cfg)):
        return False
    route = solve_route(ops, cfg)
    if route == "shard":
        raise NotImplementedError(
            "batched solves on row slabs are not ported (ROADMAP: the fold axis dp); "
            "parallel.fit.mvtv_sharded runs the folds one after another")
    if route != "whole":
        return False
    p = len(ops.m)
    if problem.counts.ndim not in (p, p + 1):
        raise ValueError(f"counts of rank {problem.counts.ndim} on a {p}-D lattice")
    return True


def _element_config(ops: Operators, cfg: SolverConfig) -> SolverConfig:
    """The config of each element of a batched solve off B5, the semantics
    of jax.vmap(admm_solve(batched=True)): no bf16 escape (JAX admm.py:546),
    each element on its own Boyd test and exact cap.  Under Boyd with
    dct_pcg an element keeps the single-problem route solve_route picks
    ("tiled": B8-B10 under the spectral-correction CG; "tiled3": B12/B13;
    "spectral2", "spectral3", "spectralN": no kernel); every other config
    runs the exact route (on a TPU JAX's vmapped solve still takes the bf16
    spectral CG on even lattices there, the port the float32 PCG).  At
    p = 1 an element keeps the "tridiag" route (T1, one fold after
    another; one launch per fold batch is ROADMAP A13).  xla_packed and
    spectral_cg reach each element's x-update unchanged."""
    route = solve_route(ops, cfg)
    keep = route == "tridiag" or (_boyd_dct(cfg) and route in SPECTRAL_ROUTES)
    return dataclasses.replace(cfg, bf16_residual_escape=False,
                               use_kernels=cfg.use_kernels and keep)


def _per_element(lams, problem: Problem, batch: int) -> torch.Tensor:
    """lams as a contiguous (B,) tensor on the problem's device."""
    lams = torch.as_tensor(lams, dtype=problem.oty.dtype, device=problem.oty.device)
    return torch.broadcast_to(lams, (batch,)).contiguous()


def _own(state: ADMMState) -> ADMMState:
    """A copy of the state's lattices, which the chunks update in place."""
    return dataclasses.replace(state, theta=state.theta.clone(),
                               alpha=tuple(a.clone() for a in state.alpha),
                               u=tuple(w.clone() for w in state.u))


def _pad_for_batched(ops: Operators, problem: Problem, state: ADMMState):
    """(ops', problem', state', crop, (stop_ntheta, stop_rows, true_m)):
    odd axes padded to even as in _pad_for_single.  state' never shares
    its lattices with state: the B5 chunks update them in place."""
    if not pad_lib.needs_padding(ops.m):
        return ops, problem, _own(state), (lambda s: s), (None, None, None)
    return _padded(ops, problem, state)


def admm_fused_chunk_batched(ops: Operators, problem: Problem, lams: torch.Tensor,
                             state: ADMMState, cfg: SolverConfig, k_iters: int,
                             active: Optional[torch.Tensor] = None,
                             stop_ntheta: Optional[int] = None,
                             stop_rows: Optional[int] = None,
                             true_m=None, scratch: Optional[dict] = None) -> ADMMState:
    """k_iters ADMM iterations for each of B problems in one call of
    ``admm_iters_2d_batched``, which updates the state's lattices IN PLACE.
    active: (B,) bool tensor on the solve's device (None = all); a frozen
    element keeps its lattices, norms, eps, rho and u_scale, and its
    counters do not move.  scratch: the solve's chain buffers
    (kernels.admm_iters_2d).  Reads nothing from the device."""
    p = len(ops.m)
    batch = int(state.theta.shape[0])
    lams = _per_element(lams, problem, batch)
    sqrt_ntheta = math.sqrt(stop_ntheta if stop_ntheta is not None else ops.ntheta)
    sqrt_rowsd = math.sqrt(stop_rows if stop_rows is not None else ops.rows_d)
    if problem.counts.ndim == p:
        cbars = (torch.sum(problem.counts) / ops.ntheta).expand(batch).contiguous()
    else:
        cbars = torch.sum(problem.counts, dim=tuple(range(1, p + 1))) / ops.ntheta
    n_steps = n_fixed_steps(cfg)
    kern_tm = (tuple(true_m) if true_m is not None and tuple(true_m) != tuple(ops.m)
               else None)
    theta, u, alpha, rho, u_scale, stats = kernels.admm_iters_2d_batched(
        state.theta, state.u, state.alpha, problem.counts, problem.oty, ops.dct_halves_lp,
        ops.gram_eigs_packed, lams, state.rho, state.u_scale, cbars, ops.scales,
        k_iters=k_iters, n_steps=n_steps, active=active, tau=cfg.adapt_tau,
        band=cfg.adapt_band, true_m=kern_tm, adapt=cfg.adapt_rho,
        tau_shrink=cfg.adapt_tau_shrink, scratch=scratch)
    primal_norm = torch.sqrt(stats[:, 0])
    dual_norm = rho * u_scale * torch.sqrt(stats[:, 3])   # the pre-adaptation rho
    eps_primal = cfg.tol * (sqrt_rowsd + torch.maximum(torch.sqrt(stats[:, 1]),
                                                       torch.sqrt(stats[:, 2])))
    eps_dual = cfg.tol * (sqrt_ntheta + torch.sqrt(stats[:, 4]))
    # Per-element NaN poison (admm_fused_chunk): a non-finite CG residual
    # poisons that element's norms and theta only.
    bad = ~torch.isfinite(stats[:, 5])
    primal_norm = torch.where(bad, torch.full_like(primal_norm, float("nan")), primal_norm)
    theta.masked_fill_(bad.reshape((batch,) + (1,) * p), float("nan"))
    act = (torch.ones(batch, dtype=torch.bool, device=lams.device) if active is None
           else active.to(torch.bool))
    steps = act.to(torch.int64) * k_iters

    def keep(new, old):
        return torch.where(act, new, old)

    return dataclasses.replace(
        state, theta=theta, alpha=alpha, u=u, rho=keep(rho, state.rho),
        counter=state.counter + steps, primal_norm=keep(primal_norm, state.primal_norm),
        dual_norm=keep(dual_norm, state.dual_norm),
        eps_primal=keep(eps_primal, state.eps_primal),
        eps_dual=keep(eps_dual, state.eps_dual), cg_iters=state.cg_iters + steps * n_steps,
        u_scale=keep(u_scale, state.u_scale), chunked_iters=state.chunked_iters + steps)


def _not_converged_vec(s: ADMMState, max_iters: int) -> torch.Tensor:
    """(B,) per-element loop predicate on the device (_not_converged)."""
    not_done = (s.dual_norm > s.eps_dual) | (s.primal_norm > s.eps_primal)
    return (not_done & (s.counter < max_iters) & torch.isfinite(s.primal_norm)
            & torch.isfinite(s.dual_norm))


def _solve_each(ops: Operators, problem: Problem, lams: torch.Tensor, state: ADMMState,
                cfg: SolverConfig) -> ADMMState:
    """The batched solve off B5: admm_solve on each element in turn under
    _element_config (jax.vmap(admm_solve(batched=True)) element by element;
    the fold axis through the tiled kernels is ROADMAP A13)."""
    cfg = _element_config(ops, cfg)
    p, batch = len(ops.m), int(state.theta.shape[0])
    lams = _per_element(lams, problem, batch)
    return stack_states([admm_solve(ops, problem_at(problem, b, p), lams[b],
                                    state_at(state, b), cfg) for b in range(batch)])


def admm_solve_batched(ops: Operators, problem: Problem, lams: torch.Tensor,
                       state: ADMMState, cfg: SolverConfig) -> ADMMState:
    """Run B ADMM solves at once until every element is Boyd-converged or
    capped.  On the kernel route: chunks of B5 with the (B,) activity mask
    computed on the device from the state, read once per chunk (the loop
    predicate); the chunked phase runs while an element is not converged
    under max_iters - chunk + 1, then a k = 1 phase through B5 under
    max_iters, so the cap is exact per element.  Odd axes are padded to
    even around the whole loop.  The input state is not modified."""
    if not batched_kernel_route(ops, problem, cfg):
        return _solve_each(ops, problem, lams, state, cfg)
    chunk = resolve_chunk(cfg)
    ops, problem, state, crop, (s_nt, s_rd, t_m) = _pad_for_batched(ops, problem, state)
    scratch = {}

    def run(k, max_iters, s):
        while True:
            act = _not_converged_vec(s, max_iters)
            if not bool(act.any()):
                return s
            s = admm_fused_chunk_batched(ops, problem, lams, s, cfg, k, active=act,
                                         stop_ntheta=s_nt, stop_rows=s_rd, true_m=t_m,
                                         scratch=scratch)

    if chunk > 1:
        state = run(chunk, cfg.max_iters - chunk + 1, state)
    return crop(run(1, cfg.max_iters, state))


def admm_fixed_iterations_batched(ops: Operators, problem: Problem, lams: torch.Tensor,
                                  state: ADMMState, cfg: SolverConfig,
                                  n_iters: int) -> ADMMState:
    """Exactly n_iters iterations on every element (benchmarking), in
    chunks of the cadence admm_solve_batched uses, or off B5 each element
    on its own route under _element_config.  Reads nothing from the device
    on the B5 route."""
    if not batched_kernel_route(ops, problem, cfg):
        p, batch = len(ops.m), int(state.theta.shape[0])
        lams = _per_element(lams, problem, batch)
        cfg = _element_config(ops, cfg)
        return stack_states([admm_fixed_iterations(ops, problem_at(problem, b, p), lams[b],
                                                   state_at(state, b), cfg, n_iters)
                             for b in range(batch)])
    ops, problem, state, crop, (s_nt, s_rd, t_m) = _pad_for_batched(ops, problem, state)
    chunk = min(resolve_chunk(cfg), n_iters)
    full, rem = divmod(n_iters, chunk)
    scratch = {}
    for k in [chunk] * full + ([rem] if rem else []):
        state = admm_fused_chunk_batched(ops, problem, lams, state, cfg, k, stop_ntheta=s_nt,
                                         stop_rows=s_rd, true_m=t_m, scratch=scratch)
    return crop(state)
