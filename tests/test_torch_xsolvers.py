"""The remaining 2-D x-update routes of the port against the JAX package on
the CPU: the plain versions of B6 (xupdate_pcg_2d), B7 (gram_matvec_2d) and
B11 (rhs_tiled_2d) against the Pallas kernels run in interpret mode, B4/B5
with a fixed rho and an asymmetric shrink, and solve_x's other branches
(dct_direct, the fused-dot PCG with both preconditioner precisions,
jacobi_pcg, cg) with shifted_solve and gram_diag.  The kernels themselves
run on the card only: chip_smoke.py holds each against its plain version
there."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.ops import dct as jdct
from multivartv_tpu.ops import diff as jdiff
from multivartv_tpu.ops import pallas_kernels as pk
from multivartv_tpu.solver import xupdate as jxupdate
from multivartv_tpu.solver.cg import pcg_fused as jpcg_fused
from multivartv_tpu.solver.problem import build_operators as jbuild_operators
from multivartv_tpu_torch import convert
from multivartv_tpu_torch.config import SolverConfig
from multivartv_tpu_torch.ops import dct as tdct
from multivartv_tpu_torch.ops import diff as tdiff
from multivartv_tpu_torch.ops import kernels as K
from multivartv_tpu_torch.solver import admm, xupdate
from multivartv_tpu_torch.solver.problem import build_operators

DELTAS = np.asarray([0.4, 0.9], np.float32)
BINS = ((1, 1), (0, 1), (1, 0))


def t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def jops_and_ops(m, **cfg):
    """The JAX package's operators for m and the port's built from them."""
    jops = jbuild_operators(m, jnp.asarray(DELTAS), JSolverConfig(**cfg), jnp.float32)
    ops = convert.operators_from_numpy(
        binaries=jops.binaries, m=jops.m, scales=[np.asarray(s) for s in jops.scales],
        deltas=np.asarray(jops.deltas), gram_eigs=np.asarray(jops.gram_eigs),
        gram_diagonal=(None if jops.gram_diagonal is None else np.asarray(jops.gram_diagonal)),
        dct_mats=[np.asarray(x) for x in jops.dct_mats],
        dct_halves=(None if jops.dct_halves is None
                    else [(np.asarray(a), np.asarray(b)) for a, b in jops.dct_halves]),
        gram_eigs_packed=(None if jops.gram_eigs_packed is None
                          else np.asarray(jops.gram_eigs_packed)), device="cpu")
    return jops, ops


def system(m, seed=3):
    """counts, b, and a warm x0: the exact solution of the system perturbed."""
    rng = np.random.RandomState(seed)
    counts = rng.poisson(3, m).astype(np.float32)
    b = (rng.randn(*m) * 2.0).astype(np.float32)
    return counts, b, rng


# ---------------------------------------------------------------------------
# B6, B7, B11: plain versions against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [(15, 17), (31, 33), (13, 47)])
@pytest.mark.parametrize("start", ["cold", "warm"])
def test_xupdate_pcg_2d_matches_pallas(m, start):
    """B6's plain version (bf16 operands rounded at the TPU kernel's points,
    float32 sums) against _xupdate_kernel in interpret mode on odd lattices.
    The two sum the float32 products in other orders, and a 1-ulp change
    that carries a value across a bf16 boundary moves a cold 3-step solve
    by up to ~2e-3 of max|x| (ROADMAP Queue C): x is held to 2e-3 of max|x|
    from x0 = 0 and to 5e-4 from a warm x0, |r|^2 to rtol 1e-2 (measured
    over seeds 3-5: up to 4.9e-4, 6.2e-5 and 6.2e-4)."""
    jops, ops = jops_and_ops(m)
    counts, b, rng = system(m)
    rho, cbar = np.float32(0.7), np.float32(counts.mean())
    x_star, _ = xupdate.solve_x(ops, t(counts), t(cbar), t(b), t(rho), torch.zeros(m),
                                SolverConfig(use_kernels=False, cg_tol=1e-7))
    x0 = (np.zeros(m, np.float32) if start == "cold"
          else (x_star.numpy() + 0.05 * rng.randn(*m)).astype(np.float32))
    x, rsq = K.xupdate_pcg_2d(t(b), t(x0), t(counts), ops.dct_mats_lp, ops.gram_eigs, t(rho),
                              t(cbar), ops.scales, 3)
    jx, jrsq = pk.xupdate_pcg_2d(jnp.asarray(b), jnp.asarray(x0), jnp.asarray(counts),
                                 jops.dct_mats, jops.gram_eigs, jnp.float32(rho),
                                 jnp.float32(cbar), jops.scales, 3, interpret=True)
    jx = np.asarray(jx, np.float64)
    tol = 2e-3 if start == "cold" else 5e-4
    assert np.max(np.abs(x.numpy() - jx)) <= tol * np.max(np.abs(jx))
    np.testing.assert_allclose(float(rsq), float(jrsq), rtol=1e-2)
    # and the solve moved x0 toward the exact solution
    assert (np.max(np.abs(x.numpy() - x_star.numpy()))
            < np.max(np.abs(x0 - x_star.numpy())))


def _pad8(a, rows=None):
    """a (bf16 or float32) as the card's padded bf16 operand: columns
    zero-padded to a multiple of 8 (and rows to ``rows``)."""
    r, c = a.shape
    out = torch.zeros((rows or r, -(-c // 8) * 8), dtype=torch.bfloat16)
    out[:r, :c] = a.to(torch.bfloat16)
    return out


@pytest.mark.parametrize("m", [(13, 47), (15, 17)])
def test_dense_dct_padded_layout_matches(m):
    """B6's tensor-core products (csrc/dct_mma.cu) run on bf16 operands whose
    rows are zero-padded to a multiple of 8 (16-byte cp.async chunks), the
    first product stored as padded bf16: the same transforms, computed over
    that layout with float32 sums, equal the plain version's unpadded
    dct2_dense / idct2_dense (the zero pads add nothing) to float32
    summation order."""
    m0, m1 = m
    _, ops = jops_and_ops(m)
    t0, t1 = ops.dct_mats_lp
    v = t(np.random.RandomState(7).randn(m0, m1))
    ld0, ld1 = _pad8(t0).shape[1], _pad8(t1).shape[1]
    t0p, t1p, xp = _pad8(t0), _pad8(t1), _pad8(v, rows=ld0)
    f32 = torch.float32
    # forward: tb = T0 x (k over ld0, pad rows of x zero), out = tb T1'
    tb = _pad8((t0p.to(f32) @ xp.to(f32))[:, :m1])
    fwd = (tb.to(f32) @ t1p.to(f32).T[:ld1, :m1])[:, :m1]
    np.testing.assert_allclose(fwd.numpy(), tdct.dct2_dense(v, t0, t1).numpy(), rtol=1e-5,
                               atol=1e-5 * float(fwd.abs().max()))
    # inverse: tb = T0' x, out = tb T1
    t0tp = _pad8(t0p.to(f32)[:, :m0].T.contiguous(), rows=m0)
    tb = _pad8((t0tp.to(f32) @ xp.to(f32))[:, :m1])
    t1pp = torch.zeros((ld1, ld1), dtype=f32)
    t1pp[:m1] = t1p.to(f32)
    inv = (tb.to(f32) @ t1pp)[:, :m1]
    np.testing.assert_allclose(inv.numpy(), tdct.idct2_dense(v, t0, t1).numpy(), rtol=1e-5,
                               atol=1e-5 * float(inv.abs().max()))


@pytest.mark.parametrize("m", [(15, 17), (16, 24)])
def test_gram_matvec_2d_matches_pallas(m):
    """(A v, <v, A v>) against _gram_matvec_kernel in interpret mode: the
    same float32 stencil in the same order (test_pallas.py:29-35 holds it
    at 1e-4): 1e-5 of max(1, |A v|), the dot to rtol 1e-5."""
    jops, ops = jops_and_ops(m)
    counts, v, _ = system(m, seed=5)
    rho = np.float32(0.7)
    out, dot = K.gram_matvec_2d(t(v), t(counts), t(rho), ops.scales)
    jout, jdot = pk.gram_matvec_2d(jnp.asarray(v), jnp.asarray(counts), jnp.float32(rho),
                                   jops.scales, interpret=True)
    jout = np.asarray(jout)
    assert np.max(np.abs(out.numpy() - jout)) <= 1e-5 * max(1.0, np.max(np.abs(jout)))
    np.testing.assert_allclose(float(dot), float(jdot), rtol=1e-5)


@pytest.mark.parametrize("tile_rows", [8, 16])
def test_rhs_tiled_2d_matches_pallas(tile_rows):
    """b = oty + rho D'(alpha + u_scale u) against _tiled_rhs_kernel in
    interpret mode on padded-convention blocks (test_pallas.py:381-397):
    atol 1e-5."""
    m = (32, 128)
    jops, ops = jops_and_ops(m)
    rng = np.random.RandomState(9)
    masks = [np.asarray(jdiff.edge_mask(m, b)) for b in BINS]
    alpha = [(rng.randn(*m) * mk).astype(np.float32) for mk in masks]
    u = [(rng.randn(*m) * mk).astype(np.float32) for mk in masks]
    oty = rng.randn(*m).astype(np.float32)
    rho, us = np.float32(0.07), np.float32(0.5)
    got = K.rhs_tiled_2d(tuple(map(t, alpha)), tuple(map(t, u)), t(oty), t(rho), t(us),
                         ops.scales)
    want = pk.rhs_tiled_2d(tuple(map(jnp.asarray, alpha)), tuple(map(jnp.asarray, u)),
                           jnp.asarray(oty), jnp.float32(rho), jnp.float32(us), jops.scales,
                           interpret=True, tile_rows=tile_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert torch.equal(got, K.rhs_2d(tuple(map(t, alpha)), tuple(map(t, u)), t(oty), t(rho),
                                     t(us), ops.scales))


def test_new_wrappers_reject_bad_arguments():
    m = (15, 17)
    _, ops = jops_and_ops(m)
    z = torch.zeros(m)
    with pytest.raises(ValueError):       # the matrices of another lattice
        K.xupdate_pcg_2d(z, z, z, tuple(reversed(ops.dct_mats_lp)), z, t(0.7), t(1.0),
                         ops.scales, 3)
    with pytest.raises(ValueError):       # float32 matrices
        K.xupdate_pcg_2d(z, z, z, ops.dct_mats, z, t(0.7), t(1.0), ops.scales, 3)
    with pytest.raises(ValueError):
        K.xupdate_pcg_2d(z, z, z, ops.dct_mats_lp, z, t(0.7), t(1.0), ops.scales, 0)
    with pytest.raises(ValueError):       # shape mismatch
        K.gram_matvec_2d(z, z[:, :8], t(0.7), ops.scales)
    with pytest.raises(ValueError):       # no kernel for the meta device
        K.rhs_tiled_2d((z.to("meta"),) * 3, (z.to("meta"),) * 3, z.to("meta"), t(0.7), None,
                       ops.scales)


# ---------------------------------------------------------------------------
# B4/B5 with a fixed rho and the asymmetric shrink
# ---------------------------------------------------------------------------

def _chain_inputs(m=(16, 128), seed=3):
    rng = np.random.RandomState(seed)
    counts = rng.poisson(3, m).astype(np.float32)
    oty = (rng.randn(*m) * counts).astype(np.float32)
    theta0 = np.full(m, float(oty.sum() / counts.sum()), np.float32)
    return counts, oty, theta0


@pytest.mark.parametrize("adapt,tau_shrink", [(False, None), (True, 10.0)])
def test_admm_iters_adapt_and_shrink_match_pallas(adapt, tau_shrink):
    """K = 4 iterations of B4 (and B5 on two problems) with adapt=False or
    the asymmetric x20 / 10 / band-20 rule against the interpret kernels:
    the same rho and u_scale, theta to 5e-3 of max|theta| and the norms to
    rtol 1e-2 (test_torch_kernels.py's tolerances); (16, 128) is B5's DMA
    alignment."""
    m = (16, 128)
    jops, ops = jops_and_ops(m, cg_fixed_iters=3)
    counts, oty, theta0 = _chain_inputs(m)
    zeros = [np.zeros(m, np.float32)] * 3
    # rho0 1e-4 makes the asymmetric rule grow rho x20 at once
    lam, rho0, cbar = 0.08, (1e-4 if adapt else 0.016), float(counts.mean())
    kw = dict(k_iters=4, n_steps=3, tau=20.0, band=20.0, adapt=adapt, tau_shrink=tau_shrink)
    out = K.admm_iters_2d(t(theta0), tuple(map(t, zeros)), tuple(map(t, zeros)), t(counts),
                          t(oty), ops.dct_halves_lp, ops.gram_eigs_packed, t(lam), t(rho0),
                          t(1.0), t(cbar), ops.scales, **kw)
    j = jnp.asarray
    jout = pk.admm_iters_2d(j(theta0), tuple(map(j, zeros)), tuple(map(j, zeros)), j(counts),
                            j(oty), jops.dct_halves, jops.gram_eigs_packed, jnp.float32(lam),
                            jnp.float32(rho0), jnp.float32(1.0), jnp.float32(cbar), jops.scales,
                            interpret=True, **kw)
    assert float(out[3]) == float(jout[3]) and float(out[4]) == float(jout[4])
    if not adapt:
        assert float(out[3]) == np.float32(rho0) and float(out[4]) == 1.0
    scale = float(np.max(np.abs(np.asarray(jout[0]))))
    assert float(np.max(np.abs(out[0].numpy() - np.asarray(jout[0])))) < 5e-3 * scale
    np.testing.assert_allclose(out[5][[0, 3]].numpy(), np.asarray(jout[5])[[0, 3]], rtol=1e-2)

    # B5 on two problems (the second with half the lambda) row by row
    th = np.stack([theta0, theta0])
    z2 = [np.zeros((2,) + m, np.float32)] * 3
    lams = np.asarray([lam, lam / 2], np.float32)
    rhos = np.asarray([rho0, rho0], np.float32)
    ones = np.ones(2, np.float32)
    cbars = np.asarray([cbar, cbar], np.float32)
    # B5 updates its state in place: the port's lattices are copies
    bout = K.admm_iters_2d_batched(t(th).clone(), tuple(t(z).clone() for z in z2),
                                   tuple(t(z).clone() for z in z2), t(counts),
                                   t(oty), ops.dct_halves_lp, ops.gram_eigs_packed, t(lams),
                                   t(rhos), t(ones), t(cbars), ops.scales, **kw)
    jb = pk.admm_iters_2d_batched(j(th), tuple(map(j, z2)), tuple(map(j, z2)), j(counts),
                                  j(oty), jops.dct_halves, jops.gram_eigs_packed, j(lams),
                                  j(rhos), j(ones), j(cbars), jops.scales, interpret=True, **kw)
    np.testing.assert_array_equal(bout[3].numpy(), np.asarray(jb[3]))
    np.testing.assert_array_equal(bout[4].numpy(), np.asarray(jb[4]))
    for b in range(2):
        want = np.asarray(jb[0][b])
        assert float(np.max(np.abs(bout[0][b].numpy() - want))) < 5e-3 * np.max(np.abs(want))


def test_adapt_rho_rules():
    """One step of each rule (reference adapt_step, solvers.cpp:77-94;
    cpp-code/solvers.cpp:71-88): grow x tau, shrink / tau_shrink, hold."""
    rho = torch.tensor(1e-4)
    one = torch.tensor(1.0)
    for pn, dn, want in ((100.0, 1.0, 20.0), (1.0, 100.0, 0.1), (1.0, 1.0, 1.0)):
        r, us = K.adapt_rho(rho, torch.tensor(pn), torch.tensor(dn), 20.0, 20.0,
                            tau_shrink=10.0)
        assert float(r) == pytest.approx(1e-4 * want, rel=1e-6)
        assert float(us) == pytest.approx(1.0 / want, rel=1e-6)
    r, us = K.adapt_rho(rho, torch.tensor(100.0), one, 2.0, 10.0, adapt=False)
    assert float(r) == float(rho) and float(us) == 1.0


# ---------------------------------------------------------------------------
# solve_x's branches, shifted_solve, gram_diag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [(12, 16), (4096 // 64, 9)])
def test_shifted_solve_and_gram_diag_match_jax(m):
    """Exact float32 transforms on both sides: 1e-5 of max|x| through the
    dense matrices and through the FFT DCT; diag(D'D) exactly."""
    jops, ops = jops_and_ops(m, x_solver="jacobi_pcg")
    _, b, _ = system(m)
    for mats, jmats in ((ops.dct_mats, jops.dct_mats), (None, None)):
        got = tdct.shifted_solve(t(b), 3.0, t(0.7), ops.gram_eigs, mats)
        want = np.asarray(jdct.shifted_solve(jnp.asarray(b), 3.0, jnp.float32(0.7),
                                             jops.gram_eigs, jmats))
        assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))
    np.testing.assert_array_equal(
        tdiff.gram_diag(m, ops.binaries, ops.scales).numpy(), np.asarray(jops.gram_diagonal))
    np.testing.assert_array_equal(ops.gram_diagonal.numpy(), np.asarray(jops.gram_diagonal))
    built = build_operators(m, DELTAS, SolverConfig(x_solver="jacobi_pcg"), "cpu")
    np.testing.assert_array_equal(built.gram_diagonal.numpy(), np.asarray(jops.gram_diagonal))
    assert build_operators(m, DELTAS, SolverConfig(), "cpu").gram_diagonal is None


@pytest.mark.parametrize("x_solver", ["dct_direct", "jacobi_pcg", "cg"])
@pytest.mark.parametrize("route", ["whole", "exact"])
def test_solve_x_variants_match_jax(x_solver, route):
    """dct_direct, jacobi_pcg and cg through solve_x on the whole-lattice
    route (where the kernel x-updates do not apply) and on the exact route,
    against the JAX package's solve_x: 1e-4 of max|x| (tolerance-driven
    float32 PCG on both sides, dct_direct one exact solve)."""
    m = (15, 20)
    jcfg = JSolverConfig(x_solver=x_solver, use_pallas=False, cg_max_iters=300)
    jops, ops = jops_and_ops(m, x_solver=x_solver)
    counts, b, _ = system(m)
    rho, cbar = np.float32(0.7), np.float32(counts.mean())
    cfg = SolverConfig(x_solver=x_solver, use_kernels=route == "whole", cg_max_iters=300)
    x0 = np.zeros(m, np.float32)
    got, _ = xupdate.solve_x(ops, t(counts), t(cbar), t(b), t(rho), t(x0), cfg,
                             use_kernels=route == "whole")
    want, _ = jxupdate.solve_x(jops, jnp.asarray(counts), jnp.float32(cbar), jnp.asarray(b),
                               jnp.float32(rho), jnp.asarray(x0), jcfg)
    want = np.asarray(want)
    assert np.max(np.abs(got.numpy() - want)) <= 1e-4 * np.max(np.abs(want))
    if route == "whole":
        kind = xupdate.whole_xupdate(ops, cfg)
        assert kind == ("direct" if x_solver == "dct_direct" else "pcg")


@pytest.mark.parametrize("precond_bf16", [False, True])
@pytest.mark.parametrize("m", [(16, 24), (15, 17)])
def test_fused_dot_pcg_matches_jax(precond_bf16, m):
    """The whole route past the one-kernel gate (JAX xupdate.py:413-437):
    pcg_fused with gram_matvec_2d and the dense preconditioner, float32 or
    bf16 (rounded to bf16 after every axis), against the JAX package's
    pcg_fused with the interpret gram_matvec_2d and its preconditioner: x to
    1e-5 of max|x| in float32 (the same products up to the order of their
    sums) and 2e-3 in bf16 (rounding flips, see the B6 test; measured over
    seeds 3-5 up to 5.4e-7 and 2.5e-4)."""
    jops, ops = jops_and_ops(m)
    counts, b, rng = system(m)
    rho, cbar = np.float32(0.7), np.float32(counts.mean())
    x0 = (0.1 * rng.randn(*m)).astype(np.float32)
    cfg = SolverConfig(precond_bf16=precond_bf16)
    assert xupdate.whole_xupdate(ops, cfg, one_kernel=False) == "fused"
    got, steps = xupdate.solve_x(ops, t(counts), t(cbar), t(b), t(rho), t(x0), cfg,
                                 use_kernels=True, one_kernel=False)
    jc, jrho = jnp.asarray(counts), jnp.float32(rho)
    eigs, mats = jops.gram_eigs, jops.dct_mats

    def matvec_dot(v):
        return pk.gram_matvec_2d(v, jc, jrho, jops.scales, interpret=True)

    def precond_dot(r):
        w = cbar + jrho * eigs
        if precond_bf16:
            lp = tuple(x.astype(jnp.bfloat16) for x in mats)
            rhat = jdct.dctn_mat(r.astype(jnp.bfloat16), lp).astype(r.dtype)
            zhat = rhat / w
            return (jdct.idctn_mat(zhat.astype(jnp.bfloat16), lp).astype(r.dtype),
                    jnp.sum(rhat * zhat))
        rhat = jdct.dctn_mat(r, mats)
        zhat = rhat / w
        return jdct.idctn_mat(zhat, mats), jnp.sum(rhat * zhat)

    want = np.asarray(jpcg_fused(matvec_dot, precond_dot, jnp.asarray(b), jnp.asarray(x0),
                                 3).x)
    assert steps == 3
    tol = 2e-3 if precond_bf16 else 1e-5
    assert np.max(np.abs(got.numpy() - want)) <= tol * np.max(np.abs(want))


def test_whole_xupdate_branches():
    """solve_x's branch on the whole route (JAX xupdate.py:378-527):
    folded halves -> B3, an odd axis -> B6, past the one-kernel gate -> B7,
    no dense matrices -> the spectral CG, no folded halves either -> PCG."""
    cfg = SolverConfig()
    even = build_operators((16, 24), DELTAS, cfg, "cpu")
    odd = build_operators((15, 24), DELTAS, cfg, "cpu")
    assert xupdate.whole_xupdate(even, cfg) == "packed"
    assert xupdate.whole_xupdate(odd, cfg) == "dense"
    assert xupdate.whole_xupdate(odd, cfg, one_kernel=False) == "fused"
    assert xupdate.whole_xupdate(dataclasses.replace(even, dct_mats=None), cfg) == "spectral"
    assert xupdate.whole_xupdate(dataclasses.replace(odd, dct_mats=None), cfg) == "pcg"
    assert admm.xupdate_supported((1024, 1024)) and not admm.xupdate_supported((4096, 256))


@pytest.mark.parametrize("x_solver", ["jacobi_pcg", "cg"])
def test_x_solver_variants_agree(x_solver):
    """jacobi_pcg and cg against dct_pcg on the same problem (test_admm.py:
    112-127): theta to 2e-3; and each against the JAX package's solve with
    the same x-solver (its CPU route, the plain PCG): objective 1e-5."""
    import jax

    from multivartv_tpu.solver import admm as jadmm
    from multivartv_tpu.solver.problem import Problem as JProblem

    m = (5, 4)
    rng = np.random.RandomState(117)
    counts = rng.poisson(8, m).astype(np.float32)
    oty = (rng.randn(*m) * counts + counts).astype(np.float32)
    ybar = np.float32(oty.sum() / counts.sum())
    tp = convert.problem_from_numpy(counts=counts, oty=oty, ybar=ybar,
                                    flat_idx=np.zeros(1, np.int64), y=np.zeros(1, np.float32),
                                    device="cpu")
    lam = torch.tensor(0.1)
    thetas = {}
    for xs in ("dct_pcg", x_solver):
        cfg = SolverConfig(x_solver=xs, cg_max_iters=300)
        ops = build_operators(m, DELTAS, cfg, "cpu")
        out = admm.admm_solve(ops, tp, lam, admm.initial_state(ops, tp, lam / 5.0), cfg)
        thetas[xs] = out.theta.numpy()
    np.testing.assert_allclose(thetas["dct_pcg"], thetas[x_solver], atol=2e-3)

    jcfg = JSolverConfig(x_solver=x_solver, cg_max_iters=300)
    jops = jbuild_operators(m, jnp.asarray(DELTAS), jcfg, jnp.float32)
    jp = JProblem(counts=jnp.asarray(counts), oty=jnp.asarray(oty), ybar=jnp.asarray(ybar),
                  flat_idx=jnp.zeros((1,), jnp.int32), y=jnp.zeros((1,), jnp.float32))
    js = jadmm.initial_state(jops, jp, rho0=jnp.float32(0.02))
    jth = np.asarray(jax.jit(lambda s: jadmm.admm_solve(jops, jp, jnp.float32(0.1), s,
                                                        jcfg).theta)(js))
    ops = build_operators(m, DELTAS, SolverConfig(x_solver=x_solver), "cpu")

    def obj(th):
        fid, pen = admm.objective(ops, tp, torch.as_tensor(th, dtype=torch.float32))
        return float(fid) + 0.1 * float(pen)

    assert abs(obj(thetas[x_solver]) - obj(jth)) <= 1e-5 * abs(obj(jth))
