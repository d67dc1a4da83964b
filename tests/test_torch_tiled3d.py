"""The p = 3 routes of the port against the JAX package on the CPU: the
plain versions of B12, B13 and B14 against the JAX kernels in interpret
mode, the route gate, the tiled3 and no-kernel (spectral3) solves, the
p-dim packed DCT, padding, lambda_max, mvtv_one, mvtv(folds=1) and
convert at p = 3.

The JAX side runs its tiled3 route as tests/test_tiled3d.py runs it here:
the kernels in interpret mode with 16-row panels (``_tile_rows_3d``),
``TILED3_MIN_KNOTS`` lowered, ``FORCE_FUSED_INTERPRET`` and
``FORCE_XLA_PACKED`` on; its no-kernel spectral route with
``FORCE_XLA_PACKED`` alone.  The port reaches its tiled3 route on a small
lattice with ``admm.TILED3_MIN_KNOTS`` lowered.  Objectives are compared,
not theta (tests/test_torch_admm.py)."""

import numpy as np
import pytest
import scipy.fft

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import golden
from multivartv_tpu import api as japi
from multivartv_tpu.config import PathConfig as JPathConfig
from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.ops import dct as jdct
from multivartv_tpu.ops import diff as jdiff
from multivartv_tpu.ops import pallas_kernels as pk
from multivartv_tpu.solver import admm as jadmm
from multivartv_tpu.solver import pad as jpad
from multivartv_tpu.solver import problem as jproblem
from multivartv_tpu.solver import xupdate as jxupdate
from multivartv_tpu.solver.problem import Problem as JProblem
from multivartv_tpu_torch import convert, mvtv, mvtv_one
from multivartv_tpu_torch.api import _setup
from multivartv_tpu_torch.config import DEFAULT_MESH, PathConfig, SolverConfig
from multivartv_tpu_torch.ops import dct
from multivartv_tpu_torch.ops import kernels as K
from multivartv_tpu_torch.solver import admm, pad
from multivartv_tpu_torch.solver import path as tpath
from multivartv_tpu_torch.solver import xupdate
from multivartv_tpu_torch.solver.problem import build_operators

M3 = (6, 8, 128)
T3 = 16
DELTAS3 = np.asarray([0.5, 0.8, 1.2], np.float32)
LAM = 0.08
BINS3 = jdiff.fd_binaries(3, True)


def _close(got, want, tol=1e-5):
    """max |got - want| <= tol * max(1, max |want|)."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape
    err = np.max(np.abs(g - w)) / max(1.0, np.max(np.abs(w)))
    assert err <= tol, err


# ---------------------------------------------------------------------------
# B12, B13, B14: plain versions against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------

def _kernel_inputs(seed=3, m=M3):
    rng = np.random.RandomState(seed)
    scales = tuple(float(s) for s in jdiff.delta_scales(BINS3, jnp.asarray(DELTAS3)))
    theta = rng.randn(*m).astype(np.float32)
    u = tuple((rng.randn(*m) * np.asarray(jdiff.edge_mask(m, b))).astype(np.float32)
              for b in BINS3)
    return scales, theta, u, rng


def test_block_order_is_jax():
    assert tuple(BINS3) == K.BINARIES3 == pk._BINARIES3
    assert admm.TILED3_MIN_KNOTS == pk.TILED3_MIN_KNOTS == 1 << 22


# (lattice, JAX panel rows, true_m).  Besides M3, lattices with odd m0 and
# m1 (odd m0 m1 rows, so panels of 15 and 35 rows) and an m2 that is no
# multiple of 64: they pin the wrap at every axis's first row and the
# remainder tiles that the card's plane-marching B12 must keep.
DUAL3_CASES = [pytest.param((M3, T3, None), id="None"),
               pytest.param((M3, T3, (5, 7, 120)), id="true_m1"),
               pytest.param(((9, 5, 72), 15, None), id="9x5x72-None"),
               pytest.param(((9, 5, 72), 15, (8, 4, 70)), id="9x5x72-true_m"),
               pytest.param(((7, 15, 40), 35, None), id="7x15x40-None"),
               pytest.param(((7, 15, 40), 35, (6, 13, 37)), id="7x15x40-true_m")]


@pytest.mark.parametrize("want_alpha,want_adjoints", [(True, False), (False, True),
                                                      (True, True)])
@pytest.mark.parametrize("case", DUAL3_CASES)
def test_dual_update_tiled_3d_matches_jax(want_alpha, want_adjoints, case):
    m, tile_rows, true_m = case
    scales, theta, u, _ = _kernel_inputs(m=m)
    kappa, us = np.float32(0.3), np.float32(0.7)
    want = pk.dual_update_tiled_3d(jnp.asarray(theta), tuple(map(jnp.asarray, u)),
                                   jnp.float32(kappa), scales, u_scale=jnp.float32(us),
                                   true_m=true_m, want_adjoints=want_adjoints,
                                   want_alpha=want_alpha, interpret=True, tile_rows=tile_rows)
    got = K.dual_update_tiled_3d(torch.as_tensor(theta), tuple(map(torch.as_tensor, u)),
                                 torch.tensor(kappa), scales, u_scale=torch.tensor(us),
                                 true_m=true_m, want_adjoints=want_adjoints,
                                 want_alpha=want_alpha)
    assert len(got) == len(want) == (5 if want_adjoints else 3)
    assert (got[0] is None) == (want[0] is None) == (not want_alpha)
    lat = [(*(g[0] or ()), *g[1], *g[3:]) for g in (got, want)]
    for g, w in zip(*lat):
        _close(g.numpy(), w)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_gram_residual_tiled_3d_matches_jax(fused):
    scales, v, (oty, dta, dtu, *_), rng = _kernel_inputs(seed=21)
    counts = rng.poisson(3, M3).astype(np.float32)
    rho, us = np.float32(0.13), np.float32(0.6)
    b = (oty + rho * (dta + us * dtu)).astype(np.float32)
    j = jnp.asarray
    jparts = (j(oty), j(dta), jnp.float32(us), j(dtu)) if fused else None
    want = pk.gram_residual_tiled_3d(None if fused else j(b), j(v), j(counts), jnp.float32(rho),
                                     scales, rhs_parts=jparts, interpret=True, tile_rows=T3)
    t = torch.as_tensor
    tparts = (t(oty), t(dta), torch.tensor(us), t(dtu)) if fused else None
    got = K.gram_residual_tiled_3d(None if fused else t(b), t(v), t(counts), torch.tensor(rho),
                                   scales, rhs_parts=tparts)
    _close(got.numpy(), want)


def test_rhs_tiled_3d_matches_jax():
    scales, _, u, rng = _kernel_inputs(seed=9)
    alpha = tuple((rng.randn(*M3) * np.asarray(jdiff.edge_mask(M3, b))).astype(np.float32)
                  for b in BINS3)
    oty = rng.randn(*M3).astype(np.float32)
    rho, us = np.float32(0.3), np.float32(1.4)
    want = pk.rhs_tiled_3d(tuple(map(jnp.asarray, alpha)), tuple(map(jnp.asarray, u)),
                           jnp.asarray(oty), jnp.float32(rho), jnp.float32(us), scales,
                           interpret=True, tile_rows=T3)
    got = K.rhs_tiled_3d(tuple(map(torch.as_tensor, alpha)), tuple(map(torch.as_tensor, u)),
                         torch.as_tensor(oty), torch.tensor(rho), torch.tensor(us), scales)
    _close(got.numpy(), want)


def test_tiled3_wrappers_reject_bad_arguments():
    scales, v, u, _ = _kernel_inputs()
    t = torch.as_tensor
    tu = tuple(map(t, u))
    with pytest.raises(ValueError):       # six blocks
        K.dual_update_tiled_3d(t(v), tu[:6], torch.tensor(0.1), scales)
    with pytest.raises(ValueError):       # a 2-D lattice
        K.gram_residual_tiled_3d(t(v[0]), t(v[0]), t(v[0]), torch.tensor(0.1), scales)
    with pytest.raises(ValueError):       # a float64 lattice
        K.rhs_tiled_3d(tu, tu, t(v).double(), torch.tensor(0.1), None, scales)


# ---------------------------------------------------------------------------
# The route gate and padding
# ---------------------------------------------------------------------------

def _jax_kernels(m, binaries=BINS3):
    """Whether the JAX package runs its tiled3 kernels on m: on its
    (2, 8, 128) padded lattice, where its blow-up gate pads."""
    mp = jpad.pad_target_m(m)
    if np.prod(mp) > 4 * np.prod(m):
        mp = m
    return pk.tiled3_supported(mp, binaries)


def _port_route(m, full_set=True):
    return admm.lattice_route(pad.pad_target_m(m), full_set)


@pytest.mark.parametrize("m,jax_kernels,port_route", [
    ((256, 256, 256), True, "tiled3"),
    ((128, 128, 128), False, "spectral3"),
    ((255, 255, 256), True, "tiled3"),
    # Mosaic's alignment, not carried over: the port keeps 256 x 250 x 256
    # (its packed layout), JAX pads it to 256^3.
    ((256, 250, 256), True, "tiled3"),
    # 130^3 stays below 2^22 here; JAX pads it to 130 x 136 x 256, above.
    ((130, 130, 130), True, "spectral3"),
])
def test_route_gate_against_jax(m, jax_kernels, port_route):
    assert _jax_kernels(m) == jax_kernels
    assert _port_route(m) == port_route
    # the reduced block set has no kernel on either side
    assert not _jax_kernels(m, jdiff.fd_binaries(3, False))
    assert _port_route(m, full_set=False) == "spectral3"


def test_pad_targets_and_blowup_gate():
    assert pad.pad_target_m((255, 255, 256)) == (256, 256, 256)
    assert pad.pad_applies((5, 7, 9)) and not pad.pad_applies((1, 1, 7))
    cfg = SolverConfig()
    ops = build_operators((5, 7, 9), DELTAS3, cfg, "cpu")
    assert ops.padded.m == (6, 8, 10) and admm.pad_single_applies(ops, cfg)
    blown = build_operators((1, 1, 7), DELTAS3, cfg, "cpu")
    assert blown.padded is None and not admm.pad_single_applies(blown, cfg)
    assert admm.solve_route(blown, cfg) is None       # the exact route, as in JAX
    assert build_operators((6, 8, 10), DELTAS3, cfg, "cpu").padded is None


def test_blocked_and_quartered_sets_at_p3(monkeypatch):
    """The layouts' operand sets, built generically, at p = 3: 8 blocked
    and 64 quartered blocks of the JAX package's shapes and values."""
    from multivartv_tpu_torch.solver import problem as tproblem
    monkeypatch.setattr(tproblem, "QUARTER_MIN_AXIS", 4)
    monkeypatch.setattr(jproblem, "QUARTER_MIN_AXIS", 4)
    m = (8, 12, 16)
    ops = build_operators(m, DELTAS3, SolverConfig(), "cpu")
    jops = jproblem.build_operators(m, jnp.asarray(DELTAS3), JSolverConfig(), jnp.float32)
    for name, count in (("gram_eigs_blocked", 8), ("gram_eigs_quartered", 64)):
        got, want = getattr(ops, name), getattr(jops, name)
        assert len(got) == len(want) == count
        for g, w in zip(got, want):
            _close(g.numpy(), w, 1e-6)
    assert len(ops.dct_quarters_lp) == 3 and xupdate.spectral_layout(ops) == "quartered"
    x = np.random.RandomState(0).randn(*m).astype(np.float32)
    assert len(dct.to_blocks4(torch.as_tensor(x), 3)) == 64
    np.testing.assert_array_equal(
        dct.from_blocks4(dct.to_blocks4(torch.as_tensor(x), 3), 3).numpy(), x)


def test_dctn_packed_matches_jax():
    """The p-dim packed transform and its inverse at p = 3, bf16 halves
    (the JAX package's mat_dtype = bf16), against JAX's: 1e-5 of max."""
    m = (6, 8, 10)
    x = np.random.RandomState(1).randn(*m).astype(np.float32)
    halves = tuple(dct.dct_packed_halves(v) for v in m)
    lp = tuple((te.to(torch.bfloat16), to.to(torch.bfloat16)) for te, to in halves)
    jh = tuple((jnp.asarray(te.numpy()), jnp.asarray(to.numpy())) for te, to in halves)
    got = dct.dctn_packed(torch.as_tensor(x), lp)
    want = jdct.dctn_packed(jnp.asarray(x), jh, mat_dtype=jnp.bfloat16)
    _close(got.numpy(), want)
    back = dct.idctn_packed(got, lp)
    _close(back.numpy(), jdct.idctn_packed(jnp.asarray(got.numpy()), jh,
                                           mat_dtype=jnp.bfloat16))
    _close(back.numpy(), x, 2e-2)       # bf16 halves: an approximate inverse


# ---------------------------------------------------------------------------
# The solves
# ---------------------------------------------------------------------------

def objective3(theta, counts, oty, lam=LAM, deltas=DELTAS3):
    """0.5 <counts, theta^2> - <O'y, theta> + lam ||D theta||_1 in float64
    over the 7 blocks: the objective less the constant 0.5 ||y||^2."""
    th = np.asarray(theta, np.float64)
    pen = 0.0
    for b, s in zip(BINS3, jdiff.delta_scales(BINS3, jnp.asarray(deltas))):
        d = th
        for j, bj in enumerate(b):
            if bj:
                d = np.diff(d, axis=j)
        pen += float(s) * np.abs(d).sum()
    return 0.5 * np.sum(counts * th * th) - np.sum(oty * th) + lam * pen


def _problem3(m, seed=11):
    """tests/test_tiled3d.py's problem: counts ~ Poisson(2), O'y = N(0, 1)
    times counts, on both sides."""
    rng = np.random.RandomState(seed)
    counts = rng.poisson(2, m).astype(np.float32)
    oty = (rng.randn(*m).astype(np.float32) * counts).astype(np.float32)
    ybar = np.float32(oty.sum() / counts.sum())
    jp = JProblem(counts=jnp.asarray(counts), oty=jnp.asarray(oty), ybar=jnp.asarray(ybar),
                  flat_idx=jnp.zeros((1,), jnp.int32), y=jnp.zeros((1,), jnp.float32))
    tp = convert.problem_from_numpy(counts=counts, oty=oty, ybar=ybar,
                                    flat_idx=np.zeros(1, np.int64), y=np.zeros(1, np.float32),
                                    device="cpu")
    return jp, tp, counts, oty


@pytest.fixture
def tiled3_here(monkeypatch):
    """Both packages on their tiled3 route at M3, the JAX side with
    16-row panels."""
    monkeypatch.setattr(admm, "TILED3_MIN_KNOTS", 1)
    monkeypatch.setattr(pk, "TILED3_MIN_KNOTS", 1)
    monkeypatch.setattr(pk, "_tile_rows_3d", lambda mm, **kw: T3)
    monkeypatch.setattr(jadmm, "FORCE_FUSED_INTERPRET", True)
    monkeypatch.setattr(jxupdate, "FORCE_XLA_PACKED", True)
    return monkeypatch


@pytest.mark.parametrize("layout", ["packed", "blocked"])
def test_admm_solve_tiled3_matches_jax(tiled3_here, layout):
    """admm_solve through B12 and B13 (plain versions here) against JAX's
    tiled3 route (test_tiled3d.py:159-196): objective within 2e-5 and the
    same iteration count, in the packed layout and, with BLOCKED_MIN_HALF
    lowered on both sides, in the blocked one."""
    if layout == "blocked":
        tiled3_here.setattr(jxupdate, "BLOCKED_MIN_HALF", 2)
        tiled3_here.setattr(xupdate, "BLOCKED_MIN_HALF", 2)
    jp, tp, counts, oty = _problem3(M3)
    cfg = dict(chunk_iters=1, cg_fixed_iters=3, max_iters=60)
    jops = jproblem.build_operators(M3, jnp.asarray(DELTAS3), JSolverConfig(**cfg), jnp.float32)
    assert pk.tiled3_supported(M3, jops.binaries)
    assert jxupdate.spectral_layout(jops) == layout
    js0 = jadmm.initial_state(jops, jp, rho0=jnp.float32(LAM / 5.0))
    jout = jadmm.admm_solve(jops, jp, jnp.float32(LAM), js0, JSolverConfig(**cfg))

    tcfg = SolverConfig(**cfg)
    ops = build_operators(M3, DELTAS3, tcfg, "cpu")
    assert admm.solve_route(ops, tcfg) == "tiled3"
    assert xupdate.spectral_layout(ops) == layout
    before = dict(K.launch_counts)
    s0 = admm.initial_state(ops, tp, torch.tensor(LAM / 5.0))
    out = admm.admm_solve(ops, tp, torch.tensor(LAM), s0, tcfg)
    assert K.launch_counts == before          # CPU tensors: the plain versions, no launch
    assert len(out.alpha) == 7 and out.dtu is not None
    ref = objective3(np.asarray(jout.theta), counts, oty)
    got = objective3(out.theta.numpy(), counts, oty)
    assert abs(got - ref) <= 2e-5 * abs(ref), (got, ref)
    assert out.counter == int(jout.counter)


def test_spectral3_route_matches_jax(monkeypatch):
    """Below the tiled3 gate: the no-kernel spectral route (plain rhs, r0
    and dual stage) against JAX's FORCE_XLA_PACKED route, and both against
    the exact route at tol = 1e-5 (objective 2e-5)."""
    monkeypatch.setattr(jxupdate, "FORCE_XLA_PACKED", True)
    jp, tp, counts, oty = _problem3(M3, seed=5)
    cfg = dict(chunk_iters=1, cg_fixed_iters=3, max_iters=60)
    jops = jproblem.build_operators(M3, jnp.asarray(DELTAS3), JSolverConfig(**cfg), jnp.float32)
    js0 = jadmm.initial_state(jops, jp, rho0=jnp.float32(LAM / 5.0))
    jout = jadmm.admm_solve(jops, jp, jnp.float32(LAM), js0, JSolverConfig(**cfg))
    tcfg = SolverConfig(**cfg)
    ops = build_operators(M3, DELTAS3, tcfg, "cpu")
    assert admm.solve_route(ops, tcfg) == "spectral3" and not admm.tiled_route(ops, tcfg)
    out = admm.admm_solve(ops, tp, torch.tensor(LAM), admm.initial_state(
        ops, tp, torch.tensor(LAM / 5.0)), tcfg)
    assert out.exact_iters == 0 and out.chunked_iters == 0
    ref = objective3(np.asarray(jout.theta), counts, oty)
    got = objective3(out.theta.numpy(), counts, oty)
    assert abs(got - ref) <= 2e-5 * abs(ref), (got, ref)
    assert out.counter == int(jout.counter)


def _data3(m, seed=29, per_knot=3):
    rng = np.random.RandomState(seed)
    n = per_knot * int(np.prod(m))
    x = rng.uniform(-1, 1, (n, 3))
    return x, np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + x[:, 2] + 0.3 * rng.randn(n)


def test_padded_odd_lattice_is_exact(monkeypatch):
    """An odd 3-D lattice on the tiled3 route, padded to even axes with the
    true_m masks in B12: its objective against the unpadded exact route
    and against tests/golden.py's float64 ADMM (sparse solves), each
    objective taken by golden.objective, within 2e-5."""
    monkeypatch.setattr(admm, "TILED3_MIN_KNOTS", 1)
    m = (5, 7, 9)
    x, y = _data3(m)
    lam = 0.05
    res = {}
    for route, cfg in (("tiled3", SolverConfig(tol=1e-5)),
                       ("exact", SolverConfig(tol=1e-5, use_kernels=False))):
        _, _, _, _, _, ops, problem = _setup(x, y, m, None, cfg, DEFAULT_MESH, "cpu")
        assert admm.solve_route(ops, cfg) == (None if route == "exact" else "tiled3")
        out = admm.admm_solve(ops, problem, torch.tensor(lam),
                              admm.initial_state(ops, problem, torch.tensor(lam)), cfg)
        assert out.theta.shape == m
        res[route] = out.theta.numpy().astype(np.float64)
    flat, deltas = problem.flat_idx.numpy(), ops.deltas.numpy().astype(np.float64)
    gold = golden.admm_golden(flat, y, m, deltas, lam, tol=1e-5)

    def obj(theta):
        return golden.objective(flat, y, m, deltas, theta, lam)

    want = obj(gold["theta"])
    for route, theta in res.items():
        assert abs(obj(theta) - want) <= 2e-5 * abs(want), (route, obj(theta), want)


def test_lam_max_p3_matches_float64_numpy():
    """lambda_max at p = 3 against numpy/scipy in float64: the closed-form
    7-block Gram eigenvalues prod(mu + d^2) - prod(d^2), scipy's DCT,
    np.diff chains."""
    m = (6, 10, 12)
    x, y = _data3(m, seed=3)
    _, _, _, _, _, ops, problem = _setup(x, y, m, None, SolverConfig(), DEFAULT_MESH, "cpu")
    oty = problem.oty.numpy().astype(np.float64)
    d = ops.deltas.numpy().astype(np.float64)
    mu = [4 * np.sin(np.pi * np.arange(v) / (2 * v)) ** 2 for v in m]
    grid = np.meshgrid(*mu, indexing="ij")
    eigs = np.prod([g + dj ** 2 for g, dj in zip(grid, d)], axis=0) - np.prod(d ** 2)
    coef = scipy.fft.dctn(oty, type=2, norm="ortho")
    pinv = scipy.fft.idctn(np.where(eigs > 0, coef / np.where(eigs > 0, eigs, 1.0), 0.0),
                           type=2, norm="ortho")
    tune = 0.0
    for b in BINS3:
        v = pinv
        for j, bj in enumerate(b):
            if bj:
                v = np.diff(v, axis=j)
        scale = np.prod([d[j] for j, bj in enumerate(b) if not bj])
        tune = max(tune, scale * np.abs(v).max())
    got = float(tpath.lam_max(ops, problem, PathConfig()))
    np.testing.assert_allclose(got, 5.0 * tune, rtol=1e-6)


def test_mvtv_one_and_mvtv_folds1_match_jax(monkeypatch):
    """mvtv_one (tiled3 route, TILED3_MIN_KNOTS lowered) and mvtv(folds=1,
    n_lambda=4) on 3-D data against the JAX package's exact route:
    objective 2e-5 at tol = 1e-5; the same lambda grid (rtol 1e-5) and
    chosen index."""
    monkeypatch.setattr(admm, "TILED3_MIN_KNOTS", 1)
    m = (6, 8, 10)
    x, y = _data3(m, seed=31)
    jres = japi.mvtv_one(x, y, m=m, lam=LAM, solver_config=JSolverConfig(tol=1e-5))
    res = mvtv_one(x, y, m=m, lam=LAM, solver_config=SolverConfig(tol=1e-5), device="cpu")
    assert res["theta_lattice"].shape == m and res["diagnostics"]["converged"]
    _, _, _, _, _, ops, problem = _setup(x, y, m, None, SolverConfig(), DEFAULT_MESH, "cpu")
    assert admm.solve_route(ops, SolverConfig()) == "tiled3"
    counts, oty = problem.counts.numpy(), problem.oty.numpy()
    deltas = ops.deltas.numpy()
    np.testing.assert_allclose(np.asarray(jres["mesh_spec"].deltas), deltas, rtol=1e-6)
    want = objective3(np.asarray(jres["theta_lattice"]), counts, oty, deltas=deltas)
    got = objective3(res["theta_lattice"], counts, oty, deltas=deltas)
    assert abs(got - want) <= 2e-5 * abs(want), (got, want)

    jm = japi.mvtv(x, y, m=m, n_lambda=4, folds=1, solver_config=JSolverConfig(tol=1e-5),
                   path_config=JPathConfig(n_lambda=4))
    pm = mvtv(x, y, m=m, n_lambda=4, folds=1, device="cpu", solver_config=SolverConfig(tol=1e-5))
    np.testing.assert_allclose(pm.lambdas, np.asarray(jm.lambdas), rtol=1e-5)
    assert pm.lambda_minmse_ind == jm.lambda_minmse_ind
    np.testing.assert_allclose(pm.cv_mses, np.asarray(jm.cv_mses), rtol=1e-4)
    assert pm.theta_lattice.shape == m
    np.testing.assert_array_equal(pm.predict(pm.data), pm.fitted)


def test_cv_folds_on_p3_raise():
    x, y = _data3((4, 4, 6), seed=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mvtv(x, y, m=(4, 4, 6), n_lambda=3, folds=3, device="cpu")


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def test_operators_from_numpy_p3():
    """convert.operators_from_numpy at p = 3 from the JAX fields: the same
    operand values, and the port's own even-axis padded set."""
    for m in ((6, 8, 10), (5, 7, 9)):
        jops = jproblem.build_operators(m, jnp.asarray(DELTAS3), JSolverConfig(), jnp.float32)
        conv = convert.operators_from_numpy(
            binaries=jops.binaries, m=jops.m, scales=jops.scales, deltas=jops.deltas,
            gram_eigs=jops.gram_eigs, dct_mats=jops.dct_mats, dct_halves=jops.dct_halves,
            gram_eigs_packed=jops.gram_eigs_packed, gram_eigs_blocked=jops.gram_eigs_blocked,
            gram_eigs_blocked_lp=jops.gram_eigs_blocked_lp, device="cpu")
        ops = build_operators(m, DELTAS3, SolverConfig(), "cpu")
        assert conv.binaries == ops.binaries and conv.m == m
        np.testing.assert_allclose(conv.scales, ops.scales, rtol=1e-6)
        _close(conv.gram_eigs.numpy(), ops.gram_eigs.numpy(), 1e-6)
        if ops.padded is None:
            assert conv.padded is None
            for g, w in zip(conv.gram_eigs_blocked, ops.gram_eigs_blocked):
                _close(g.numpy(), w.numpy(), 1e-6)
        else:
            assert conv.padded.m == ops.padded.m == (6, 8, 10)
            assert jops.padded is None or jops.padded.m != conv.padded.m


def test_convert_defaults_to_cuda():
    """convert's default device is the API's: "cuda", which raises without
    CUDA (as mvtv_one's does)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-CUDA guard cannot be observed")
    z = np.zeros(M3, np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.problem_from_numpy(counts=z, oty=z, ybar=0.0, flat_idx=np.zeros(1, np.int64),
                                   y=np.zeros(1, np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.state_from_numpy(theta=z, alpha=[z] * 7, u=[z] * 7, rho=1.0)
    jops = jproblem.build_operators(M3, jnp.asarray(DELTAS3), JSolverConfig(), jnp.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.operators_from_numpy(binaries=jops.binaries, m=jops.m, scales=jops.scales,
                                     deltas=jops.deltas, gram_eigs=jops.gram_eigs)
