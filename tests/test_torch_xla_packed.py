"""SolverConfig.xla_packed and spectral_cg in the port against the JAX
package on the CPU.

xla_packed=False is the exact float32 tolerance-driven DCT-PCG with the
route's kernels kept on; spectral_cg=False the bf16 fixed-step PCG in the
natural domain (JAX xupdate.py:489-527).  The JAX side runs its packed XLA
route as tests/test_xla_packed.py does (``FORCE_XLA_PACKED``) and, on the
2-D tiled route, its tiled kernels in interpret mode as
tests/test_torch_tiled.py does (``FORCE_FUSED_INTERPRET``, 8-row panels);
the port reaches its tiled route at (32, 128) with ``admm.WHOLE_MAX_KNOTS``
lowered.  Objectives are compared, not theta (tests/test_torch_admm.py)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.ops import pallas_kernels as pk
from multivartv_tpu.solver import admm as jadmm
from multivartv_tpu.solver import problem as jproblem
from multivartv_tpu.solver import xupdate as jxupdate
from multivartv_tpu.solver.problem import Problem as JProblem
from multivartv_tpu_torch import mvtv_one
from multivartv_tpu_torch.api import _setup
from multivartv_tpu_torch.config import DEFAULT_MESH, SolverConfig
from multivartv_tpu_torch.ops import diff
from multivartv_tpu_torch.ops import kernels as K
from multivartv_tpu_torch.solver import admm, xupdate
from multivartv_tpu_torch.solver import problem as tproblem

M = (32, 128)
LAM = 0.08
ARMS = {"xla_packed=False": {"xla_packed": False},
        "spectral_cg=False": {"spectral_cg": False}}
# Relative objective gates against the JAX package's same config: the
# exact float32 arm agrees to float32 round-off in its sums; the bf16 arm
# at the repo's matched-objective gate (tests/test_pad_single.py:118).
ARM_TOL = {"xla_packed=False": 1e-6, "spectral_cg=False": 2e-5}


@pytest.fixture
def tiled_here(monkeypatch):
    """Both packages on their 2-D tiled route at (32, 128), the JAX side
    with 8-row panels in interpret mode and its packed XLA x-update."""
    monkeypatch.setattr(admm, "WHOLE_MAX_KNOTS", 1024)
    monkeypatch.setattr(jadmm, "FORCE_FUSED_INTERPRET", True)
    monkeypatch.setattr(jxupdate, "FORCE_XLA_PACKED", True)
    monkeypatch.setattr(pk, "_tile_rows", lambda m: 8)
    monkeypatch.setattr(jproblem, "QUARTER_MIN_AXIS", 4)
    monkeypatch.setattr(tproblem, "QUARTER_MIN_AXIS", 4)
    return monkeypatch


def _data(m, seed=29):
    """About 3 samples per knot of the lattice m."""
    rng = np.random.RandomState(seed)
    n = 3 * int(np.prod(m))
    x = rng.uniform(-1, 1, (n, len(m)))
    return x, np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.3 * rng.randn(n)


def _objective(ops, counts, oty, theta, lam=LAM):
    """0.5 <counts, theta^2> - <O'y, theta> + lam ||D theta||_1 in float64
    (the objective less 0.5 ||y||^2) through the port's operators."""
    th = np.asarray(theta, np.float64)
    fid = 0.5 * np.sum(counts * th * th) - np.sum(oty * th)
    return fid + lam * float(diff.tv_penalty(torch.as_tensor(th), ops.binaries, ops.scales))


def _jax_solve(counts, oty, deltas, m, lam, **arm):
    """JAX's admm_solve (unjitted, as test_pallas.py runs it) from
    mvtv_one's initial state."""
    jp = JProblem(counts=jnp.asarray(counts), oty=jnp.asarray(oty),
                  ybar=jnp.float32(oty.sum() / counts.sum()),
                  flat_idx=jnp.zeros((1,), jnp.int32), y=jnp.zeros((1,), jnp.float32))
    cfg = JSolverConfig(chunk_iters=1, **arm)
    ops = jproblem.build_operators(m, jnp.asarray(deltas), cfg, jnp.float32)
    s0 = jadmm.initial_state(ops, jp, rho0=jnp.float32(lam))
    return jadmm.admm_solve(ops, jp, jnp.float32(lam), s0, cfg), ops, cfg


@pytest.mark.parametrize("arm", list(ARMS))
def test_tiled_arm_matches_jax(tiled_here, arm):
    """mvtv_one with each arm on the 2-D tiled route (B8 around the arm's
    x-update, B10 its matvec) against JAX's admm_solve with the same
    SolverConfig on its tiled route, the same binned problem: objective
    within ARM_TOL, iteration counts within 2, both converged."""
    x, y = _data(M)
    cfg = SolverConfig(**ARMS[arm])
    _, _, _, _, _, ops, problem = _setup(x, y, M, None, cfg, DEFAULT_MESH, "cpu")
    assert admm.solve_route(ops, cfg) == "tiled"
    counts, oty = problem.counts.numpy(), problem.oty.numpy()
    jout, jops, jcfg = _jax_solve(counts, oty, ops.deltas.numpy(), M, LAM, **ARMS[arm])
    assert jxupdate._xla_packed_applies(jops, jcfg) == (arm == "spectral_cg=False")
    ref = _objective(ops, counts, oty, jout.theta)

    res = mvtv_one(x, y, m=M, lam=LAM, solver_config=cfg, device="cpu")
    assert res["diagnostics"]["converged"] and bool(jout.primal_norm <= jout.eps_primal)
    got = _objective(ops, counts, oty, res["theta_lattice"])
    assert abs(got - ref) <= ARM_TOL[arm] * abs(ref), (got, ref)
    assert abs(res["counter"] - int(jout.counter)) <= 2


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("m", [(8, 6, 10), (16, 24)])
def test_spectral_route_arm_matches_jax(monkeypatch, arm, m):
    """The no-kernel spectral routes (spectral3 at p = 3; at p = 2 the whole
    route without dense DCT matrices, e.g. (4096, 256), reached here by
    removing them on both sides) under each arm against JAX's packed XLA
    route with the same SolverConfig (tests/test_xla_packed.py's arms)."""
    monkeypatch.setattr(jxupdate, "FORCE_XLA_PACKED", True)
    x, y = _data(m, seed=31)
    cfg = SolverConfig(chunk_iters=1, **ARMS[arm])
    _, _, _, _, _, ops, problem = _setup(x, y, m, None, cfg, DEFAULT_MESH, "cpu")
    counts, oty = problem.counts.numpy(), problem.oty.numpy()
    jp = JProblem(counts=jnp.asarray(counts), oty=jnp.asarray(oty),
                  ybar=jnp.float32(float(problem.ybar)), flat_idx=jnp.zeros((1,), jnp.int32),
                  y=jnp.zeros((1,), jnp.float32))
    jcfg = JSolverConfig(chunk_iters=1, **ARMS[arm])
    jops = jproblem.build_operators(m, jnp.asarray(ops.deltas.numpy()), jcfg, jnp.float32)
    if len(m) == 2:
        monkeypatch.setattr(admm, "WHOLE_MAX_MAT_BYTES", 0)
        ops = dataclasses.replace(ops, dct_mats=None, dct_mats_lp=None)
        jops = dataclasses.replace(jops, dct_mats=None)
        assert admm.solve_route(ops, cfg) == "whole"
        assert xupdate.whole_xupdate(ops, cfg, False) == {
            "xla_packed=False": "pcg", "spectral_cg=False": "natural"}[arm]
    else:
        assert admm.solve_route(ops, cfg) == "spectral3"
    lam = torch.tensor(LAM)
    out = admm.admm_solve(ops, problem, lam, admm.initial_state(ops, problem, lam), cfg)
    jout = jadmm.admm_solve(jops, jp, jnp.float32(LAM),
                            jadmm.initial_state(jops, jp, rho0=jnp.float32(LAM)), jcfg)
    ref = _objective(ops, counts, oty, jout.theta)
    got = _objective(ops, counts, oty, out.theta.numpy())
    assert admm.solver_diagnostics(out)["converged"]
    assert abs(got - ref) <= ARM_TOL[arm] * abs(ref), (got, ref)


@pytest.mark.parametrize("arm", ["default"] + list(ARMS))
def test_tiled_route_launches_and_layout(tiled_here, arm):
    """Per tiled iteration: B8 once; B9 once under the spectral CG and never
    under the other arms, which form b from the carries and take B10 as
    their matvec (once for r0 and once per CG step); counts go to the
    spectral layout only where the spectral CG runs (JAX
    admm.py:279-282)."""
    x, y = _data(M, seed=5)
    cfg = SolverConfig(**ARMS.get(arm, {}))
    _, _, _, _, _, ops, problem = _setup(x, y, M, None, cfg, DEFAULT_MESH, "cpu")
    calls = {}

    def spy(name, f):
        def counted(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return f(*a, **kw)
        return counted

    for name in ("dual_update_tiled_2d", "gram_residual_tiled_2d", "gram_matvec_tiled_2d"):
        tiled_here.setattr(K, name, spy(name, getattr(K, name)))
    tiled_here.setattr(admm, "counts_to_layout", spy("layout", admm.counts_to_layout))
    lam = torch.tensor(LAM)
    n = 5
    s0 = admm.initial_state(ops, problem, lam)
    out = admm.admm_fixed_iterations(ops, problem, lam, s0, cfg, n)
    assert calls["dual_update_tiled_2d"] == n
    steps = out.cg_iters
    if arm == "default":
        assert calls["gram_residual_tiled_2d"] == n and calls["layout"] == 1
        assert "gram_matvec_tiled_2d" not in calls and steps == 3 * n
    else:
        assert "gram_residual_tiled_2d" not in calls and "layout" not in calls
        assert calls["gram_matvec_tiled_2d"] == steps + n
        assert steps == 3 * n if arm == "spectral_cg=False" else steps > n


@pytest.mark.parametrize("m,arm,applies", [
    ((16, 24), "default", True), ((16, 24), "spectral_cg=False", True),
    ((16, 24), "xla_packed=False", False), ((15, 9), "default", False),
    ((8, 6, 10), "default", True), ((8, 6, 10), "xla_packed=False", False)])
def test_xla_packed_applies_matches_jax(monkeypatch, m, arm, applies):
    """xupdate.xla_packed_applies is JAX's _xla_packed_applies on a TPU
    (FORCE_XLA_PACKED here), also for jacobi_pcg (never)."""
    monkeypatch.setattr(jxupdate, "FORCE_XLA_PACKED", True)
    deltas = np.linspace(0.4, 0.9, len(m)).astype(np.float32)
    for extra in ({}, {"x_solver": "jacobi_pcg"}):
        cfg = SolverConfig(**ARMS.get(arm, {}), **extra)
        jcfg = JSolverConfig(**ARMS.get(arm, {}), **extra)
        ops = tproblem.build_operators(m, torch.as_tensor(deltas), cfg, "cpu")
        jops = jproblem.build_operators(m, jnp.asarray(deltas), jcfg, jnp.float32)
        want = applies and not extra
        assert xupdate.xla_packed_applies(ops, cfg) == jxupdate._xla_packed_applies(jops, jcfg)
        assert xupdate.xla_packed_applies(ops, cfg) == want


@pytest.mark.parametrize("route_m,arm,armed", [
    ((32, 128), "default", True), ((32, 128), "spectral_cg=False", True),
    ((32, 128), "xla_packed=False", False), ((16, 24), "xla_packed=False", True),
    ((16, 24), "default", True)])
def test_bf16_escape_gate(monkeypatch, route_m, arm, armed):
    """The bf16 escape is armed where the x-update runs bf16 transforms
    (JAX admm.py:537-555): on the tiled route under the spectral CG and
    spectral_cg=False, not under xla_packed=False (the exact float32 PCG);
    on the whole route by its one-kernel x-update whatever xla_packed
    says."""
    monkeypatch.setattr(admm, "WHOLE_MAX_KNOTS", 1024)
    cfg = SolverConfig(**ARMS.get(arm, {}))
    deltas = torch.tensor([0.4, 0.9])
    ops = tproblem.build_operators(route_m, deltas, cfg, "cpu")
    route = admm.solve_route(ops, cfg)
    assert route == ("tiled" if route_m == (32, 128) else "whole")
    assert admm._bf16_escape_applies(ops, cfg, route) == armed
    assert not admm._bf16_escape_applies(ops, dataclasses.replace(
        cfg, bf16_residual_escape=False), route)


@pytest.mark.parametrize("arm", list(ARMS))
def test_entry_points_accept_the_arms(arm):
    """mvtv, mvtv_one, solve_path and mvtv_sharded (a group of one) take
    each arm.  On the whole route (8 x 8) the kernels B3-B7 do not read the
    switches, so mvtv's and mvtv_one's results equal the default config's.
    The row slabs take the arm's x-update as the tiled routes do (the
    spectral CG across ranks by default, _solve_natural under
    spectral_cg=False, _solve_plain under xla_packed=False; every x-update
    of the sharded fit on the slabs), and fit to the same chosen index."""
    from multivartv_tpu_torch import mvtv
    from multivartv_tpu_torch.config import PathConfig
    from multivartv_tpu_torch.parallel import fit
    from multivartv_tpu_torch.solver import path
    x, y = _data((8, 8), seed=3)
    cfgs = {name: SolverConfig(**extra) for name, extra in (("default", {}), (arm, ARMS[arm]))}
    names = {"default": "_solve_spectral_sharded", "spectral_cg=False": "_solve_natural",
             "xla_packed=False": "_solve_plain"}
    fits, calls = {}, {}
    for name, c in cfgs.items():
        seen = calls.setdefault(name, set())
        with pytest.MonkeyPatch.context() as mp:
            for f in names.values():
                def spy(ops, *a, _f=getattr(xupdate, f), _n=f, **k):
                    seen.add((_n, ops.slab is not None))
                    return _f(ops, *a, **k)
                mp.setattr(xupdate, f, spy)
            sharded = fit.mvtv_sharded(x, y, m=(8, 8), n_lambda=3, folds=1, solver_config=c,
                                       device="cpu")
        fits[name] = (mvtv(x, y, m=(8, 8), n_lambda=3, folds=2, solver_config=c, device="cpu"),
                      mvtv_one(x, y, m=(8, 8), lam=LAM, solver_config=c, device="cpu"), sharded)
    (m0, o0, s0), (m1, o1, s1) = fits["default"], fits[arm]
    np.testing.assert_array_equal(m1.cv_mses, m0.cv_mses)
    np.testing.assert_array_equal(o1["theta_lattice"], o0["theta_lattice"])
    assert calls["default"] == {(names["default"], True)}
    assert calls[arm] == {(names[arm], True)}
    assert s1.lambda_minmse_ind == s0.lambda_minmse_ind
    assert np.all(np.isfinite(s1.theta_lattice)) and s1.solver_config.tiled_shard_key
    _, _, _, _, _, ops, problem = _setup(x, y, (8, 8), None, cfgs[arm], DEFAULT_MESH, "cpu")
    lams = torch.tensor([0.5, LAM])
    p0, p1 = (path.solve_path(ops, problem, lams, c, PathConfig(n_lambda=2))
              for c in cfgs.values())
    assert torch.equal(p0.train_mse, p1.train_mse)
