"""The port's admm_solve against the JAX package's on the CPU, and the
chunk and cap semantics of tests/test_chunk.py.  Objectives are compared,
not theta: on zero-count knots near-null directions amplify 1e-6
arithmetic differences about 40,000x with almost no change in the
objective."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.solver import admm as jadmm
from multivartv_tpu.solver.problem import Problem as JProblem
from multivartv_tpu.solver.problem import build_operators as jbuild_operators
from multivartv_tpu_torch import convert
from multivartv_tpu_torch.config import SolverConfig
from multivartv_tpu_torch.ops import diff
from multivartv_tpu_torch.solver import admm
from multivartv_tpu_torch.solver.problem import build_operators

DELTAS = np.asarray([0.4, 0.9], np.float32)
LAM = 0.08
ALIGNED, ODD = (16, 32), (15, 100)   # JAX pads both to (16, 128); the port pads ODD to (16, 100)


def problems(m, seed=29):
    rng = np.random.RandomState(seed)
    counts = rng.poisson(3, m).astype(np.float32)
    oty = (rng.randn(*m) * counts).astype(np.float32)
    ybar = np.float32(oty.sum() / counts.sum())
    jp = JProblem(counts=jnp.asarray(counts), oty=jnp.asarray(oty), ybar=jnp.asarray(ybar),
                  flat_idx=jnp.zeros((1,), jnp.int32), y=jnp.zeros((1,), jnp.float32))
    tp = convert.problem_from_numpy(counts=counts, oty=oty, ybar=ybar,
                                    flat_idx=np.zeros(1, np.int64), y=np.zeros(1, np.float32),
                                    device="cpu")
    return jp, tp, counts, oty


def objective(theta, counts, oty, lam=LAM):
    """0.5 ||y - O theta||^2 + lam ||D theta||_1 in float64 (y = 0 here, so
    the fidelity is 0.5 <counts, theta^2> - <O'y, theta>)."""
    th = np.asarray(theta, np.float64)
    d0, d1 = (float(v) for v in DELTAS)
    fid = 0.5 * np.sum(counts * th * th) - np.sum(oty * th)
    pen = (np.abs(th[1:, 1:] - th[1:, :-1] - th[:-1, 1:] + th[:-1, :-1]).sum()
           + d0 * np.abs(th[:, 1:] - th[:, :-1]).sum() + d1 * np.abs(th[1:] - th[:-1]).sum())
    return fid + lam * pen


def solve_port(m, tp, **cfg):
    cfg = SolverConfig(**cfg)
    ops = build_operators(m, DELTAS, cfg, "cpu")
    s0 = admm.initial_state(ops, tp, torch.tensor(LAM / 5.0))
    return admm.admm_solve(ops, tp, torch.tensor(LAM), s0, cfg), ops


def solve_jax(m, jp, **cfg):
    cfg = JSolverConfig(**cfg)
    ops = jbuild_operators(m, jnp.asarray(DELTAS), cfg, jnp.float32)
    s0 = jadmm.initial_state(ops, jp, rho0=jnp.float32(LAM / 5.0))
    return jadmm.admm_solve(ops, jp, jnp.float32(LAM), s0, cfg)


@pytest.mark.parametrize("m", [ALIGNED, ODD])
def test_solve_matches_jax_exact_route(m):
    """Kernel route (plain versions on the CPU) and exact route against the
    JAX exact-f32 route (the CPU default): objective gap <= 2e-5
    (test_pad_single.py:118)."""
    jp, tp, counts, oty = problems(m)
    ref = objective(solve_jax(m, jp).theta, counts, oty)
    for use_kernels in (True, False):
        out, _ = solve_port(m, tp, use_kernels=use_kernels)
        assert out.theta.shape == m
        assert admm.solver_diagnostics(out)["converged"]
        assert abs(objective(out.theta, counts, oty) - ref) <= 2e-5 * abs(ref)


@pytest.mark.parametrize("m", [ALIGNED, ODD])
def test_solve_matches_jax_chunked_route(m, monkeypatch):
    """Against JAX's chunked route (admm_iters_2d in interpret mode):
    objective gap <= 1e-3 (test_chunk.py:70)."""
    monkeypatch.setattr(jadmm, "FORCE_FUSED_INTERPRET", True)
    jp, tp, counts, oty = problems(m)
    ref = objective(solve_jax(m, jp, cg_fixed_iters=3).theta, counts, oty)
    out, _ = solve_port(m, tp, cg_fixed_iters=3)
    assert abs(objective(out.theta, counts, oty) - ref) <= 1e-3 * abs(ref)


def test_padded_solve_crops_to_the_true_lattice():
    _, tp, _, _ = problems(ODD)
    cfg = SolverConfig()
    ops = build_operators(ODD, DELTAS, cfg, "cpu")
    assert admm.pad_single_applies(ops, cfg) and ops.padded.m == (16, 100)
    out, _ = solve_port(ODD, tp, max_iters=20)
    assert out.theta.shape == ODD
    for a, w, b in zip(out.alpha, out.u, ops.binaries):
        zero = diff.edge_mask(ODD, b) == 0
        assert torch.all(a[zero] == 0) and torch.all(w[zero] == 0)


@pytest.mark.parametrize("cfg,where", [
    ({}, "chunked"), ({"chunk_iters": 1}, "per_iteration"),
    ({"use_kernels": False}, "exact")])
def test_route_counts_cover_every_iteration(cfg, where):
    """The state counts where each iteration ran; with the bf16 escape off
    (or on the exact route) every iteration runs on one route, apart from
    the < chunk tail before the cap."""
    _, tp, _, _ = problems(ALIGNED)
    out, _ = solve_port(ALIGNED, tp, bf16_residual_escape=False, max_iters=30, **cfg)
    d = admm.solver_diagnostics(out)
    per_iter = d["iterations"] - d["chunked_iterations"] - d["exact_iterations"]
    got = {"chunked": d["chunked_iterations"], "per_iteration": per_iter,
           "exact": d["exact_iterations"]}
    assert d["iterations"] == out.counter > 0 and not d["escaped"]
    assert got[where] >= d["iterations"] - 3
    assert sum(got.values()) == d["iterations"] and min(got.values()) >= 0


def test_escape_is_recorded():
    """A bf16 loop that stalls hands over to the exact route: escaped is
    set and the exact route's iterations are counted (at tol = 1e-9 the
    bf16 loop stalls after 820 iterations on this problem)."""
    _, tp, _, _ = problems(ALIGNED)
    out, _ = solve_port(ALIGNED, tp, tol=1e-9, max_iters=1000)
    d = admm.solver_diagnostics(out)
    assert d["escaped"]
    assert d["chunked_iterations"] >= admm.ESCAPE_STALL_ITERS and d["exact_iterations"] > 0
    assert d["chunked_iterations"] + d["exact_iterations"] == d["iterations"]


def test_chunked_cap_is_exact():
    """max_iters is a hard cap: the chunked route stops at exactly max_iters
    (test_chunk.py:78-88)."""
    _, tp, _, _ = problems(ALIGNED)
    out, _ = solve_port(ALIGNED, tp, cg_fixed_iters=3, chunk_iters=4, max_iters=10, tol=1e-12)
    assert out.counter == 10


def test_fixed_iterations_honor_chunk():
    """Cadence 4 over 7 iterations == one 7-iteration chunk (test_chunk.py:91-105)."""
    _, tp, _, _ = problems(ALIGNED)
    outs = []
    for k in (4, 7):
        cfg = SolverConfig(cg_fixed_iters=3, chunk_iters=k)
        ops = build_operators(ALIGNED, DELTAS, cfg, "cpu")
        s0 = admm.initial_state(ops, tp, torch.tensor(LAM / 5.0))
        outs.append(admm.admm_fixed_iterations(ops, tp, torch.tensor(LAM), s0, cfg, 7))
    assert outs[0].counter == outs[1].counter == 7
    np.testing.assert_allclose(outs[0].theta.numpy(), outs[1].theta.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(outs[0].rho), float(outs[1].rho), rtol=1e-6)


def test_fused_chunk_poisons_theta_on_divergence():
    """A non-finite CG residual poisons theta and the norms, and the
    diagnostics report divergence (test_chunk.py:116-130)."""
    _, tp, _, _ = problems(ALIGNED)
    oty = tp.oty.clone()
    oty[0, 0] = float("nan")
    bad = dataclasses.replace(tp, oty=oty)
    cfg = SolverConfig(cg_fixed_iters=3, chunk_iters=4)
    ops = build_operators(ALIGNED, DELTAS, cfg, "cpu")
    s0 = admm.initial_state(ops, bad, torch.tensor(LAM / 5.0))
    out = admm.admm_fused_chunk(ops, bad, torch.tensor(LAM), s0, cfg, 4)
    assert not torch.all(torch.isfinite(out.theta))
    assert not torch.isfinite(out.primal_norm)
    assert admm.solver_diagnostics(out)["diverged"]
    # and the solve stops at the first chunk instead of spinning to the cap
    assert admm.admm_solve(ops, bad, torch.tensor(LAM), s0, cfg).counter == 4


def test_kernel_route_gates():
    cfg = SolverConfig()
    assert admm.kernel_route(build_operators((16, 32), DELTAS, cfg, "cpu"), cfg)
    assert not admm.kernel_route(build_operators((16, 32), DELTAS, cfg, "cpu"),
                                 SolverConfig(use_kernels=False))
    # p = 1 runs the "tridiag" route: T1, the exact cyclic-reduction x-update
    assert admm.kernel_route(build_operators((16,), [0.5], cfg, "cpu"), cfg)
    assert admm.solve_route(build_operators((16,), [0.5], cfg, "cpu"), cfg) == "tridiag"
    # p = 3 takes the kernel route (tests/test_torch_tiled3d.py), except a
    # lattice that pads more than 4x, which the JAX package solves exactly.
    assert admm.kernel_route(build_operators((4, 4, 4), [0.5, 0.5, 0.5], cfg, "cpu"), cfg)
    assert not admm.kernel_route(build_operators((1, 1, 7), [0.5, 0.5, 0.5], cfg, "cpu"), cfg)
    # 2-D lattices take the JAX package's route gates: (2, 2048) and
    # (4096, 256) are whole-lattice problems, the second without dense DCT
    # matrices, so its x-update is the spectral CG with a plain r0 (the JAX
    # package's route there; tests/test_torch_tiled.py holds the table).
    assert admm.lattice_route((2, 2048)) == admm.lattice_route((4096, 256)) == "whole"
    # The reduced block set runs the no-kernel spectral route on even axes
    # and the exact route on odd ones (the JAX package's XLA path and its
    # plain fallthrough); it pads under Boyd stopping, as in the JAX package.
    reduced = SolverConfig(include_full_mixed=False)
    assert admm.solve_route(build_operators((16, 32), DELTAS, reduced, "cpu"),
                            reduced) == "spectral2"
    assert admm.solve_route(build_operators((15, 33), DELTAS, reduced, "cpu"),
                            reduced) == "spectral2"
    theta_inf = SolverConfig(include_full_mixed=False, stop_rule="theta_inf")
    assert not admm.kernel_route(build_operators((15, 33), DELTAS, theta_inf, "cpu"),
                                 theta_inf)
    assert not admm.pad_single_applies(build_operators((16, 32), DELTAS, cfg, "cpu"), cfg)


def test_auto_chunk_default():
    assert SolverConfig().chunk_iters is None
    assert admm.resolve_chunk(SolverConfig()) == admm.AUTO_CHUNK == 4
    assert admm.resolve_chunk(SolverConfig(chunk_iters=1)) == 1
    assert admm.resolve_chunk(SolverConfig(chunk_iters=9)) == 9


def test_objective_matches_jax():
    jp, tp, counts, oty = problems(ALIGNED)
    theta = np.random.RandomState(1).randn(*ALIGNED).astype(np.float32)
    ops = build_operators(ALIGNED, DELTAS, SolverConfig(), "cpu")
    jops = jbuild_operators(ALIGNED, jnp.asarray(DELTAS), JSolverConfig(), jnp.float32)
    fid, pen = admm.objective(ops, tp, torch.as_tensor(theta))
    jfid, jpen = jadmm.objective(jops, jp, jnp.asarray(theta))
    np.testing.assert_allclose([float(fid), float(pen)], [float(jfid), float(jpen)], rtol=1e-5)
    np.testing.assert_allclose(float(fid + LAM * pen), objective(theta, counts, oty),
                               rtol=1e-5)


def test_state_from_jax_matches_initial_state():
    """convert.state_from_numpy carries the JAX initial state over exactly."""
    jp, tp, _, _ = problems(ODD)
    jops = jbuild_operators(ODD, jnp.asarray(DELTAS), JSolverConfig(), jnp.float32)
    js = jadmm.initial_state(jops, jp, rho0=jnp.float32(LAM / 5.0))
    got = convert.state_from_numpy(
        theta=js.theta, alpha=js.alpha, u=js.u, rho=js.rho, counter=js.counter,
        primal_norm=js.primal_norm, dual_norm=js.dual_norm, eps_primal=js.eps_primal,
        eps_dual=js.eps_dual, cg_iters=js.cg_iters, u_scale=js.u_scale, device="cpu")
    ops = build_operators(ODD, DELTAS, SolverConfig(), "cpu")
    want = admm.initial_state(ops, tp, torch.tensor(LAM / 5.0))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert (x == y) if isinstance(x, int) or x is None else torch.equal(x, y), f.name
