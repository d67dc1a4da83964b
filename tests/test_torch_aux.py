"""The port's checkpoints, resumable lambda path, mse and tv_penalty
against the JAX package on the CPU (JAX: tests/test_aux.py).

The problem is the JAX package's own (tests/test_admm.py::make_2d_problem,
n = 250 on 5 x 5), handed to the port as arrays, so both packages solve
the same binned problem on the same lambda grid."""

import json
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from multivartv_tpu.config import PathConfig as JPathConfig
from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.ops import diff as jdiff
from multivartv_tpu.solver import admm as jadmm
from multivartv_tpu.solver import path as jpath
from multivartv_tpu.solver.problem import build_operators as jbuild_operators
from multivartv_tpu.solver.problem import build_problem as jbuild_problem
from multivartv_tpu.utils import checkpoint as jckpt
from multivartv_tpu.utils import metrics as jmetrics
from multivartv_tpu_torch import convert
from multivartv_tpu_torch.config import PathConfig, SolverConfig
from multivartv_tpu_torch.ops import diff
from multivartv_tpu_torch.solver import admm
from multivartv_tpu_torch.solver import path as tpath
from multivartv_tpu_torch.solver.problem import build_operators
from multivartv_tpu_torch.utils import checkpoint as ckpt
from multivartv_tpu_torch.utils import mse
from test_admm import make_2d_problem

EXACT = SolverConfig(use_kernels=False)
N_LAMBDA, EVERY, RESUME = 8, 3, 5


def _setup(n=250, m=(5, 5)):
    """(JAX operators, JAX problem, port operators, port problem, lambdas)."""
    data, y, _, spec = make_2d_problem(n=n, m=m)
    jops = jbuild_operators(spec.m, spec.deltas, JSolverConfig())
    jpr = jbuild_problem(spec, jnp.asarray(data, jnp.float32), jnp.asarray(y, jnp.float32))
    ops = build_operators(spec.m, np.array(spec.deltas), SolverConfig(), "cpu")
    pr = convert.problem_from_numpy(counts=np.asarray(jpr.counts), oty=np.asarray(jpr.oty),
                                    ybar=np.asarray(jpr.ybar), flat_idx=np.asarray(jpr.flat_idx),
                                    y=np.asarray(jpr.y), device="cpu")
    pcfg = JPathConfig(n_lambda=N_LAMBDA, store="mse")
    lambdas = np.asarray(jpath.create_lambdas(jpath.lam_max(jops, jpr, pcfg, spec.deltas), pcfg))
    return jops, jpr, ops, pr, lambdas


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _repoint(directory, index):
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump({"lambda_index": index, "file": f"path_state_{index:05d}.npz", "meta": {}}, f)


def test_checkpoint_roundtrip(tmp_path, setup):
    """save/load keeps theta and rho, stores u scale-free (restored u =
    u_scale u, u_scale 1), resets the counters and drops the carries; the
    JAX package loads the same directory to the same arrays (test_aux.py:
    27-43)."""
    jops, jpr, ops, pr, _ = setup
    s0 = admm.initial_state(ops, pr, torch.tensor(0.1))
    state = admm.admm_solve(ops, pr, torch.tensor(0.2), s0, SolverConfig(chunk_iters=1))
    state = admm._seed_adjoints(ops, state)
    ckpt.save_path_state(str(tmp_path), state, 7, meta={"note": "test"})
    restored, idx = ckpt.load_path_state(str(tmp_path), admm.initial_state(ops, pr, 0.1))
    assert idx == 7 and ckpt.latest_checkpoint(str(tmp_path))[0] == 7
    assert torch.equal(restored.theta, state.theta)
    assert float(restored.rho) == float(state.rho)
    for a, b in zip(restored.u, state.u):
        np.testing.assert_allclose(a.numpy(), float(state.u_scale) * b.numpy())
    assert float(restored.u_scale) == 1.0 and restored.counter == 0 and restored.cg_iters == 0
    assert restored.dta is None and restored.dtu is None and not restored.escaped
    jstate, jidx = jckpt.load_path_state(str(tmp_path),
                                         jadmm.initial_state(jops, jpr, jnp.float32(0.1)))
    assert jidx == 7
    np.testing.assert_array_equal(np.asarray(jstate.theta), state.theta.numpy())
    for a, b in zip(jstate.u, restored.u):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("case", ["whole", "resumed", "covered", "no_results"])
def test_checkpointed_path_resumes(tmp_path, setup, case):
    """The four cases of test_aux.py:46-102 in the port: the checkpointed
    path equals the plain one; resumed after lambda 5 (the manifest pointed
    back) it returns the whole merged path; a checkpoint that covers every
    lambda returns the saved path; without saved chunk results it returns
    the remaining lambdas with a warning."""
    _, _, ops, pr, lambdas = setup
    cfg, pcfg = SolverConfig(), PathConfig(n_lambda=N_LAMBDA, store="mse")
    lam = torch.as_tensor(lambdas)
    full = tpath.solve_path(ops, pr, lam, cfg, pcfg)
    d = str(tmp_path / "ck")

    def run():
        return tpath.solve_path_checkpointed(ops, pr, lam, cfg, pcfg, d, checkpoint_every=EVERY)

    res1 = run()
    assert res1.train_mse.shape == (N_LAMBDA,)
    np.testing.assert_allclose(res1.train_mse.numpy(), full.train_mse.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert ckpt.latest_checkpoint(d)[0] == N_LAMBDA - 1
    if case == "whole":
        assert torch.equal(res1.iters, full.iters)
        return
    _repoint(d, RESUME)
    res2 = run()
    assert res2.train_mse.shape == (N_LAMBDA,) and res2.lambdas.shape == (N_LAMBDA,)
    np.testing.assert_allclose(res2.train_mse[:RESUME + 1].numpy(),
                               res1.train_mse[:RESUME + 1].numpy(), rtol=1e-6)
    np.testing.assert_allclose(res2.train_mse[RESUME + 1:].numpy(),
                               full.train_mse[RESUME + 1:].numpy(), rtol=1e-3, atol=1e-5)
    if case == "resumed":
        return
    if case == "covered":
        res3 = run()
        assert res3.train_mse.shape == (N_LAMBDA,)
        np.testing.assert_allclose(res3.train_mse.numpy(), res2.train_mse.numpy(), rtol=1e-6)
        return
    for name in os.listdir(d):
        if name.startswith("path_res_"):
            os.remove(os.path.join(d, name))
    _repoint(d, RESUME)
    res4 = run()
    assert res4.train_mse.shape == (N_LAMBDA - RESUME - 1,)
    assert res4.lambdas.shape == (N_LAMBDA - RESUME - 1,)
    with pytest.raises(ValueError):
        run()     # covered, and no saved results to merge


def test_mid_chunk_resume_takes_the_chunk_up_to_the_manifest(tmp_path, setup):
    """A manifest pointed at a lambda inside a saved chunk (a run stopped
    there): the merged path takes the saved results up to that lambda and
    the new ones after it, each lambda once."""
    _, _, ops, pr, lambdas = setup
    cfg, pcfg = SolverConfig(), PathConfig(n_lambda=N_LAMBDA, store="mse")
    lam = torch.as_tensor(lambdas)
    d = str(tmp_path)
    first = tpath.solve_path_checkpointed(ops, pr, lam, cfg, pcfg, d, checkpoint_every=4)
    head = tpath.solve_path(ops, pr, lam[:RESUME + 1], cfg, pcfg)
    ckpt.save_path_state(d, head.final_state, RESUME)
    res = tpath.solve_path_checkpointed(ops, pr, lam, cfg, pcfg, d, checkpoint_every=4)
    assert res.train_mse.shape == (N_LAMBDA,) and res.iters.shape == (N_LAMBDA,)
    np.testing.assert_allclose(res.train_mse.numpy(), first.train_mse.numpy(), rtol=1e-4)
    assert len(ckpt.load_path_results(d, RESUME + 1)) == 2


def test_jax_checkpoint_resumes_in_the_port(tmp_path, setup):
    """A directory written by the JAX package's solve_path_checkpointed,
    its manifest pointed back at lambda 5, resumed by the port on the exact
    route (the JAX package's CPU route): the saved lambdas come back as JAX
    wrote them, and the whole path's train_mse lies within 1e-4 of JAX's
    uninterrupted path."""
    jops, jpr, ops, pr, lambdas = setup
    jcfg, jpcfg = JSolverConfig(), JPathConfig(n_lambda=N_LAMBDA, store="mse")
    jlam = jnp.asarray(lambdas)
    jfull = np.asarray(jpath.solve_path(jops, jpr, jlam, jcfg, jpcfg).train_mse)
    d = str(tmp_path)
    jres = jpath.solve_path_checkpointed(jops, jpr, jlam, jcfg, jpcfg, d,
                                         checkpoint_every=EVERY)
    _repoint(d, RESUME)
    res = tpath.solve_path_checkpointed(ops, pr, torch.as_tensor(lambdas), EXACT,
                                        PathConfig(n_lambda=N_LAMBDA, store="mse"), d,
                                        checkpoint_every=EVERY)
    assert res.train_mse.shape == (N_LAMBDA,)
    np.testing.assert_array_equal(res.train_mse[:RESUME + 1].numpy(),
                                  np.asarray(jres.train_mse)[:RESUME + 1])
    np.testing.assert_allclose(res.train_mse.numpy(), jfull, rtol=1e-4)


def test_no_results_logs_a_warning(tmp_path, setup, caplog):
    """The fallback of a directory without saved chunk results is logged."""
    _, _, ops, pr, lambdas = setup
    lam = torch.as_tensor(lambdas)
    cfg, pcfg = SolverConfig(), PathConfig(n_lambda=N_LAMBDA, store="mse")
    head = tpath.solve_path(ops, pr, lam[:RESUME + 1], cfg, pcfg)
    ckpt.save_path_state(str(tmp_path), head.final_state, RESUME)
    logger = logging.getLogger("multivartv_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        res = tpath.solve_path_checkpointed(ops, pr, lam, cfg, pcfg, str(tmp_path),
                                            checkpoint_every=EVERY)
    finally:
        logger.removeHandler(caplog.handler)
    assert res.train_mse.shape == (N_LAMBDA - RESUME - 1,)
    assert any("no saved chunk results" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("shape", [(250,), (10, 25)])
def test_mse_matches_jax(shape):
    rng = np.random.RandomState(3)
    fits = rng.randn(*shape).astype(np.float32)
    y = rng.randn(int(np.prod(shape)))
    want = float(jmetrics.mse(fits, y))
    np.testing.assert_allclose(float(mse(torch.as_tensor(fits), y)), want, rtol=1e-6)
    np.testing.assert_allclose(float(mse(fits, y)), want, rtol=1e-6)


@pytest.mark.parametrize("m,full", [((6, 8), True), ((6, 8), False), ((4, 5, 6), True)])
def test_tv_penalty_matches_jax(m, full):
    """||D theta||_1 on every block of the full or reduced set against the
    JAX package's tv_penalty (ops/diff.py:246-249) and a float64 sum."""
    rng = np.random.RandomState(11)
    deltas = rng.uniform(0.2, 1.0, len(m)).astype(np.float32)
    theta = rng.randn(*m).astype(np.float32)
    jb = jdiff.fd_binaries(len(m), full)
    jscales = jdiff.delta_scales(jb, jnp.asarray(deltas))
    want = float(jdiff.tv_penalty(jnp.asarray(theta), jb, jscales))
    binaries = diff.fd_binaries(len(m), full)
    scales = diff.delta_scales(binaries, torch.as_tensor(deltas))
    got = diff.tv_penalty(torch.as_tensor(theta), binaries, scales)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    got64 = diff.tv_penalty(torch.as_tensor(theta, dtype=torch.float64), binaries, scales)
    np.testing.assert_allclose(float(got64), want, rtol=1e-6)


def test_profiling_hooks(tmp_path):
    """trace writes a Chrome trace whose profiler saw the enclosed work;
    measure_iterations_per_s runs the warm-up, then times iters iterations;
    StepTimer accumulates named phases (the JAX package's utils/profiling.py
    on torch)."""
    from multivartv_tpu_torch.utils import profiling
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace.json").exists()
    assert any("mm" in e.key for e in prof.key_averages())
    calls = []

    def run_fixed(state, k):
        calls.append(k)
        return state + k

    rate = profiling.measure_iterations_per_s(run_fixed, 0, warmup=3, iters=7)
    assert calls == [3, 7] and rate > 0
    timer = profiling.StepTimer()
    for name in ("a", "b", "a"):
        with timer.phase(name):
            pass
    assert set(timer.totals) == {"a", "b"} and "a" in timer.report()


def test_solve_census_counts_lattice_tensors(setup):
    """solve_census takes lattice_tensors as each ADMM solve starts (only
    the first under first_only) and puts admm_solve back: a tensor of the
    lattice's trailing shape made between two solves adds one to the count
    and its bytes to the storages'; beside them the solve's eigenvalue sets
    as shares of the whole lattice's (a single card's: whole)."""
    from multivartv_tpu_torch.utils import profiling
    _, _, ops, pr, lambdas = setup
    lam = torch.tensor(lambdas[2], dtype=torch.float32)
    state = admm.initial_state(ops, pr, lam / 5)
    cfg, solve = SolverConfig(max_iters=2), admm.admm_solve
    with profiling.solve_census((5, 5)) as (seen, seconds):
        admm.admm_solve(ops, pr, lam, state, cfg)
        extra = torch.zeros(3, 5, 5)
        admm.admm_solve(ops, pr, lam, state, cfg)
    with profiling.solve_census((5, 5), first_only=True) as (first, _):
        for _ in range(2):
            admm.admm_solve(ops, pr, lam, state, cfg)
    assert admm.admm_solve is solve
    assert len(seen) == 2 and len(first) == 1 and seconds[0] > 0
    assert seen[1][:2] == (seen[0][0] + 1, seen[0][1] + extra.numel() * extra.element_size())
    assert first[0][0] == seen[1][0]
    assert seen[1][2] == profiling.operand_shares(ops) and seen[1][2]["gram_eigs"] == 1.0
