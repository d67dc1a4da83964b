"""The shard route's x-update arms against the JAX package's TPU x-update,
on the CPU.

mvtv_sharded's default x-update is the spectral-correction CG across ranks
(multivartv_tpu_torch/parallel/spectral.py), as the JAX package's sharded
fit runs it on a TPU; SolverConfig(spectral_cg=False) runs the
natural-domain bf16 PCG.  The JAX side is forced onto that x-update off
the TPU (``xupdate.FORCE_XLA_PACKED``, as tests/test_torch_p4.py does;
the jit caches cleared around it) and runs on a (1, W, 1) mesh of W virtual
CPU devices; the port's ranks are W gloo processes
(tests/torch_shard_ranks.py), started together at the module's first test.
The layout gates (``problem.QUARTER_MIN_AXIS``, ``xupdate.BLOCKED_MIN_HALF``)
are lowered on both sides so that each of the quartered, blocked and packed
layouts runs, and the lattices are ones the JAX package does not pad under
its forced route (a padded lattice would be more than 4x the true one) and
whose eigenvalue blocks' axis 0 it can shard over W devices (16 x 8 x 8
blocked on 4: blocks of 8 x 4 x 4).
Each solve is capped at CAP iterations on both sides, as in
tests/test_torch_sharded_fit.py, and the fits are compared on the lambda
grid (1e-5), the CV MSEs (1e-4), the chosen index and the objective at it
(1e-5 relative).  Then a slab-level check: the sharded x-update on 1, 2 and
4 ranks against the single card's ``_solve_tiled`` on the same inputs, and
``xla_packed=False`` on the slabs equal, bit for bit, to the exact PCG
that the shard route ran before the spectral arm (the same x-update with
the folded halves removed)."""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import torch_shard_ranks as ranks_lib
from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.parallel import fit as jfit
from multivartv_tpu.parallel.sharding import make_device_mesh as jmesh
from multivartv_tpu.solver import cv as jcv
from multivartv_tpu.solver import problem as jproblem
from multivartv_tpu.solver import xupdate as jxupdate

CAP = 30          # iterations per solve on both sides
N_LAMBDA = 2
QUARTERED = dict(quarter_min_axis=4)
BLOCKED = dict(blocked_min_half=4)
PACKED = {}
# The spawned fits: {world: {name: (m, folds, port config, layout gates)}}.
# Every layout runs at p = 2 or p = 3 on 2 or 4 ranks, one fit with CV
# folds; "natural" is spectral_cg=False.  The bf16 vectors' x-update is
# held at the slab level below (test_sharded_spectral_x_update_matches_one_card),
# as the single card's is (tests/test_torch_spectral.py), and so is the
# quartered layout at p = 3, whose JAX fit takes minutes to compile on the
# CPU (64 blocks, every product unrolled).
FITS = {
    2: {"quartered2": ((16, 24), 1, {}, QUARTERED),
        "blocked3": ((8, 8, 8), 1, {}, BLOCKED),
        "natural3": ((8, 8, 8), 2, {"spectral_cg": False}, PACKED)},
    4: {"packed2": ((16, 24), 1, {}, PACKED),
        "blocked3": ((16, 8, 8), 1, {}, BLOCKED)},
}
# The slab-level x-update check's lattices (each under each layout).
PIECES_M = ((16, 24), (8, 8, 12), (8, 8, 8, 8))
LAYOUTS = {"quartered": QUARTERED, "blocked": BLOCKED, "packed": PACKED}
WORLDS = (2, 4)

_data = ranks_lib.fit_data


def _labels(n, folds):
    return np.asarray(jcv.kfold_indices(n, folds, 123))


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """{world: Ranks}: the fits and the slab-level jobs of each world."""
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"spectral{world}")
        jobs = {"pieces": ("spectral_pieces", dict(ms=PIECES_M, seed=world))}
        for name, (m, folds, cfg, gates) in FITS[world].items():
            labels = None
            if folds > 1:
                labels = str(tmp / f"labels_{name}.npy")
                np.save(labels, _labels(len(_data(m, seed=11)[1]), folds))
            jobs[name] = ("mvtv_sharded", dict(m=m, seed=11, n_lambda=N_LAMBDA, folds=folds,
                                               cfg=dict(max_iters=CAP, **cfg),
                                               labels_file=labels, gates=gates))
        out[world] = ranks_lib.Ranks(world, str(tmp), jobs)
    return out


def _set_jax_gates(monkeypatch, gates):
    monkeypatch.setattr(jxupdate, "FORCE_XLA_PACKED", True)
    if "quarter_min_axis" in gates:
        monkeypatch.setattr(jproblem, "QUARTER_MIN_AXIS", gates["quarter_min_axis"])
    if "blocked_min_half" in gates:
        monkeypatch.setattr(jxupdate, "BLOCKED_MIN_HALF", gates["blocked_min_half"])


def jax_tpu_fit(monkeypatch, m, world, folds, cfg, gates, include_full_mixed=True):
    """The JAX package's mvtv_sharded on a (1, W, 1) mesh (a (1, W, 1, 1)
    name tuple's first three axes at p >= 4 are the same mesh) forced onto
    its TPU x-update, the layout gates lowered, each solve capped at CAP."""
    x, y = _data(m, seed=11)
    with monkeypatch.context() as mp:
        _set_jax_gates(mp, gates)
        jax.clear_caches()
        try:
            want = jfit.mvtv_sharded(
                x, y, m=m, n_lambda=N_LAMBDA, folds=folds,
                device_mesh=jmesh((1, world, 1), ("dp", "sx", "sy")),
                spatial_axes=("sx", "sy"),
                solver_config=JSolverConfig(max_iters=CAP, include_full_mixed=include_full_mixed,
                                            **cfg))
        finally:
            jax.clear_caches()
    return x, y, want


def _penalty(theta, deltas, include_full_mixed=True):
    """||D theta||_1 in float64 over the block set with the delta scales."""
    from multivartv_tpu.ops import diff as jdiff
    th = np.asarray(theta, np.float64)
    pen = 0.0
    for b in jdiff.fd_binaries(th.ndim, include_full_mixed):
        d = th
        for j, bj in enumerate(b):
            if bj:
                d = np.diff(d, axis=j)
        pen += float(np.prod([dl for dl, bj in zip(deltas, b) if not bj])) * np.abs(d).sum()
    return pen


def check_fit(r, want, y, include_full_mixed=True, tol_obj=1e-5):
    """The shard tests' gates: lambdas 1e-5, CV MSEs 1e-4, the chosen
    index, the objective at it tol_obj relative."""
    np.testing.assert_allclose(r["lambdas"], want.lambdas, rtol=1e-5)
    np.testing.assert_allclose(r["cv_mses"], want.cv_mses, rtol=1e-4)
    best = int(r["best"])
    assert best == want.lambda_minmse_ind
    deltas = np.asarray(want.mesh_spec.deltas, np.float64)

    def obj(fitted, theta, lam):
        return (0.5 * np.sum((np.asarray(y, np.float64) - np.asarray(fitted)) ** 2)
                + lam * _penalty(theta, deltas, include_full_mixed))

    a = obj(r["fitted"], r["theta"], float(r["lambdas"][best]))
    b = obj(want.fitted, want.theta_lattice, float(want.lambdas[best]))
    assert abs(a - b) <= tol_obj * abs(b), (a, b)


def result_of(spawned, world, name):
    return {k.split("/", 1)[1]: v for k, v in spawned[world].result().items()
            if k.startswith(name + "/")}


@pytest.mark.parametrize("world,name", [(w, n) for w in WORLDS for n in FITS[w]])
def test_sharded_x_update_arms_match_jax_tpu_route(spawned, monkeypatch, world, name):
    """mvtv_sharded on W gloo ranks with the default x-update (the spectral
    CG across ranks, in the quartered, blocked and packed layouts) and
    with spectral_cg=False, against the JAX package's
    mvtv_sharded on W virtual devices forced onto its TPU x-update with the
    same config and gates: the shard tests' gates (check_fit)."""
    m, folds, cfg, gates = FITS[world][name]
    _, y, want = jax_tpu_fit(monkeypatch, m, world, folds, cfg, gates)
    r = result_of(spawned, world, name)
    check_fit(r, want, y)
    assert r["theta"].shape == m


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_spectral_x_update_matches_one_card(spawned, world):
    """One x-update on slabs against the single card's on the whole lattice
    from the same warm x0 (the exact solution, perturbed), each layout
    (quartered, blocked, packed) at p = 2, 3 and 4, float32 and bf16
    vectors: the spectral CG across ranks (parallel/spectral.py) against
    _solve_tiled, and spectral_cg=False against _solve_natural.  The
    transforms take the single card's bf16 operands in its axis order; the
    group sums and the float32 sums inside the products add in other
    orders, so a value can land on the other side of a bf16 boundary: within
    1e-2 of max|x - x0|, tests/test_torch_spectral.py's gate against the
    JAX package.  With float32 per-axis operands and vectors on both sides
    no bf16 rounding is left to flip: within 1e-5, so that a block in the
    wrong place or a wrong pairing of rows across ranks shows.  And
    xla_packed=False on the slabs is the exact PCG with
    the folded halves removed, bit for bit, and within 1e-5 of the single
    card's exact PCG within one CG step (its stopping test compares sums
    taken in another order; tests/test_torch_sharded_fit.py's gate), at
    p = 4 too (the dense DCT preconditioner along every axis of the slab
    and the pencil)."""
    r = result_of(spawned, world, "pieces")
    assert r["spectral"] <= 1e-2 and r["natural"] <= 1e-2
    assert r["spectral f32"] <= 1e-5
    assert r["exact arm"] == 0.0
    assert r["exact vs one card"] <= 1e-5 and r["exact iterations"] <= 1
    assert int(r["cases"]) == len(PIECES_M) * len(LAYOUTS) * 2


def test_one_rank_x_update_is_the_single_cards():
    """On a group of one (no process group, in this process) the pieces'
    spectral CG equals the single card's bit for bit: the pencil
    transposes are the identity and every product and sum runs as on one
    card; with float32 operands the products on moved views sum in other
    orders (within 1e-5, as above).  The natural arm's matvec is B9s's matvec mode (p = 2) and the
    slab matvec (p = 3, the Laplacian form), not bit-equal to B10 and the
    plain stencil: within 1e-2 of max|x - x0| as above."""
    logging.disable(logging.WARNING)
    try:
        r = ranks_lib.JOBS["spectral_pieces"](PIECES_M, seed=1)
    finally:
        logging.disable(logging.NOTSET)
    assert r["spectral"] == 0.0 and r["exact arm"] == 0.0
    assert r["spectral f32"] <= 1e-5
    assert r["natural"] <= 1e-2
