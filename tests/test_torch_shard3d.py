"""The port's sharded fit at p = 3 (plane slabs) and p = 1 (chain segments)
against the JAX package's, on the CPU.

As tests/test_torch_sharded_fit.py does at p = 2: the port's ranks are
processes spawned with torch.multiprocessing, 2 and 4 of them on gloo
(tests/torch_shard_ranks.py, which imports no jax), started together at
the module's first test; the JAX package's mvtv_sharded runs in this
process on a (1, W, 1) mesh at p = 3 and a (1, W) mesh at p = 1 of as many
virtual CPU devices (axis 0 divides by W there).  Off the TPU the JAX
package runs its SPMD route: the tolerance-driven DCT-preconditioned PCG
at p = 3 and the cyclic reduction at p = 1; the port runs its shard route
under SolverConfig(xla_packed=False), the same algorithm (B13s's r0 and
matvec, the pencil-transposed DCT preconditioner, B12s's dual stage with
the carries at p = 3; the partition solve, T1 on each segment, at p = 1;
its default x-update, the spectral CG across ranks, is held against the
JAX package's TPU x-update in tests/test_torch_shard_spectral.py): fits
are compared on lambdas, CV MSEs, the chosen index and the objective.  The spawned fits cap each solve at 30
iterations on both sides; the fits of one rank in this process run to
convergence.  The slab kernels' plain versions are also held, cut
unevenly, against the JAX package's whole-lattice B12 and B13 in
interpret mode, and the partition solve against its cyclic reduction."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import torch_shard_ranks as ranks_lib
from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.ops import diff as jdiff
from multivartv_tpu.ops import pallas_kernels as pk
from multivartv_tpu.parallel import fit as jfit
from multivartv_tpu.parallel.sharding import make_device_mesh as jmesh
from multivartv_tpu.solver import cv as jcv
from multivartv_tpu.solver import tridiag as jtridiag
from multivartv_tpu_torch.ops import kernels as K
from multivartv_tpu_torch.parallel import distributed, fit
from multivartv_tpu_torch.parallel.sharding import RowGroup, RowSlab, make_device_mesh
from multivartv_tpu_torch.solver import admm
from multivartv_tpu_torch.solver import tridiag

WORLDS = (2, 4)
CAP = 30          # iterations per solve on both sides in the spawned fits
N_LAMBDA = 3
M3, M1 = (8, 6, 5), (64,)
# The fits of each world: (m, folds); each p with each world and each of
# folds = 1 and 2.
FITS = {2: [(M3, 2), (M1, 1)], 4: [(M3, 1), (M1, 2)]}
# The p = 1 fits with the x-solvers the partition solve does not serve
# (world: x_solver): the gathered-chain DCT solve and the Jacobi PCG on the
# slabs' plain matvec; folds 1.
X_SOLVER_FITS = {2: "dct_direct", 4: "jacobi_pcg"}
# The one-rank fits, to convergence: (m, the lambdas as fractions of the
# port's lambda_max), where the solves take tens of iterations.
ONE_RANK = {"p3": ((4, 4, 2), (0.3, 0.1, 0.03)), "p1": (M1, (0.3, 0.1, 0.03))}
PIECES_M3, PIECES_N1 = (11, 9, 7), 40
# The whole-lattice census (test_sharded_fit_keeps_no_whole_lattice): 2
# ranks, folds 3, N_LAMBDA lambdas, the default x-update (the spectral CG
# across ranks); p = 3 keeps only the MSEs on its path, so that it refits
# at the chosen lambda, and p = 2 keeps the path's thetas.  The census is
# taken as each solve starts, so a few iterations a solve do (CAP's would
# take the file's two census fits from ~15 s to ~50 s).  The layout gates
# are lowered so that the blocked (p = 3) and quartered (p = 2) eigenvalue
# sets exist beside the packed one.  (m, path store, ADMM solves a rank,
# gates, the eigenvalue sets the solves hold.)
CENSUS_WORLD, CENSUS_FOLDS, CENSUS_CAP = 2, 3, 4
ALL_SETS = ("gram_eigs", "gram_eigs_packed", "gram_eigs_blocked", "gram_eigs_blocked_lp",
            "gram_eigs_quartered", "gram_eigs_quartered_lp")
CENSUS = {"p3": ((16, 12, 10), "mse", CENSUS_FOLDS * N_LAMBDA + N_LAMBDA + 1,
                 dict(blocked_min_half=4), ALL_SETS[:4]),
          "p2": ((32, 24), "fitted", CENSUS_FOLDS * N_LAMBDA + N_LAMBDA,
                 dict(quarter_min_axis=4), ALL_SETS)}

_data = ranks_lib.fit_data


def _name(m, folds, x_solver=None):
    return "mvtv" + "x".join(map(str, m)) + f"f{folds}" + (x_solver or "")


def _labels(n, folds):
    return np.asarray(jcv.kfold_indices(n, folds, 123))


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """{world: Ranks}: every world's jobs, started at the module's first
    test, so that they run while the JAX side computes."""
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"world{world}")
        jobs = {"pieces": ("pieces_3d", dict(m=PIECES_M3, n1=PIECES_N1, seed=world))}
        fits = [(m, folds, None) for m, folds in FITS[world]]
        for m, folds, x_solver in fits + [(M1, 1, X_SOLVER_FITS[world])]:
            labels = None
            if folds > 1:
                labels = str(tmp / f"labels{_name(m, folds)}.npy")
                np.save(labels, _labels(len(_data(m, seed=11)[1]), folds))
            cfg = dict(max_iters=CAP, xla_packed=False,
                       **({"x_solver": x_solver} if x_solver else {}))
            jobs[_name(m, folds, x_solver)] = ("mvtv_sharded", dict(
                m=m, seed=11, n_lambda=N_LAMBDA, folds=folds, cfg=cfg, labels_file=labels))
        out[world] = ranks_lib.Ranks(world, str(tmp), jobs)
    jobs = {case: ("whole_lattice_census", dict(m=m, seed=11, n_lambda=N_LAMBDA,
                                                folds=CENSUS_FOLDS,
                                                cfg=dict(max_iters=CENSUS_CAP),
                                                store=store, gates=gates))
            for case, (m, store, _, gates, _) in CENSUS.items()}
    out["census"] = ranks_lib.Ranks(CENSUS_WORLD, str(tmp_path_factory.mktemp("census")), jobs)
    return out


def _objective(y, fitted, theta, lam, deltas):
    """0.5 ||y - O theta||^2 + lam ||D theta||_1 in float64, D over the full
    block set with the delta scales."""
    th = np.asarray(theta, np.float64)
    p = th.ndim
    bins = jdiff.fd_binaries(p, True)
    scales = [float(np.prod([d for d, bj in zip(deltas, b) if not bj])) for b in bins]
    pen = 0.0
    for b, s in zip(bins, scales):
        d = th
        for j, bj in enumerate(b):
            if bj:
                d = np.diff(d, axis=j)
        pen += s * np.abs(d).sum()
    return 0.5 * np.sum((np.asarray(y, np.float64) - fitted) ** 2) + lam * pen


def _jax_fit(x, y, m, world, folds, n_lambda, cfg=None):
    names = ("dp", "sx") if len(m) == 1 else ("dp", "sx", "sy")
    shape = (1, world) if len(m) == 1 else (1, world, 1)
    return jfit.mvtv_sharded(x, y, m=m, n_lambda=n_lambda, folds=folds,
                             device_mesh=jmesh(shape, names), spatial_axes=names[1:],
                             solver_config=cfg)


def _check_fit(got, want, y, tol_obj):
    np.testing.assert_allclose(got["lambdas"], want.lambdas, rtol=1e-5)
    np.testing.assert_allclose(got["cv_mses"], want.cv_mses, rtol=1e-4)
    best = int(got["best"])
    assert best == want.lambda_minmse_ind
    deltas = np.asarray(want.mesh_spec.deltas, np.float64)
    a = _objective(y, got["fitted"], got["theta"], float(got["lambdas"][best]), deltas)
    b = _objective(y, np.asarray(want.fitted), want.theta_lattice, float(want.lambdas[best]),
                   deltas)
    assert abs(a - b) <= tol_obj * abs(b)


def _check_spawned_fit(spawned, world, m, folds, x_solver=None):
    x, y = _data(m, seed=11)
    jcfg = JSolverConfig(max_iters=CAP, **({"x_solver": x_solver} if x_solver else {}))
    want = _jax_fit(x, y, m, world, folds, N_LAMBDA, jcfg)
    name = _name(m, folds, x_solver)
    r = {k.split("/")[1]: v for k, v in spawned[world].result().items()
         if k.startswith(name + "/")}
    _check_fit(r, want, y, 1e-5)
    assert r["theta"].shape == m and int(r["key"]) >= 1


@pytest.mark.parametrize("world,m,folds", [(w, m, f) for w in WORLDS for m, f in FITS[w]])
def test_mvtv_sharded_matches_jax(spawned, world, m, folds):
    """mvtv_sharded at p = 3 and p = 1 on W gloo ranks against the JAX
    package's on W virtual devices, each solve capped at CAP iterations on
    both sides: the lambda grid within 1e-5 (the port's lambda_max is
    float64, JAX's float32), the CV MSEs within 1e-4, the same chosen
    index, and the objective at it within 1e-5 relative."""
    _check_spawned_fit(spawned, world, m, folds)


@pytest.mark.parametrize("world", WORLDS)
def test_mvtv_sharded_p1_x_solvers_match_jax(spawned, world):
    """mvtv_sharded at p = 1 with the x-solver X_SOLVER_FITS[world] on both
    sides (dct_direct: the chain gathered and solved whole on every rank;
    jacobi_pcg: the PCG on the slabs' plain matvec), as above."""
    _check_spawned_fit(spawned, world, M1, 1, X_SOLVER_FITS[world])


@pytest.mark.parametrize("case", sorted(ONE_RANK))
def test_mvtv_sharded_one_rank_matches_jax(case):
    """A group of one rank in this process (no collective call; at p = 1 T1
    on the whole chain) runs the shard route to convergence: against the
    JAX package's mvtv_sharded on one device, 2 folds with JAX's labels,
    the lambda grid, CV MSEs, chosen index and objective as above (the
    objective within 2e-5, Boyd's test stopping each side at its own
    point).  The lambdas (ONE_RANK) are where the solves converge in tens
    of iterations: the CPU runs the plain versions eagerly."""
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH, PathConfig, SolverConfig
    from multivartv_tpu_torch.solver import cv
    from multivartv_tpu_torch.solver import path as tpath

    m, fractions = ONE_RANK[case]
    x, y = _data(m, seed=5)
    setup = _setup(x, y, m, None, SolverConfig(), DEFAULT_MESH, "cpu")
    lambdas = float(tpath.lam_max(setup[5], setup[6], PathConfig())) * np.asarray(fractions)
    names = ("dp", "sx") if len(m) == 1 else ("dp", "sx", "sy")
    want = jfit.mvtv_sharded(x, y, m=m, lambdas=lambdas, folds=2,
                             device_mesh=jmesh((1,) * len(names), names),
                             spatial_axes=names[1:])
    labels = torch.as_tensor(_labels(len(y), 2))
    orig = cv.kfold_indices
    cv.kfold_indices = lambda n, k, seed: labels
    try:
        got = fit.mvtv_sharded(x, y, m=m, lambdas=lambdas, folds=2, device="cpu",
                               solver_config=SolverConfig(xla_packed=False))
    finally:
        cv.kfold_indices = orig
    assert got.solver_config.tiled_shard_key is not None
    r = dict(lambdas=got.lambdas, cv_mses=got.cv_mses, best=got.lambda_minmse_ind,
             theta=got.theta_lattice, fitted=got.fitted)
    _check_fit(r, want, y, 2e-5)


@pytest.mark.parametrize("case", sorted(CENSUS))
def test_sharded_fit_keeps_no_whole_lattice(spawned, case):
    """After the cut no rank holds a tensor of the whole lattice's shape,
    nor a whole-lattice-sized set of eigenvalue blocks: mvtv_sharded on 2
    gloo ranks (p = 3 at 16 x 12 x 10, p = 2 at 32 x 24; 3 folds, 3
    lambdas; the default x-update, the spectral CG across ranks) counts,
    at the start of every ADMM solve of the CV, the full path and the
    refit, the live tensors whose trailing shape is the lattice's (after a
    gc pass), and finds none on either rank (the JAX package's devices
    hold only their shards); and it counts each eigenvalue set of the
    solve's operators by bytes (the packed, blocked and quartered sets and
    their bf16 copies: 2^p or 4^p blocks, none of the lattice's shape), and
    finds on each rank its share, half of the whole set (its pencil; the
    sets have no halos).  Each count is taken before its solve's first
    iteration, so the solves' cap (CENSUS_CAP, not the file's CAP, for
    time) cannot change it.  The returned model is whole, on the host:
    finite, and at p = 2 its theta is the path's at the chosen lambda."""
    m, store, solves, _, sets = CENSUS[case]
    r = {k.split("/")[1]: v for k, v in spawned["census"].result().items()
         if k.startswith(case + "/")}
    assert int(r["solves"]) == CENSUS_WORLD * solves
    assert int(r["whole"]) == 0
    assert float(r["share"]) == 1.0 / CENSUS_WORLD
    assert int(r["sets"]) == sum(1 << ALL_SETS.index(name) for name in sets)
    assert r["theta"].shape == m and np.all(np.isfinite(r["theta"]))
    assert r["lambdas"].shape == (N_LAMBDA,) and np.all(np.isfinite(r["cv_mses"]))
    if store == "fitted":
        best = int(np.argmin(r["cv_mses"]))
        assert r["path_theta"].shape == (N_LAMBDA, int(np.prod(m)))
        assert np.array_equal(r["path_theta"][best], r["theta"].T.reshape(-1))


def test_refusals_name_roadmap():
    """Every p takes the shard route with either block set (C7): the row
    layout of default_lattice_mesh at p = 1 .. 4, and mvtv_sharded fits
    p = 4 and the reduced block set (here on a group of one, 2 lambdas, its
    solves capped); the fold axis dp fits (a (1, 1, 1) mesh here, its folds
    on the group of one; dp = 2 on gloo ranks in
    tests/test_torch_shard_dp.py), and dp = 2 on one rank raises ValueError
    (dp does not divide the world, as in the JAX package); a 2-D process
    grid still raises NotImplementedError naming ROADMAP, and a chain needs
    two knots per rank."""
    from multivartv_tpu_torch.config import SolverConfig

    for p in (1, 2, 3, 4):
        group, names = distributed.global_lattice_mesh(p)
        assert group.size == 1 and names[1] == "sx" and len(names) == (2 if p == 1 else 3)
    group, names = fit.default_lattice_mesh(3, dp=1)
    assert group.fold is None and group.world is group
    x, y = _data(M3, seed=2)
    model = fit.mvtv_sharded(x, y, m=M3, n_lambda=2, folds=2, device="cpu", device_mesh=group,
                             batch_axis="dp", solver_config=SolverConfig(max_iters=CAP))
    assert model.cv_mses.shape == (2,) and np.all(np.isfinite(model.cv_mses))
    with pytest.raises(ValueError, match="divide"):
        fit.default_lattice_mesh(3, dp=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fit._sharded_solver_config(SolverConfig(), RowGroup(rank=0, size=2), ("sy", "sx"))
    for m, full in (((4, 4, 4, 4), True), (M3, False), ((8, 8), False)):
        x, y = _data(m, seed=2)
        model = fit.mvtv_sharded(x, y, m=m, n_lambda=2, folds=1, device="cpu",
                                 solver_config=SolverConfig(include_full_mixed=full,
                                                            max_iters=CAP))
        assert model.theta_lattice.shape == m and np.all(np.isfinite(model.theta_lattice))
        assert np.all(np.isfinite(model.cv_mses))
    with pytest.raises(ValueError):
        RowSlab(make_device_mesh(), (1,))


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_and_slab_pieces(spawned, world):
    """Each p = 3 and p = 1 collective and slab operation (halo planes, the
    3-D pencil transposes, the gathers, D and D' at p = 3 and p = 1, B12s
    with every flag pair and with true_m, B13s b given, fused and as a
    matvec, the shard route's x-update, the partition solve with a
    zero-count segment) on 11 x 9 x 7 and a 40-knot chain cut unevenly
    over the ranks, against its single-process version: the moves exact,
    the kernels' plain versions to 1e-6 absolute (the matvec 5e-6 against
    the jnp-style scalars (rho s) s), the Boyd sums 1e-5 relative, the
    x-update 1e-5 within one CG step, the partition solve 1e-5 of
    max|x|."""
    r = spawned[world].result()
    for k in ("halo", "pencil", "gather", "D", "D p=1", "B12s"):
        assert r[f"pieces/{k}"] == 0.0, k
    assert r["pieces/B13s"] <= 5e-6
    assert r["pieces/B12s stats"] <= 1e-5
    assert r["pieces/solve_x"] <= 1e-5 and r["pieces/solve_x iterations"] <= 1
    assert r["pieces/partition"] <= 1e-5


# ---------------------------------------------------------------------------
# The slab kernels' plain versions against JAX's whole-lattice B12 and B13
# in interpret mode, on uneven plane cuts
# ---------------------------------------------------------------------------

KM = (9, 5, 72)
KT = 15           # JAX's panel rows at KM (tests/test_torch_tiled3d.py)
CUTS = [(4, 1, 4), (1, 8), (9,)]


@functools.lru_cache(maxsize=None)
def _kernel_inputs(seed=3):
    rng = np.random.RandomState(seed)
    deltas = jnp.asarray(np.asarray([0.5, 0.8, 1.2], np.float32))
    bins = jdiff.fd_binaries(3, True)
    scales = tuple(float(s) for s in jdiff.delta_scales(bins, deltas))
    theta = rng.randn(*KM).astype(np.float32)
    u = tuple((rng.randn(*KM) * np.asarray(jdiff.edge_mask(KM, b))).astype(np.float32)
              for b in bins)
    lat = [rng.randn(*KM).astype(np.float32) for _ in range(3)]
    counts = rng.poisson(3, KM).astype(np.float32)
    return scales, theta, u, lat, counts


@functools.lru_cache(maxsize=None)
def _jax_dual3(true_m, want_alpha):
    """The JAX package's whole-lattice B12 in interpret mode on
    _kernel_inputs, with the adjoint carries (kappa 0.3, u_scale 0.7)."""
    scales, theta, u, _, _ = _kernel_inputs()
    return pk.dual_update_tiled_3d(jnp.asarray(theta), tuple(map(jnp.asarray, u)),
                                   jnp.float32(0.3), scales, u_scale=jnp.float32(0.7),
                                   true_m=true_m, want_adjoints=True, want_alpha=want_alpha,
                                   interpret=True, tile_rows=KT)


def _cut(x, cut):
    """(slabs, tops, bots) of a whole lattice cut into planes `cut`: each
    slab with the plane below and above, zeros at the global edges."""
    x = torch.as_tensor(x)
    zero = torch.zeros((1,) + tuple(x.shape[1:]))
    lo, out = 0, []
    for r in cut:
        hi = lo + r
        out.append((x[lo:hi].contiguous(), x[lo - 1:lo] if lo > 0 else zero,
                    x[hi:hi + 1] if hi < x.shape[0] else zero, lo))
        lo = hi
    return out


def _close(got, want, tol):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape
    assert np.max(np.abs(g - w)) <= tol * max(1.0, np.max(np.abs(w)))


@pytest.mark.parametrize("cut", CUTS, ids=["4-1-4", "1-8", "whole"])
@pytest.mark.parametrize("true_m", [None, (8, 4, 70)], ids=["None", "true_m"])
@pytest.mark.parametrize("want_alpha", [True, False])
def test_dual_update_3d_slabs_match_jax_whole_lattice(cut, true_m, want_alpha):
    """B12s's plain version on each plane slab (one-plane slabs included),
    the slabs together against the JAX package's whole-lattice B12 in
    interpret mode (1e-5), the slabs' Boyd sums added against its sums
    (1e-5 relative); on the one slab of the whole lattice, equal to B12's
    plain version bit for bit."""
    scales, theta, u, _, _ = _kernel_inputs()
    kappa, us = np.float32(0.3), np.float32(0.7)
    want = _jax_dual3(true_m, want_alpha)
    slabs = list(zip(_cut(theta, cut), *(_cut(w, cut) for w in u)))
    got = []
    for parts in slabs:
        lo = parts[0][3]
        got.append(K.dual_update_tiled_3d_shard(
            parts[0][0], tuple(p[0] for p in parts[1:]), [p[1] for p in parts],
            [p[2] for p in parts], lo, KM[0], torch.tensor(kappa), scales,
            u_scale=torch.tensor(us), true_m=true_m, want_adjoints=True,
            want_alpha=want_alpha))
    lat_g = [torch.cat(z).numpy() for z in zip(*[(*(g[0] or ()), *g[1], *g[3:]) for g in got])]
    lat_w = [np.asarray(w) for w in (*(want[0] or ()), *want[1], *want[3:])]
    for g, w in zip(lat_g, lat_w):
        _close(g, w, 1e-5)
    np.testing.assert_allclose(sum(g[2] for g in got).numpy(), np.asarray(want[2]), rtol=1e-5)
    if len(cut) == 1:
        ref = K.dual_update_tiled_3d_reference(torch.as_tensor(theta),
                                               tuple(map(torch.as_tensor, u)),
                                               torch.tensor(kappa), scales, torch.tensor(us),
                                               true_m, True, want_alpha)
        for g, w in zip((*(got[0][0] or ()), *got[0][1], *got[0][2:]),
                        (*(ref[0] or ()), *ref[1], *ref[2:])):
            assert torch.equal(g, w)


@pytest.mark.parametrize("cut", CUTS, ids=["4-1-4", "1-8", "whole"])
@pytest.mark.parametrize("mode", ["given", "fused", "matvec"])
def test_gram_3d_slabs_match_jax_whole_lattice(cut, mode):
    """B13s's plain version on each plane slab, b given, fused from (oty,
    dta, u_scale, dtu) or as the matvec, the slabs together against the
    JAX package's whole-lattice B13 in interpret mode within 1e-5 (the
    matvec as b - r0 with b = 0)."""
    scales, v, _, (oty, dta, dtu), counts = _kernel_inputs()
    rho, us = np.float32(0.13), np.float32(0.6)
    b = (oty + rho * (dta + us * dtu)).astype(np.float32)
    if mode == "matvec":
        b = np.zeros_like(b)
    j = jnp.asarray
    jparts = (j(oty), j(dta), jnp.float32(us), j(dtu)) if mode == "fused" else None
    want = np.asarray(pk.gram_residual_tiled_3d(None if jparts else j(b), j(v), j(counts),
                                                jnp.float32(rho), scales, rhs_parts=jparts,
                                                interpret=True, tile_rows=KT))
    got = []
    for (vs, top, bot, lo), (bs, *_), (cs, *_), (os_, *_), (ds, *_), (us_, *_) in zip(
            *(_cut(x, cut) for x in (v, b, counts, oty, dta, dtu))):
        args = (vs, top, bot, lo, KM[0], cs, torch.tensor(rho), scales)
        if mode == "matvec":
            got.append(-K.gram_matvec_tiled_3d_shard(*args))
        else:
            parts = (os_, ds, torch.tensor(us), us_) if mode == "fused" else None
            got.append(K.gram_residual_tiled_3d_shard(None if parts else bs, *args,
                                                      rhs_parts=parts))
    _close(torch.cat(got).numpy(), want, 1e-5)


def _laplacian(w, axis, mask, mask_prev):
    """The 1-D Neumann Laplacian L_j = D_j' M_j D_j along axis j in its
    difference form, (L_j w)(x) = M_j(x) (w(x) - w(x + e_j)) + M_j(x - e_j)
    (w(x) - w(x - e_j)), the masks given at x and at x - e_j (0 where
    x - e_j lies below the lattice): the neighbours past an edge (wrapped
    here) are multiplied by 0."""
    return (mask * (w - torch.roll(w, -1, axis))
            + mask_prev * (w - torch.roll(w, 1, axis)))


def _in_plane_masks(n, axis):
    """(M_j(x), M_j(x - e_j)) of an in-plane axis of length n, shaped to
    broadcast over a (planes, m1, m2) panel."""
    x = torch.arange(n)
    shape = [1, 1, 1]
    shape[axis] = n
    return ((x < n - 1).float().reshape(shape), (x >= 1).float().reshape(shape))


@pytest.mark.parametrize("cut", CUTS, ids=["4-1-4", "1-8", "whole"])
def test_gram_3d_matvec_factors_by_axis(cut):
    """The identity B13s's matvec kernel is built on: D_b'D_b = prod_{j in
    b} L_j, so that A v = counts v + rho (P v + L_0 (Q v)) with P = s2(0,1,0)
    L_1 + s2(0,0,1) L_2 + s2(0,1,1) L_1 L_2 and Q = s2(1,0,0) + s2(1,1,0) L_1
    + s2(1,0,1) L_2 + s2(1,1,1) L_1 L_2 (each s^2 rounded to float32), L_0
    read on the global planes.  Written out in torch on each plane slab with
    its halo planes (zeros at the global edges), the slabs together against
    the JAX package's whole-lattice B13 in interpret mode with b = 0 (A v =
    -r0) within 1e-5, the lattice's edges included."""
    scales, v, _, _, counts = _kernel_inputs()
    rho = np.float32(0.13)
    want = -np.asarray(pk.gram_residual_tiled_3d(jnp.zeros(KM, jnp.float32), jnp.asarray(v),
                                                 jnp.asarray(counts), jnp.float32(rho), scales,
                                                 interpret=True, tile_rows=KT))
    s2 = dict(zip(K.BINARIES3, (torch.tensor(np.float32(s) * np.float32(s)) for s in scales)))
    m1f, m1b = _in_plane_masks(KM[1], 1)
    m2f, m2b = _in_plane_masks(KM[2], 2)
    got = []
    for (vs, top, bot, lo), (cs, *_) in zip(_cut(v, cut), _cut(counts, cut)):
        panel = torch.cat([top, vs, bot])          # global planes lo - 1 .. lo + r
        l1 = _laplacian(panel, 1, m1f, m1b)
        l2 = _laplacian(panel, 2, m2f, m2b)
        l12 = _laplacian(l2, 1, m1f, m1b)
        pv = s2[(0, 1, 0)] * l1 + s2[(0, 0, 1)] * l2 + s2[(0, 1, 1)] * l12
        qv = s2[(1, 0, 0)] * panel + s2[(1, 1, 0)] * l1 + s2[(1, 0, 1)] * l2 + s2[(1, 1, 1)] * l12
        g = torch.arange(panel.shape[0]) + (lo - 1)
        m0 = ((g >= 0) & (g < KM[0] - 1)).float()[:, None, None]   # M_0 at each panel plane
        q, qn, qb = qv[1:-1], qv[2:], qv[:-2]
        l0q = m0[1:-1] * (q - qn) + m0[:-2] * (q - qb)
        got.append(cs * vs + torch.tensor(rho) * (pv[1:-1] + l0q))
    _close(torch.cat(got).numpy(), want, 1e-5)


@pytest.mark.parametrize("cuts", [(300, 50, 250, 250), (300, 2, 348), (40, 960)],
                         ids=["4-segments", "2-knot-segment", "2-segments"])
def test_partition_solve_matches_jax_cyclic_reduction(cuts):
    """The partition solve emulated in one process (each segment's solve,
    the finish: the interface solve and the back-substitution), the second
    segment's counts all zero (the first's in the 2-segment case), against the JAX
    package's cyclic reduction on the whole chain (1e-5 of max|x|); each
    segment's three solves against a float64 banded solve of its principal
    submatrix (1e-4 of max|x|: a zero-count segment's system g T has a
    condition number ~4 L^2, 6,400 at L = 40, so a float32 solve sits
    ~3e-5 from the float64 one).  A zero-count stretch of hundreds of
    knots makes the chain's own system that ill-conditioned (the JAX
    package's solve and this one then both sit ~1e-2 from the float64
    one), so the stretches here are short."""
    import scipy.linalg

    rng = np.random.RandomState(len(cuts))
    n = sum(cuts)
    counts = rng.poisson(1, n).astype(np.float32)
    zero = slice(0, cuts[0]) if len(cuts) == 2 else slice(cuts[0], cuts[0] + cuts[1])
    counts[zero] = 0.0
    b = rng.randn(n).astype(np.float32)
    rho, scale = np.float32(0.7), 1.3
    want = np.asarray(jtridiag.xupdate_tridiag(jnp.asarray(counts), jnp.asarray(b),
                                               jnp.float32(rho), jnp.float32(scale)))
    g = float(np.float32(np.float32(rho) * np.float32(scale)) * np.float32(scale))
    lo, ends, ylrs = 0, [], []
    for r in cuts:
        hi = lo + r
        c_k, b_k = torch.as_tensor(counts[lo:hi]), torch.as_tensor(b[lo:hi])
        ylr = K.xupdate_tridiag_segment(c_k, b_k, torch.tensor(rho), scale, lo > 0, hi < n)
        t = np.full(r, 2.0)
        t[0] -= 0.0 if lo > 0 else 1.0
        t[-1] -= 0.0 if hi < n else 1.0
        band = np.zeros((3, r))
        band[0, 1:], band[1], band[2, :-1] = -g, counts[lo:hi] + g * t, -g
        rhs = np.stack([b[lo:hi], np.eye(r)[0], np.eye(r)[-1]], axis=1).astype(np.float64)
        ref = scipy.linalg.solve_banded((1, 1), band, rhs).T
        np.testing.assert_allclose(ylr.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
        ylrs.append(ylr)
        ends.append(torch.cat([tridiag.segment_ends(ylr), torch.tensor([rho])]))
        lo = hi
    every = torch.stack(ends)
    got = torch.cat([K.partition_finish(every, k, scale, y) for k, y in enumerate(ylrs)])
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("every,rank,ylr", [
    ((2, 7), 2, (3, 5)), ((2, 7), -1, (3, 5)), ((2, 6), 0, (3, 5)), ((2, 7), 0, (2, 5))],
    ids=["rank-past-group", "negative-rank", "six-ends", "two-solves"])
def test_partition_finish_refuses_bad_arguments(every, rank, ylr):
    """The finish wrapper checks its shapes and the rank before either
    route."""
    with pytest.raises(ValueError):
        K.partition_finish(torch.zeros(every), rank, 1.0, torch.zeros(ylr))


def test_shard_route_names():
    """solve_route names the shard route for operators cut to plane slabs
    and chain segments, and the dual stage carries dta/dtu at p = 3 only."""
    from multivartv_tpu_torch.config import SolverConfig
    from multivartv_tpu_torch.parallel import tiled_shard
    from multivartv_tpu_torch.solver.problem import build_operators

    grp = make_device_mesh()
    cfg = fit._sharded_solver_config(SolverConfig(), grp)
    for m, deltas in (((6, 4, 4), [1.0, 1.0, 1.0]), ((12,), [1.0])):
        ops = build_operators(m, np.asarray(deltas, np.float32), cfg, "cpu",
                              with_padded=False)
        ops_s = fit.shard_operators(ops, RowSlab(grp, m))
        assert admm.solve_route(ops_s, cfg) == "shard"
        assert admm.tiled_route(ops_s, cfg) == (len(m) == 3)
        assert tiled_shard.shard_supported(m, ops.binaries, cfg.tiled_shard_key)
    assert not tiled_shard.shard_supported((4, 4, 4, 4), ((1, 1, 1, 1),) * 15,
                                           cfg.tiled_shard_key)
