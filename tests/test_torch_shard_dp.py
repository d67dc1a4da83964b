"""The sharded fit with the CV folds split over the fold axis "dp", on the CPU.

The JAX package's mvtv_sharded takes a (dp, sx, sy) mesh and shards its
fold batch over "dp" (fold f on dp index f // (folds / dp)), the final
path and the refit replicated; the port's takes the same layout from
parallel/sharding.py::make_device_mesh: each row group of sx ranks solves
its block of folds, and the folds' held-out MSEs come together over the
fold group before their mean.  One world of 8 gloo ranks
(tests/torch_shard_ranks.py) runs every case, started at the module's
first test, while this process computes the JAX side on virtual CPU
devices: the dp = 2 x sx = 2 fits on 4 of its ranks and, side by side
with them, the dp = 1 fits on a pair and the rest on another pair, each
part a world of its own:

  * dp = 2 x sx = 2 at 16 x 15 (axis 1 cut unevenly, 8/7, in the pencil
    transposes), 4 folds with the JAX package's labels, against JAX's on
    a (2, 2, 1) mesh, and against the port's dp = 1 x sx = 2 (each pair of
    ranks a world of its own): the CV MSEs bit for bit;
  * p = 1 at dp = 2 against JAX's (2, 2) mesh and the port's dp = 1;
  * p = 3 at dp = 2 x sx = 2, and p = 1 on that mesh with
    batch_axis=None (every row group solves every fold), each row group's
    O'y skewed by its dp index as the card's atomic binning skews it:
    every rank returns dp index 0's model, which matches JAX's;
  * two degenerate cuts on 2 ranks against JAX's: p = 3 at (6, 5, 1) and
    p = 1 at (50,) with one lambda;
  * 5 folds over dp = 2 raise ValueError on both sides.

As in tests/test_torch_sharded_fit.py, the JAX package's CPU route is the
tolerance-driven DCT-preconditioned PCG, the port runs its shard route
under SolverConfig(xla_packed=False), every solve capped at CAP iterations
on both sides, and fits are compared on the lambda grid (1e-5), the CV
MSEs (1e-4), the chosen index and the objective (1e-5 relative).  Every
rank of a world returns the same model."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_shard_ranks as ranks_lib
from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.parallel import fit as jfit
from multivartv_tpu.parallel.sharding import make_device_mesh as jmesh
from multivartv_tpu.solver import cv as jcv
from test_torch_shard_spectral import check_fit

# The world's 8 ranks in parts, each a world of its own, which run their
# fits side by side: the dp = 2 x sx = 2 fits on 4 ranks, the dp = 1 fit at
# p = 2 on a pair, the rest on the other pair.  Only the first part makes
# sub-groups (dist.new_group names a group by a count in each process, so
# parts that made groups side by side would reuse each other's names).
WORLD = 8
PARTS = ([0, 1, 2, 3], [4, 5], [6, 7])
CAP = 30
N_LAMBDA = 3
M2, M1, M3 = (16, 15), (64,), (8, 4, 4)
# O'y scaled by 1 + SKEW * the dp index (torch_shard_ranks._mvtv_mesh's skew).
SKEW = 1e-3
# name: (m, folds, n_lambda, mesh shape, part, _mvtv_mesh's other kwargs)
FITS = {"dp2 p2": (M2, 4, N_LAMBDA, (2, 2, 1), 0, {}),
        "dp2 p1": (M1, 2, N_LAMBDA, (2, 2), 0, {}),
        "folds 5": (M2, 5, N_LAMBDA, (2, 2, 1), 0, {}),
        "dp1 p2": (M2, 4, N_LAMBDA, (1, 2, 1), 1, {}),
        "dp1 p1": (M1, 2, N_LAMBDA, (1, 2), 2, {}),
        "dp2 p3 skewed": (M3, 2, 2, (2, 2, 1), 0, {"skew": SKEW}),
        "unsplit p1 skewed": (M1, 2, N_LAMBDA, (2, 2), 0, {"skew": SKEW, "batch_axis": None}),
        "cut 6x5x1": ((6, 5, 1), 1, 2, (1, 2, 1), 2, {}),
        "cut 50": ((50,), 1, 1, (1, 2), 2, {})}
# The fits held against the JAX package's on the same mesh.
AGAINST_JAX = ("dp2 p2", "dp2 p1", "dp2 p3 skewed", "unsplit p1 skewed", "cut 6x5x1", "cut 50")


def _names(m):
    return ("dp", "sx") if len(m) == 1 else ("dp", "sx", "sy")


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    fits = {}
    for name, (m, folds, n_lambda, shape, part, extra) in FITS.items():
        labels = None
        if folds > 1:
            labels = str(tmp / f"labels_{name.replace(' ', '_')}.npy")
            n = len(ranks_lib.fit_data(m, seed=11)[1])
            np.save(labels, np.asarray(jcv.kfold_indices(n, folds, 123)))
        fits[name] = (part, dict(m=m, seed=11, n_lambda=n_lambda, folds=folds, shape=shape,
                                 cfg=dict(max_iters=CAP, xla_packed=False), labels_file=labels,
                                 **extra))
    # The world's mesh first: dist.new_group names groups by a count in
    # each process, and the parts' meshes leave the parts' counts apart.
    world = ranks_lib.Ranks(WORLD, str(tmp), {
        "folds": ("fold_collectives", dict(shape=(2, WORLD // 2, 1))),
        "fits": ("mvtv_parts", dict(parts=PARTS, fits=fits))})
    # The JAX side's fits while the ranks run theirs.
    for name in AGAINST_JAX:
        _jax_fit(name)
    return world


def _result(spawned, name):
    return {k.split("/", 2)[2]: v for k, v in spawned.result().items()
            if k.startswith(f"fits/{name}/")}


def _jax_fit(name):
    m, folds, n_lambda, shape, *_ = FITS[name]
    return _jax_fit_on(m, folds, n_lambda, shape)


@functools.lru_cache(maxsize=None)
def _jax_fit_on(m, folds, n_lambda, shape):
    x, y = ranks_lib.fit_data(m, seed=11)
    names = _names(m)
    return y, jfit.mvtv_sharded(x, y, m=m, n_lambda=n_lambda, folds=folds,
                                device_mesh=jmesh(shape, names), spatial_axes=names[1:],
                                solver_config=JSolverConfig(max_iters=CAP))


@pytest.mark.parametrize("name", AGAINST_JAX)
def test_fold_axis_and_uneven_cuts_match_jax(spawned, name):
    """mvtv_sharded on the mesh of FITS[name] (dp = 2 x sx = 2 at p = 2, 1
    and 3, and at p = 1 with batch_axis=None, the last two with O'y skewed
    on every row group but dp index 0's; dp = 1 x sx = 2 on (6, 5, 1) and
    a 50-knot chain, cut 3/3 and 25/25 with axis 1 of the volume cut 3/2 in
    the pencil) against the JAX package's on the same mesh: the lambda
    grid, the CV MSEs, the chosen index and the objective; every rank
    returns the same model, dp index 0's final path and refit."""
    y, want = _jax_fit(name)
    r = _result(spawned, name)
    m, _, _, shape, *_ = FITS[name]
    check_fit(r, want, y)
    assert r["theta"].shape == m and int(r["key"]) >= 1
    assert (int(r["dp"]), int(r["sx"])) == (shape[0], shape[1])
    assert float(r["spread"]) == 0.0


@pytest.mark.parametrize("p", [2, 1])
def test_fold_axis_is_the_folds_one_after_another(spawned, p):
    """The fold axis only moves folds between row groups: the dp = 2 x sx =
    2 fit's CV MSEs, lambdas, chosen index and theta equal, bit for bit,
    those of the same fit on dp = 1 x sx = 2 (a pair of ranks, the folds
    one after another), and every rank returns the same model."""
    a = _result(spawned, f"dp2 p{p}")
    b = _result(spawned, f"dp1 p{p}")
    assert (int(a["dp"]), int(b["dp"])) == (2, 1)
    for k in ("lambdas", "cv_mses", "best", "theta", "fitted"):
        assert np.array_equal(a[k], b[k]), k
    assert float(a["spread"]) == 0.0 and float(b["spread"]) == 0.0


def test_folds_that_do_not_split_over_dp_raise(spawned):
    """5 folds over dp = 2: the JAX package's placement raises ValueError,
    and so does the port's mvtv_sharded, on every rank, before it solves."""
    with pytest.raises(ValueError):
        _jax_fit("folds 5")
    r = _result(spawned, "folds 5")
    assert "fold axis" in str(r["raised"])


def test_fold_group_collectives(spawned):
    """On a (2, 4, 1) mesh of the world's 8 ranks: each rank's row group is
    the 4 ranks of its dp index and its fold group the 2 of its sx index,
    in the row-major order of the JAX package's reshape; gather_folds puts
    every fold group's blocks in dp order on each of its ranks, and
    broadcast_each hands each the fold group's first rank's tensors (None
    kept, dtypes kept)."""
    r = {k.split("/", 1)[1]: v for k, v in spawned.result().items() if k.startswith("folds/")}
    assert bool(r["groups"]) and bool(r["none kept"])
    assert float(r["gather_folds"]) == 0.0 and float(r["broadcast_each"]) == 0.0
