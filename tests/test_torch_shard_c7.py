"""C7: the sharded fit at p >= 4 and with the reduced block set, on the CPU.

The JAX package's mvtv_sharded fits every lattice on a row layout: where
its shard kernels do not apply (p >= 4, ``include_full_mixed=False``) it
runs its XLA stages under SPMD.  The port's shard route does the same on
the plain stages of parallel/halo.py (D and D' with their halo rows or
planes, the Boyd sums over the group), with the spectral-correction CG
across ranks as its x-update, r0 in plain PyTorch (the JAX package's
``residual=None``).  Here mvtv_sharded on 2 gloo ranks (tests/
torch_shard_ranks.py) against the JAX package's on 2 virtual devices forced
onto its TPU x-update (tests/test_torch_shard_spectral.py's jax_tpu_fit),
each solve capped at CAP iterations on both sides: (4, 4, 4, 4) with all
15 blocks, and (8, 6, 4) and a 2-D lattice with the reduced set, on the
shard tests' gates (the lambda grid 1e-5, the CV MSEs 1e-4, the chosen
index, the objective 1e-5 relative)."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import torch_shard_ranks as ranks_lib
from test_torch_shard_spectral import CAP, N_LAMBDA, check_fit, jax_tpu_fit, result_of

WORLD = 2
# name: (m, folds, include_full_mixed)
FITS = {"p4": ((4, 4, 4, 4), 1, True),
        "reduced3": ((8, 6, 4), 1, False),
        "reduced2": ((16, 24), 1, False)}


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("c7")
    jobs = {}
    for name, (m, folds, full) in FITS.items():
        labels = None
        if folds > 1:
            from multivartv_tpu.solver import cv as jcv
            labels = str(tmp / f"labels_{name}.npy")
            n = len(ranks_lib.fit_data(m, seed=11)[1])
            np.save(labels, np.asarray(jcv.kfold_indices(n, folds, 123)))
        jobs[name] = ("mvtv_sharded", dict(
            m=m, seed=11, n_lambda=N_LAMBDA, folds=folds, labels_file=labels,
            cfg=dict(max_iters=CAP, include_full_mixed=full)))
    return {WORLD: ranks_lib.Ranks(WORLD, str(tmp), jobs)}


@pytest.mark.parametrize("name", sorted(FITS))
def test_c7_sharded_fit_matches_jax(spawned, monkeypatch, name):
    """mvtv_sharded fits the lattice the port used to refuse, on 2 gloo
    ranks, as the JAX package's mvtv_sharded on 2 virtual devices does."""
    m, folds, full = FITS[name]
    _, y, want = jax_tpu_fit(monkeypatch, m, WORLD, folds, {}, {}, include_full_mixed=full)
    r = result_of(spawned, WORLD, name)
    check_fit(r, want, y, include_full_mixed=full)
    assert r["theta"].shape == m and int(r["key"]) >= 1
