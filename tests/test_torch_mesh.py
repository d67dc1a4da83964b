"""User meshes in the port against the JAX package on the CPU: irregular
lattice knots (searchsorted, ties to the lower index, float32 knots that
coincide), mesh_spec_from_points and its refusals, make_mesh_spec,
gen_mesh, point-cloud meshes (the kd-tree, the device brute force), and
mvtv / mvtv_one / predict with mesh= (tests/test_mesh.py, test_interp.py,
test_native.py and test_api.py:118 mirrored)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from multivartv_tpu import api as japi
from multivartv_tpu import mesh as jmesh
from multivartv_tpu.config import MeshConfig as JMeshConfig
from multivartv_tpu.ops import interp as jinterp
import multivartv_tpu_torch as mt
from multivartv_tpu_torch import mesh as mesh_lib
from multivartv_tpu_torch.config import MeshConfig
from multivartv_tpu_torch.native import loader
from multivartv_tpu_torch.ops import interp


def t32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def brute64(data, mesh):
    """The reference scan in float64: the lowest index of least distance."""
    return ((data[:, None, :] - mesh[None, :, :]) ** 2).sum(-1).argmin(1)


def test_irregular_knots_and_ties_match_jax():
    """The searchsorted branch (JAX mesh.py:236-241): the nearest knot, an
    exact midpoint (0.125, 0.625: exact in float32) to the lower index,
    clipping outside the knots."""
    knots = [0.0, 0.25, 1.0]
    spec = mesh_lib.MeshSpec(knots=(t32(knots),), deltas=t32([0.5]), m=(3,), regular=False)
    jspec = jmesh.MeshSpec(knots=(jnp.asarray(knots),), deltas=jnp.asarray([0.5]), m=(3,),
                           regular=False)
    data = [[-5.0], [0.1], [0.125], [0.15], [0.6], [0.625], [0.65], [2.0]]
    got = mesh_lib.nearest_knot_multi_index(spec, t32(data))[:, 0].tolist()
    assert got == [0, 0, 0, 1, 1, 1, 2, 2]
    assert got == np.asarray(jmesh.nearest_knot_multi_index(jspec, jnp.asarray(data)))[:, 0].tolist()
    reg = mesh_lib.MeshSpec(knots=(t32([0.0, 1.0]),), deltas=t32([1.0]), m=(2,))
    assert mesh_lib.nearest_knot_multi_index(reg, t32([[0.5]]))[0, 0] == 0


def test_coincident_float32_knots_bin_as_jax():
    """Sorted uniform float64 x at N = 2^20 as its own mesh: the float64
    knots are strictly increasing, so the mesh is accepted, but many
    neighbours coincide in float32; both samples of such a pair go to the
    lower knot and the upper one stays empty, in the port as in JAX."""
    n = 1 << 20
    x = np.sort(np.random.RandomState(0).uniform(0, 1, n))
    spec = mesh_lib.mesh_spec_from_points(x[:, None], (n,), device="cpu")
    jspec = jmesh.mesh_spec_from_points(x[:, None], (n,))
    assert not spec.regular and not jspec.regular
    xs = x[:, None].astype(np.float32)
    got = interp.flat_knot_indices(spec, torch.as_tensor(xs)).numpy()
    want = np.asarray(jinterp.flat_knot_indices(jspec, jnp.asarray(xs)))
    assert np.array_equal(got, want)
    # every sample equals its own knot in float32: a run of equal knots
    # sends all its samples to the run's first knot
    k32 = x.astype(np.float32)
    _, first, runs = np.unique(k32, return_index=True, return_counts=True)
    want_counts = np.zeros(n, np.int64)
    want_counts[first] = runs
    assert np.array_equal(np.bincount(got, minlength=n), want_counts)
    assert np.count_nonzero(runs > 1) > 1000


def test_mesh_spec_from_points_matches_jax():
    """The round trip of a regular and an irregular lattice, per-axis knots,
    regular flags and deltas as JAX's; the refusals of a non-lattice mesh
    and of knots that are not strictly increasing."""
    rng = np.random.RandomState(0)
    data = rng.uniform(0, 1, (50, 2))
    jspec = jmesh.make_mesh_spec(jnp.asarray(data), [4, 3])
    pts = np.asarray(jmesh.lattice_points(jspec.knots, jspec.m))
    irregular = np.asarray(jmesh.lattice_points((jnp.asarray([0.0, 0.1, 0.5, 2.0]),
                                                  jnp.asarray([1.0, 3.0, 3.5])), (4, 3)))
    for p in (pts, irregular):
        spec = mesh_lib.mesh_spec_from_points(p, (4, 3), device="cpu")
        js = jmesh.mesh_spec_from_points(p, (4, 3))
        assert spec.regular == js.regular
        for a, b in zip(spec.knots, js.knots):
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert np.array_equal(spec.deltas.numpy(), np.asarray(js.deltas))
        assert np.array_equal(mesh_lib.lattice_points(spec.knots, spec.m).numpy(),
                              np.asarray(jmesh.lattice_points(js.knots, js.m)))
    assert mesh_lib.mesh_spec_from_points(pts, (4, 3), device="cpu").regular
    assert not mesh_lib.mesh_spec_from_points(irregular, (4, 3), device="cpu").regular
    off = pts.copy()
    off[-1] += 0.01      # the last row is no knot's: the axes still increase
    with pytest.raises(ValueError, match="not a lattice"):
        mesh_lib.mesh_spec_from_points(off, (4, 3), device="cpu")
    with pytest.raises(ValueError):
        jmesh.mesh_spec_from_points(off, (4, 3))
    with pytest.raises(ValueError, match="strictly increasing"):
        mesh_lib.mesh_spec_from_points(np.array([[0.0], [1.0], [1.0]]), (3,), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        mesh_lib.mesh_spec_from_points(pts[:-1], (4, 3), device="cpu")


@pytest.mark.parametrize("mode", ["cpp", "py"])
def test_make_mesh_spec_and_gen_mesh_match_jax(mode):
    rng = np.random.RandomState(1)
    data = rng.uniform(-2, 3, (300, 2))
    spec = mt.make_mesh_spec(data, (7, 5), config=MeshConfig(delta_mode=mode), device="cpu")
    js = jmesh.make_mesh_spec(jnp.asarray(data), (7, 5), config=JMeshConfig(delta_mode=mode))
    for a, b in zip(spec.knots, js.knots):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    np.testing.assert_allclose(spec.deltas.numpy(), np.asarray(js.deltas), rtol=1e-6)
    assert spec.regular and spec.m == js.m
    got = mt.gen_mesh(data, (7, 5), config=MeshConfig(delta_mode=mode), device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(jmesh.gen_mesh(data, (7, 5))))
    user = np.asarray(jmesh.gen_mesh(data, (7, 5))) * 2.0 + 1.0
    assert np.array_equal(mt.gen_mesh(data, (7, 5), mesh=user, device="cpu").numpy(),
                          np.asarray(jmesh.gen_mesh(data, (7, 5), mesh=user)))
    with pytest.raises(ValueError):
        mt.gen_mesh(data, (7, 5), mesh=rng.randn(35, 2), device="cpu")


def test_flat_orders_match_jax():
    m = (3, 4, 2)
    v = torch.arange(24.0)
    back = mesh_lib.unflatten_ref_order(v, m)
    assert np.array_equal(back.numpy(), np.asarray(jmesh.unflatten_ref_order(jnp.arange(24.0), m)))
    assert np.array_equal(mesh_lib.flatten_ref_order(back).numpy(), v.numpy())
    flat = np.random.RandomState(2).randint(0, 24, 50)
    assert np.array_equal(mesh_lib.ref_flat_to_multi(flat, m), jmesh.ref_flat_to_multi(flat, m))


def test_kdtree_matches_bruteforce():
    """The port's own build of the kd-tree (not the JAX package's library)
    against the float64 scan, in 3-D and 2-D."""
    rng = np.random.RandomState(3)
    data, mesh = rng.uniform(-1, 1, (2000, 3)), rng.uniform(-1, 1, (500, 3))
    assert np.array_equal(loader.nearest_kdtree(data, mesh), brute64(data, mesh))
    data, mesh = rng.uniform(-1, 1, (300, 2)), rng.uniform(-1, 1, (120, 2))
    assert np.array_equal(loader.nearest_brute(data, mesh), brute64(data, mesh))
    assert "multivartv_tpu_torch" in str(loader.build())


def test_kdtree_ties_and_1d():
    mesh = np.array([[0.0, 0.0], [1.0, 1.0], [1.0, 1.0], [0.0, 0.0]])
    assert loader.nearest_kdtree(np.array([[0.1, 0.1], [0.9, 0.9]]), mesh).tolist() == [0, 1]
    mesh1 = np.linspace(0, 1, 11)[:, None]
    data1 = np.array([[0.0], [0.24], [0.26], [1.5]])
    assert loader.nearest_kdtree(data1, mesh1).tolist() == [0, 2, 3, 10]


@pytest.mark.parametrize("m", [(9, 13), (5, 4, 7), (1, 6), (12,)])
def test_bin_regular_matches_the_ports_binning(m):
    """native.bin_regular (the closed-form regular-lattice binning, float64
    on the host) against the port's own device binning (mesh.py's
    nearest_knot_multi_index, C-order flat index) on make_mesh_spec's
    lattice, as tests/test_native.py holds the JAX package's against its
    own; samples outside the knots clip to the edge knots, and an axis of
    one knot bins to 0.  Then the exported surface: available(), and
    config.DEFAULT_CV, the default CVConfig, equal to the JAX package's."""
    from multivartv_tpu.config import DEFAULT_CV as JDEFAULT_CV
    from multivartv_tpu_torch import config, native

    rng = np.random.RandomState(117)
    data = rng.uniform(-2, 3, (1500, len(m)))
    spec = mesh_lib.make_mesh_spec(data, m, device="cpu")
    want = interp.flat_knot_indices(spec, t32(data)).numpy()
    knot0 = [float(k[0]) for k in spec.knots]
    spacing = [(float(k[-1]) - float(k[0])) / max(len(k) - 1, 1) for k in spec.knots]
    got = native.bin_regular(data, knot0, spacing, spec.m)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    outside = np.full((2, len(m)), -9.0)
    outside[1] = 9.0
    edge = native.bin_regular(outside, knot0, spacing, spec.m)
    assert edge[0] == 0 and edge[1] == int(np.prod(m)) - 1
    assert native.available() is True
    assert config.DEFAULT_CV == config.CVConfig()
    assert {f: getattr(config.DEFAULT_CV, f) for f in ("folds", "seed", "vmap_folds")} == \
        {f: getattr(JDEFAULT_CV, f) for f in ("folds", "seed", "vmap_folds")}


def jittered(n=400, seed=7):
    """test_api.py's point-cloud case: a 3 x 3 lattice mesh, jittered."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 2))
    y = np.exp(-(x ** 2).sum(1)) + rng.randn(n) * 0.1
    base = np.asarray(jmesh.gen_mesh(x, (3, 3)))
    return x, y, base + rng.normal(0, 0.02, base.shape)


def test_pointcloud_indices_match_jax():
    """pointcloud_flat_c_indices: host numpy data through the kd-tree and a
    tensor through the brute force, each equal to JAX's (numpy: its
    kd-tree; jnp: its batched scan) and to the float64 scan."""
    x, _, pts = jittered(600)
    spec = mesh_lib.PointCloudMeshSpec(points=t32(pts), deltas=t32([0.5, 0.5]), m=(3, 3))
    jspec = jmesh.PointCloudMeshSpec(points=jnp.asarray(pts, jnp.float32),
                                     deltas=jnp.asarray([0.5, 0.5]), m=(3, 3))
    host = interp.flat_knot_indices(spec, x).numpy()
    dev = interp.flat_knot_indices(spec, t32(x)).numpy()
    assert np.array_equal(host, np.asarray(jinterp.flat_knot_indices(jspec, x)))
    assert np.array_equal(dev, np.asarray(jinterp.flat_knot_indices(jspec, jnp.asarray(x, jnp.float32))))
    want = mesh_lib.flat_index_c(torch.as_tensor(
        mesh_lib.ref_flat_to_multi(brute64(x, pts.astype(np.float32).astype(np.float64)), (3, 3))),
        (3, 3)).numpy()
    assert np.array_equal(host, want) and np.array_equal(dev, want)


def test_pointcloud_mvtv_matches_jax():
    """mvtv(x, y, m=(3, 3), mesh=jitter, folds=1) as JAX's test_api.py:118:
    the mesh returned as given, fitted values theta at each sample's
    nearest jittered knot, predict = fitted.  The exact route equals JAX's
    CPU route (the same iterations per lambda); the default kernel route
    (B4's plain version, chunks of 4 iterations) picks JAX's lambda and
    keeps its curve within 1e-3 (chip_smoke.py's MVTV_CURVE)."""
    x, y, jitter = jittered()
    jm = japi.mvtv(x, y, m=(3, 3), mesh=jitter, n_lambda=8, folds=1)
    jc = np.asarray(jm.cv_mses, np.float64)
    exact = mt.mvtv(x, y, m=(3, 3), mesh=jitter, n_lambda=8, folds=1, device="cpu",
                    solver_config=mt.SolverConfig(use_kernels=False))
    assert [e["iters"] for e in exact.models] == [e["iters"] for e in jm.models]
    np.testing.assert_allclose(exact.cv_mses, jc, rtol=1e-5)
    np.testing.assert_allclose(exact.theta_hat, np.asarray(jm.theta_hat), rtol=1e-5, atol=1e-6)
    model = mt.mvtv(x, y, m=(3, 3), mesh=jitter, n_lambda=8, folds=1, device="cpu")
    assert isinstance(model.mesh_spec, mesh_lib.PointCloudMeshSpec)
    np.testing.assert_allclose(model.mesh, jitter.astype(np.float32))
    np.testing.assert_allclose(model.mesh_spec.deltas.numpy(), np.asarray(jm.mesh_spec.deltas))
    assert model.lambda_minmse_ind == jm.lambda_minmse_ind
    np.testing.assert_allclose(model.cv_mses, jc, rtol=1e-3)
    np.testing.assert_allclose(model.predict(x), model.fitted, atol=1e-6)
    np.testing.assert_allclose(model.fitted, model.theta_hat[brute64(x, jitter)], atol=1e-5)
    new = np.random.RandomState(9).uniform(-1, 1, (50, 2))
    np.testing.assert_allclose(exact.predict(new), np.asarray(jm.predict(new)), rtol=1e-5,
                               atol=1e-6)


def test_irregular_lattice_fit_and_predict_match_jax():
    """mvtv_one and predict_mvtv on an irregular 2-D lattice mesh= (a
    MeshSpec with regular=False) against JAX's."""
    rng = np.random.RandomState(4)
    x = rng.uniform(0, 1, (500, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1] + rng.randn(500) * 0.1
    k0, k1 = np.sort(rng.uniform(0, 1, 6)), np.sort(rng.uniform(0, 1, 5))
    mesh = np.asarray(jmesh.lattice_points((jnp.asarray(k0), jnp.asarray(k1)), (6, 5)))
    res = mt.mvtv_one(x, y, m=(6, 5), mesh=mesh, lam=0.5, device="cpu")
    jres = japi.mvtv_one(x, y, m=(6, 5), mesh=mesh, lam=0.5)
    assert not res["mesh_spec"].regular and not jres["mesh_spec"].regular
    np.testing.assert_allclose(res["mesh"], np.asarray(jres["mesh"]))
    np.testing.assert_allclose(res["theta_hat"], np.asarray(jres["theta_hat"]), rtol=1e-3,
                               atol=1e-4)
    new = rng.uniform(-0.1, 1.1, (80, 2))
    np.testing.assert_allclose(mt.predict_mvtv(res, new), np.asarray(japi.predict_mvtv(jres, new)),
                               rtol=1e-3, atol=1e-4)
