"""The port's exact p = 1 x-update (solver/tridiag.py, the plain version of
T1 = ops/kernels.py::xupdate_tridiag) and the 1-D fused lasso (m = N,
mesh = x) against the JAX package's cyclic reduction, a float64 banded
solve and tests/golden.py, on the CPU."""

import numpy as np
import pytest
import scipy.linalg

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import golden
from multivartv_tpu import api as japi
from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.solver import cv as jcv
from multivartv_tpu.solver import problem as jproblem
from multivartv_tpu.solver import tridiag as jtri
import multivartv_tpu_torch as mt
from multivartv_tpu_torch import mesh as mesh_lib
from multivartv_tpu_torch.config import SolverConfig
from multivartv_tpu_torch.ops import interp
from multivartv_tpu_torch.ops import kernels as K
from multivartv_tpu_torch.solver import admm, cv, tridiag
from multivartv_tpu_torch.solver.problem import build_operators

# JAX's tolerance for its CR against a dense solve (tests/test_tridiag.py:33-44)
TOL = 5e-6


def banded64(counts, b, rho, s):
    """x of (diag(counts) + g T) x = b in float64, g = (rho s) s in float32."""
    n = len(counts)
    g = float(np.float32(np.float32(rho) * np.float32(s)) * np.float32(s))
    diag = np.asarray(counts, np.float64) + g * (2.0 - (np.arange(n) == 0) - (np.arange(n) == n - 1))
    ab = np.zeros((3, n))
    ab[0, 1:] = -g
    ab[1] = diag
    ab[2, :-1] = -g
    return scipy.linalg.solve_banded((1, 1), ab, np.asarray(b, np.float64))


def system(n, seed, empty=0.0):
    """Poisson(2) counts (a share `empty` of them set to 0) and N(0, 1) b."""
    rng = np.random.RandomState(seed)
    counts = rng.poisson(2, n).astype(np.float32)
    counts[rng.uniform(size=n) < empty] = 0.0
    if counts.max() == 0:
        counts[0] = 1.0
    return counts, rng.randn(n).astype(np.float32)


def port_x(counts, b, rho, s, fn=tridiag.xupdate_tridiag):
    return fn(torch.as_tensor(counts), torch.as_tensor(b), torch.tensor(rho, dtype=torch.float32),
              s).numpy()


# --- A float32 mirror of T1's segment solve (csrc/tridiag.cu) --------------
# A block is two rows (a, b, c, d) of a reduced system, its first and last:
# the first couples the block before's last unknown (a) and its own last
# (c), the last its own first (a) and the next block's first (c).

def _eliminate(rows):
    """Each chunk's interior eliminated by two Thomas sweeps (the kernel's
    `eliminate`), vectorised across chunks: rows (chunks, C, 4) -> the
    chunks' first and last block rows, (chunks, 4) each."""
    a, b, c, d = rows.unbind(-1)
    C = rows.shape[1]
    A, Cc, D = a[:, 1] / b[:, 1], c[:, 1] / b[:, 1], d[:, 1] / b[:, 1]
    for k in range(2, C - 1):
        inv = 1.0 / (b[:, k] - a[:, k] * Cc)
        A, D, Cc = -a[:, k] * A * inv, (d[:, k] - a[:, k] * D) * inv, c[:, k] * inv
    k = C - 2
    Ap, Cp, Dp = a[:, k] / b[:, k], c[:, k] / b[:, k], d[:, k] / b[:, k]
    for k in range(C - 3, 0, -1):
        inv = 1.0 / (b[:, k] - c[:, k] * Ap)
        Ap, Cp, Dp = a[:, k] * inv, -c[:, k] * Cp * inv, (d[:, k] - c[:, k] * Dp) * inv
    first = torch.stack([a[:, 0], b[:, 0] - c[:, 0] * Ap, -c[:, 0] * Cp, d[:, 0] - c[:, 0] * Dp], -1)
    last = torch.stack([-a[:, -1] * A, b[:, -1] - a[:, -1] * Cc, c[:, -1], d[:, -1] - a[:, -1] * D],
                       -1)
    return first, last


def _recover(rows, x0, xl):
    """Each chunk's x from its end values (the kernel's `recover`)."""
    a, b, c, d = (v.clone() for v in rows.unbind(-1))
    C = rows.shape[1]
    d[:, 1] -= a[:, 1] * x0
    a[:, 1] = 0.0
    d[:, C - 2] -= c[:, C - 2] * xl
    c[:, C - 2] = 0.0
    cp, dp = torch.zeros_like(a), torch.zeros_like(a)
    cprev = dprev = torch.zeros_like(x0)
    for k in range(1, C - 1):
        inv = 1.0 / (b[:, k] - a[:, k] * cprev)
        cp[:, k], dp[:, k] = c[:, k] * inv, (d[:, k] - a[:, k] * dprev) * inv
        cprev, dprev = cp[:, k], dp[:, k]
    x = torch.zeros_like(a)
    x[:, 0], x[:, C - 1] = x0, xl
    nxt = dp[:, C - 2]
    x[:, C - 2] = nxt
    for k in range(C - 3, 0, -1):
        nxt = dp[:, k] - cp[:, k] * nxt
        x[:, k] = nxt
    return x


def _levels(N):
    """tree_reduce's levels over N blocks: (w, s, e) with s the merging
    nodes' first blocks and e their last."""
    w, out = 1, []
    while w < N:
        s = torch.arange(0, N, 2 * w)
        s = s[s + w < N]
        out.append((w, s, torch.clamp(s + 2 * w, max=N) - 1))
        w *= 2
    return out


def _merge(F1, L1, F2, L2):
    """The kernel's `merge`, on (.., 4) rows: the new outer rows."""
    inv = 1.0 / (L1[..., 1] * F2[..., 1] - L1[..., 2] * F2[..., 0])
    p, q = F1[..., 2] * inv, L2[..., 0] * inv
    f = torch.stack([F1[..., 0], F1[..., 1] - p * F2[..., 1] * L1[..., 0],
                     p * L1[..., 2] * F2[..., 2],
                     F1[..., 3] - p * (F2[..., 1] * L1[..., 3] - L1[..., 2] * F2[..., 3])], -1)
    l = torch.stack([q * F2[..., 0] * L1[..., 0], L2[..., 1] - q * L1[..., 1] * F2[..., 2],
                     L2[..., 2],
                     L2[..., 3] - q * (L1[..., 1] * F2[..., 3] - F2[..., 0] * L1[..., 3])], -1)
    return f, l


def _split(L1, F2, xs, xe):
    """The kernel's `split`: the inner unknowns from the outer ones."""
    inv = 1.0 / (L1[..., 1] * F2[..., 1] - L1[..., 2] * F2[..., 0])
    r1, r2 = L1[..., 3] - L1[..., 0] * xs, F2[..., 3] - F2[..., 2] * xe
    return (F2[..., 1] * r1 - L1[..., 2] * r2) * inv, (L1[..., 1] * r2 - F2[..., 0] * r1) * inv


def _tree_reduce(F, L):
    """Merge the blocks of each row of F, L (batch, N, 4) pairwise to one,
    in place: a node's first row at F[:, s], its last at L[:, e]."""
    for w, s, e in _levels(F.shape[1]):
        F[:, s], L[:, e] = _merge(F[:, s], L[:, s + w - 1], F[:, s + w], L[:, e])


def _tree_split(F, L, xf, xl):
    """From the roots' end values (xf[:, 0], xl[:, -1]) to every block's."""
    for w, s, e in reversed(_levels(F.shape[1])):
        xl[:, s + w - 1], xf[:, s + w] = _split(L[:, s + w - 1], F[:, s + w], xf[:, s], xl[:, e])


def partition_solve(counts, b, rho, s, segment, chunk, global_tree=False):
    """T1's segment solve in float32 PyTorch, step for step: the first
    level's rows (identity rows past n up to whole segments), each chunk's
    interior eliminated, each segment's chunks merged to its two end rows,
    the segments' reduced system solved (by tridiag.cr_solve, or by the
    kernel's tree over segments with global_tree), then each segment's
    tree split back down to its chunks' ends and their interiors
    recovered."""
    n = counts.shape[0]
    T = segment // chunk
    assert T * chunk == segment and chunk >= 3
    G = -(-n // segment)
    N = G * segment
    g = (torch.tensor(rho, dtype=torch.float32) * s) * s
    i = torch.arange(N)
    t = 2.0 - (i == 0).float() - (i == n - 1).float()
    pad = lambda v, fill: torch.cat([v, torch.full((N - n,), fill)])
    real = i < n
    rows = torch.stack([
        torch.where((i > 0) & real, -g, torch.zeros(())),
        torch.where(real, pad(counts, 0.0) + g * t, torch.ones(())),
        torch.where(i < n - 1, -g, torch.zeros(())),
        pad(b, 0.0)], -1).reshape(G * T, chunk, 4)
    F, L = _eliminate(rows)
    F, L = F.reshape(G, T, 4), L.reshape(G, T, 4)
    _tree_reduce(F, L)
    Fs, Ls = F[:, 0].clone(), L[:, T - 1].clone()
    if global_tree:
        Fg, Lg = Fs[None].clone(), Ls[None].clone()
        _tree_reduce(Fg, Lg)
        f, l = Fg[0, 0], Lg[0, G - 1]
        inv = 1.0 / (f[1] * l[1] - f[2] * l[0])
        xf, xl = torch.zeros(1, G), torch.zeros(1, G)
        xf[0, 0], xl[0, G - 1] = (l[1] * f[3] - f[2] * l[3]) * inv, (f[1] * l[3] - l[0] * f[3]) * inv
        _tree_split(Fg, Lg, xf, xl)
        xs, xe = xf[0], xl[0]
    else:
        red = torch.stack([Fs, Ls], 1).reshape(2 * G, 4)
        ends = tridiag.cr_solve(*red.unbind(-1)).reshape(G, 2)
        xs, xe = ends[:, 0], ends[:, 1]
    xf, xl = torch.zeros(G, T), torch.zeros(G, T)
    xf[:, 0], xl[:, T - 1] = xs, xe
    _tree_split(F, L, xf, xl)
    return _recover(rows, xf.reshape(-1), xl.reshape(-1)).reshape(-1)[:n]


# (n, segment, chunk): segments that divide n and segments that do not;
# the kernel's own cuts among them (csrc/tridiag.cu `plan`: 316 knots one
# 384-row segment of 4-row chunks, 4,096 one of 16-row chunks, 4,097 and
# 10^5 segments of 1,024 rows in 4-row chunks; above 135,168 rows, 4,096-row
# segments of 16-row chunks).
PARTITIONS = [
    (1, 128, 4), (1, 16, 16),
    (2, 4, 4), (2, 512, 16),
    (3, 3, 3), (3, 128, 4),
    (31, 31, 31), (31, 16, 4),
    (32, 16, 4), (32, 12, 4),
    (33, 33, 3), (33, 16, 4),
    (316, 4, 4), (316, 384, 4),
    (4096, 4096, 16), (4096, 1000, 4),
    (4097, 4097, 17), (4097, 1024, 4),
    (100_000, 4000, 16), (100_000, 1024, 4),
]


@pytest.mark.parametrize("g", [1e-4, 1.0, 50.0])
@pytest.mark.parametrize("n,segment,chunk", PARTITIONS)
def test_partition_solve_matches_jax_and_banded(n, segment, chunk, g):
    """The mirror of T1's segment solve against JAX's cyclic reduction and
    the float64 banded solve, at TOL of max|x|, a fifth of the knots empty
    (the segments' system by cr_solve and by the kernel's tree)."""
    counts, b = system(n, 1000 + n, empty=0.2)
    ref = banded64(counts, b, g, 1.0)
    scale = np.max(np.abs(ref))
    xj = np.asarray(jtri.xupdate_tridiag(jnp.asarray(counts), jnp.asarray(b), jnp.float32(g),
                                         jnp.float32(1.0)))
    for tree in (False, True):
        x = partition_solve(torch.as_tensor(counts), torch.as_tensor(b), g, 1.0, segment, chunk,
                            global_tree=tree).numpy()
        assert x.dtype == np.float32 and np.all(np.isfinite(x))
        assert np.max(np.abs(x - ref)) / scale < TOL
        assert np.max(np.abs(x - xj)) / scale < TOL


@pytest.mark.parametrize("n", [1, 2, 3, 64, 1000, 4097, 1 << 15])
def test_xupdate_tridiag_matches_banded_and_jax(n):
    counts, b = system(n, n)
    rho, s = 0.7, 1.3
    x = port_x(counts, b, rho, s)
    ref = banded64(counts, b, rho, s)
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(x - ref)) / scale < TOL
    xj = np.asarray(jtri.xupdate_tridiag(jnp.asarray(counts), jnp.asarray(b), jnp.float32(rho),
                                         jnp.float32(s)))
    assert np.max(np.abs(x - xj)) / scale < TOL


@pytest.mark.parametrize("g", [1e-4, 1e-2, 1.0, 50.0])
def test_xupdate_tridiag_conditioning_and_empty_knots(g):
    """g = rho s^2 from 1e-4 to 50 (the ill-conditioned end of JAX's
    docstring, tridiag.py:212-219), a third of the knots empty."""
    counts, b = system(5000, 11, empty=0.33)
    x = port_x(counts, b, g, 1.0)
    ref = banded64(counts, b, g, 1.0)
    assert np.max(np.abs(x - ref)) / max(1.0, np.max(np.abs(ref))) < TOL


def test_cr_solve_general_system():
    """cr_solve on a general diagonally dominant system, every length up to
    17 (the power-of-two padding at each)."""
    rng = np.random.RandomState(3)
    for n in range(1, 18):
        a = rng.uniform(-1, 0, n).astype(np.float32)
        c = rng.uniform(-1, 0, n).astype(np.float32)
        a[0] = c[-1] = 0.0
        bb = (np.abs(a) + np.abs(c) + rng.uniform(0.1, 1, n)).astype(np.float32)
        d = rng.randn(n).astype(np.float32)
        dense = np.diag(bb.astype(np.float64)) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)
        x = tridiag.cr_solve(*(torch.as_tensor(v) for v in (a, bb, c, d))).numpy()
        xj = np.asarray(jtri.cr_solve(*(jnp.asarray(v) for v in (a, bb, c, d))))
        ref = np.linalg.solve(dense, d.astype(np.float64))
        assert np.max(np.abs(x - ref)) < 1e-5 * max(1.0, np.max(np.abs(ref)))
        assert np.max(np.abs(x - xj)) < 1e-5 * max(1.0, np.max(np.abs(ref)))


def test_wrapper_runs_the_plain_version_on_the_cpu():
    """T1's wrapper on CPU tensors is the plain CR, bit for bit, and counts
    no launch; it refuses what the kernel does not take."""
    counts, b = system(300, 5)
    K.reset_launch_counts()
    x = port_x(counts, b, 0.4, 0.9, K.xupdate_tridiag)
    assert np.array_equal(x, port_x(counts, b, 0.4, 0.9))
    assert K.launch_counts["xupdate_tridiag"] == 0
    with pytest.raises(ValueError):
        K.xupdate_tridiag(torch.zeros(4), torch.zeros(5), torch.tensor(1.0), 1.0)
    with pytest.raises(ValueError):
        K.xupdate_tridiag(torch.zeros(4, dtype=torch.float64), torch.zeros(4, dtype=torch.float64),
                          torch.tensor(1.0), 1.0)


def test_tridiag_applies_matches_jax_gate():
    """tridiag_applies and the route it gives, against JAX's gate
    (tests/test_tridiag.py:63-71)."""
    for cfg_kw in ({}, {"x_solver": "jacobi_pcg"}, {"x_solver": "cg"},
                   {"x_solver": "dct_direct"}, {"stop_rule": "theta_inf"}):
        cfg, jcfg = SolverConfig(**cfg_kw), JSolverConfig(**cfg_kw)
        for m, d in (((37,), [0.1]), ((8, 8), [0.1, 0.1])):
            ops = build_operators(m, d, cfg, "cpu")
            jops = jproblem.build_operators(m, jnp.asarray(d), jcfg, jnp.float32)
            assert tridiag.tridiag_applies(ops, cfg) == jtri.tridiag_applies(jops, jcfg)
    ops1 = build_operators((37,), [0.1], SolverConfig(), "cpu")
    assert admm.solve_route(ops1, SolverConfig()) == "tridiag"
    assert admm.solve_route(ops1, SolverConfig(use_kernels=False)) is None
    assert admm.solve_route(ops1, SolverConfig(x_solver="jacobi_pcg")) is None
    # the elements of a batched solve (CV folds) keep the route, escape off
    el = admm._element_config(ops1, SolverConfig())
    assert el.use_kernels and not el.bf16_residual_escape
    assert admm.solve_route(ops1, el) == "tridiag"
    assert not admm.batched_kernel_route(ops1, None, SolverConfig())


def fused_lasso(n, seed=117):
    """The 1-D fused lasso's data: sorted x ~ U(0, 1), a step plus noise."""
    rng = np.random.RandomState(seed)
    x = np.sort(rng.uniform(0, 1, n))
    return x, (x > 0.5).astype(float) + rng.randn(n) * 0.1


def test_fused_lasso_mvtv_one_matches_golden():
    """mvtv_one(x, y, m=(n,), mesh=x) at n = 200, lambda = 0.05: the
    objective within 1e-4 of the float64 golden ADMM's, 0 CG steps, no
    iteration on the exact route (tests/test_tridiag.py:74-98)."""
    n, lam = 200, 0.05
    x, y = fused_lasso(n)
    K.reset_launch_counts()
    res = mt.mvtv_one(x, y, m=(n,), mesh=x[:, None], lam=lam, device="cpu")
    d = res["diagnostics"]
    assert d["converged"] and d["cg_iterations"] == 0 and d["exact_iterations"] == 0
    spec = res["mesh_spec"]
    assert isinstance(spec, mesh_lib.MeshSpec) and not spec.regular
    flat = interp.flat_knot_indices(spec, torch.as_tensor(x[:, None], dtype=torch.float32))
    deltas = spec.deltas.double().numpy()
    theta = res["theta_lattice"].astype(np.float64)
    obj = float(golden.objective(flat.numpy(), y, spec.m, deltas, theta, lam))
    g = golden.admm_golden(flat.numpy(), y, spec.m, deltas, lam)
    gobj = float(golden.objective(flat.numpy(), y, spec.m, deltas, g["theta"], lam))
    assert abs(obj - gobj) <= 1e-4 * abs(gobj)
    np.testing.assert_allclose(res["mesh"], x[:, None].astype(np.float32))


def objective64(model, i):
    """0.5 ||y - fitted||^2 + lambda ||D theta||_1 of a 1-D model's fit at
    lambda index i, in float64 (at p = 1 D is the unscaled first
    difference: its block scale is the empty product of cell sizes)."""
    if i == model.lambda_minmse_ind:
        th, fitted = model.theta_lattice, model.fitted
    else:
        th, fitted = model.models[i]["theta_hat"], model.models[i]["fitted"]
    fid = 0.5 * np.sum((model.y - np.asarray(fitted, np.float64)) ** 2)
    return fid + float(model.lambdas[i]) * np.abs(np.diff(np.asarray(th, np.float64))).sum()


def test_fused_lasso_mvtv_matches_jax(monkeypatch):
    """mvtv(x, y, m=(n,), mesh=x, folds=3, n_lambda=5) with JAX's fold
    labels: the chosen index in JAX's tie set, the objective at it within
    2e-5 of JAX's, the CV curve at rtol 1e-4, T1 on every fold."""
    n, folds = 200, 3
    x, y = fused_lasso(n, seed=5)
    labels = torch.as_tensor(np.array(jcv.kfold_indices(n, folds, 123)), dtype=torch.int64)
    monkeypatch.setattr(cv, "kfold_indices", lambda n_, k, seed: labels)
    calls = []
    plain = K.xupdate_tridiag_reference
    monkeypatch.setattr(K, "xupdate_tridiag_reference",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    jm = japi.mvtv(x, y, m=(n,), mesh=x[:, None], folds=folds, n_lambda=5)
    pm = mt.mvtv(x, y, m=(n,), mesh=x[:, None], folds=folds, n_lambda=5, device="cpu")
    jc = np.asarray(jm.cv_mses, np.float64)
    ties = np.nonzero(jc <= jc.min() * (1 + 1e-4))[0].tolist()
    assert pm.lambda_minmse_ind in ties
    np.testing.assert_allclose(pm.cv_mses, jc, rtol=1e-4)
    i = pm.lambda_minmse_ind
    assert abs(objective64(pm, i) / objective64(jm, i) - 1) <= 2e-5
    assert calls and all(sh == (n,) for sh in calls)
    np.testing.assert_allclose(pm.mesh, np.asarray(jm.mesh))
