"""The plain versions of the CUDA kernels (what a wrapper runs on a CPU
tensor) against the JAX package's Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them, on the same numpy inputs; and the
wrappers' argument checks.  The kernels themselves run only on the card:
chip_smoke.py holds each against its plain version there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.ops import dct as jdct
from multivartv_tpu.ops import diff as jdiff
from multivartv_tpu.ops import pallas_kernels as pk
from multivartv_tpu.solver.cg import pcg_fused
from multivartv_tpu.solver.problem import build_operators as jbuild_operators
from multivartv_tpu_torch import convert
from multivartv_tpu_torch.ops import kernels as K

M = (16, 32)


def t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def port_ops(jops):
    return convert.operators_from_numpy(
        binaries=jops.binaries, m=jops.m, scales=[np.asarray(s) for s in jops.scales],
        deltas=np.asarray(jops.deltas), gram_eigs=np.asarray(jops.gram_eigs),
        dct_mats=[np.asarray(m) for m in jops.dct_mats],
        dct_halves=[(np.asarray(a), np.asarray(b)) for a, b in jops.dct_halves],
        gram_eigs_packed=np.asarray(jops.gram_eigs_packed), device="cpu")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(3)
    jops = jbuild_operators(M, jnp.asarray([0.4, 0.9], jnp.float32),
                            JSolverConfig(cg_fixed_iters=3), jnp.float32)
    ops = port_ops(jops)
    masks = [np.broadcast_to(np.asarray(jdiff.edge_mask(M, b)), M) for b in jops.binaries]
    d = dict(
        jops=jops, ops=ops,
        theta=rng.randn(*M).astype(np.float32),
        counts=rng.poisson(3, M).astype(np.float32),
        u=[(rng.randn(*M) * mk).astype(np.float32) for mk in masks],
        alpha=[(rng.randn(*M) * mk).astype(np.float32) for mk in masks],
        oty=rng.randn(*M).astype(np.float32),
        b=rng.randn(*M).astype(np.float32),
    )
    return d


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol)


def test_rhs_matches_pallas(setup):
    """test_pallas.py:78-91 tolerance (arrays to 1e-5 here: same f32 stencil)."""
    s = setup
    b = K.rhs_2d(tuple(map(t, s["alpha"])), tuple(map(t, s["u"])), t(s["oty"]), t(0.7),
                 t(0.5), s["ops"].scales)
    jb = pk.rhs_2d(tuple(map(jnp.asarray, s["alpha"])), tuple(map(jnp.asarray, s["u"])),
                   jnp.asarray(s["oty"]), jnp.float32(0.7), jnp.float32(0.5),
                   s["jops"].scales, interpret=True)
    close(b, jb, 1e-5)


@pytest.mark.parametrize("u_scale,true_m,shape", [
    pytest.param(None, None, M, id="None-None"),
    pytest.param(0.5, None, M, id="0.5-None"),
    pytest.param(0.5, (15, 29), M, id="0.5-true_m2"),
    pytest.param(0.5, None, (15, 33), id="0.5-None-odd15x33")])
def test_dual_update_matches_pallas(setup, u_scale, true_m, shape):
    """Arrays to 1e-5, stats to rtol 1e-4 (test_pallas.py:49-60); also on
    an odd, unpadded lattice, the shape class of the whole route's
    cpp_standalone solves (1023^2), where B1's tiles have remainders in
    both axes."""
    s = setup
    if shape == M:
        theta, u = s["theta"], s["u"]
    else:
        rng = np.random.RandomState(4)
        masks = [np.broadcast_to(np.asarray(jdiff.edge_mask(shape, b)), shape)
                 for b in s["jops"].binaries]
        theta = rng.randn(*shape).astype(np.float32)
        u = [(rng.randn(*shape) * mk).astype(np.float32) for mk in masks]
    a, un, st = K.dual_update_2d(t(theta), tuple(map(t, u)), t(0.3), s["ops"].scales,
                                 u_scale=None if u_scale is None else t(u_scale),
                                 true_m=true_m)
    ja, jun, jst = pk.dual_update_2d(
        jnp.asarray(theta), tuple(map(jnp.asarray, u)), jnp.float32(0.3),
        s["jops"].scales, u_scale=None if u_scale is None else jnp.float32(u_scale),
        true_m=true_m, interpret=True)
    for got, want in zip(a + un, tuple(ja) + tuple(jun)):
        close(got, want, 1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-4, atol=1e-4)


def test_xupdate_matches_pallas_and_exact_flip_pcg(setup):
    """Against the interpret kernel, whose flip rounds through bf16
    (test_pallas.py:124,167): 2e-2.  Against JAX's pcg_fused with the
    exact-flip bf16 dct2_packed (the same rounding points): 1e-3 of max|x|.
    The two sum the f32 products in other orders, and a 1-ulp difference
    that moves a value across a bf16 rounding boundary moves x by up to
    ~5e-4 of max|x| at this size (measured over seeds 3-7: 2e-7 .. 4.5e-4),
    so 1e-4 would hold only for seeds that happen to round alike."""
    s, ops, jops = setup, setup["ops"], setup["jops"]
    rho, cbar = 0.7, float(np.mean(s["counts"]))
    x0 = np.zeros(M, np.float32)
    x, rsq = K.xupdate_pcg_2d_packed(t(s["b"]), t(x0), t(s["counts"]), ops.dct_halves_lp,
                                     ops.gram_eigs_packed, t(rho), t(cbar), ops.scales, 3)
    jx, jrsq = pk.xupdate_pcg_2d_packed(
        jnp.asarray(s["b"]), jnp.asarray(x0), jnp.asarray(s["counts"]), jops.dct_halves,
        jops.gram_eigs_packed, jnp.float32(rho), jnp.float32(cbar), jops.scales, 3,
        interpret=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=2e-2, atol=2e-2)

    counts = jnp.asarray(s["counts"])
    w = cbar + rho * jops.gram_eigs_packed

    def matvec_dot(v):
        av = counts * v + rho * jdiff.apply_gram(v, jops.binaries, jops.scales)
        return av, jnp.sum(v * av)

    def precond_dot(r):
        rhat = jdct.dct2_packed(r, *jops.dct_halves, mat_dtype=jnp.bfloat16)
        zhat = rhat / w
        return (jdct.idct2_packed(zhat, *jops.dct_halves, mat_dtype=jnp.bfloat16),
                jnp.sum(rhat * zhat))

    ref = pcg_fused(matvec_dot, precond_dot, jnp.asarray(s["b"]), jnp.asarray(x0), 3)
    scale = float(np.max(np.abs(np.asarray(ref.x))))
    close(x, ref.x, 1e-3 * scale)
    assert np.isfinite(float(rsq)) and np.isclose(float(rsq), float(jrsq), rtol=2e-2)


@pytest.mark.parametrize("true_m", [None, (15, 29)])
def test_admm_iters_matches_pallas(setup, true_m):
    """K = 4 iterations in one call: the same rho/u_scale trajectory and
    norms to rtol 1e-2 (test_pallas.py:212-219)."""
    s, ops, jops = setup, setup["ops"], setup["jops"]
    lam, rho0 = 0.08, 0.016
    oty = s["oty"] * s["counts"]
    zeros = [np.zeros(M, np.float32)] * 3
    cbar = float(np.sum(s["counts"]) / s["counts"].size)
    theta0 = np.full(M, float(np.sum(oty) / np.sum(s["counts"])), np.float32)
    out = K.admm_iters_2d(t(theta0), tuple(map(t, zeros)), tuple(map(t, zeros)),
                          t(s["counts"]), t(oty), ops.dct_halves_lp, ops.gram_eigs_packed,
                          t(lam), t(rho0), t(1.0), t(cbar), ops.scales, k_iters=4, n_steps=3,
                          true_m=true_m)
    jout = pk.admm_iters_2d(
        jnp.asarray(theta0), tuple(map(jnp.asarray, zeros)), tuple(map(jnp.asarray, zeros)),
        jnp.asarray(s["counts"]), jnp.asarray(oty), jops.dct_halves, jops.gram_eigs_packed,
        jnp.float32(lam), jnp.float32(rho0), jnp.float32(1.0), jnp.float32(cbar),
        jops.scales, k_iters=4, n_steps=3, true_m=true_m, interpret=True)
    th, _, _, rho, us, st = out
    jth, _, _, jrho, jus, jst = jout
    assert float(rho) == float(jrho) and float(us) == float(jus)
    scale = float(np.max(np.abs(np.asarray(jth))))
    assert float(np.max(np.abs(th.numpy() - np.asarray(jth)))) < 5e-3 * scale
    np.testing.assert_allclose(np.sqrt(st[0].item()), np.sqrt(float(jst[0])), rtol=1e-2)
    np.testing.assert_allclose(float(rho * us) * np.sqrt(st[3].item()),
                               float(jrho * jus) * np.sqrt(float(jst[3])), rtol=1e-2)


def test_admm_iters_matches_per_iteration_kernels(setup):
    """B4's plain version is the B2 -> B3 -> B1 -> adapt chain: K = 4
    iterations equal four per-iteration steps of the same wrappers."""
    s, ops = setup, setup["ops"]
    lam, rho = t(0.08), t(0.05)
    u, alpha, theta = tuple(map(t, s["u"])), tuple(map(t, s["alpha"])), t(s["theta"])
    counts, oty = t(s["counts"]), t(s["oty"])
    cbar = torch.mean(counts)
    out = K.admm_iters_2d(theta, u, alpha, counts, oty, ops.dct_halves_lp,
                          ops.gram_eigs_packed, lam, rho, t(1.0), cbar, ops.scales, 4, 3)
    us = t(1.0)
    for _ in range(4):
        b = K.rhs_2d(alpha, u, oty, rho, us, ops.scales)
        theta, rsq = K.xupdate_pcg_2d_packed(b, theta, counts, ops.dct_halves_lp,
                                             ops.gram_eigs_packed, rho, cbar, ops.scales, 3)
        alpha, u, st = K.dual_update_2d(theta, u, lam / rho, ops.scales, us)
        rho, us = K.adapt_rho(rho, torch.sqrt(st[0]), rho * torch.sqrt(st[3]), 2.0, 10.0)
    close(out[0], theta, 1e-6)
    assert float(out[3]) == float(rho) and float(out[4]) == float(us)
    close(out[5][:5], st, 1e-3)


def test_wrappers_reject_bad_arguments(setup):
    s, ops = setup, setup["ops"]
    u = tuple(map(t, s["u"]))
    with pytest.raises(ValueError):        # meta device: no kernel, no plain version
        K.dual_update_2d(t(s["theta"]).to("meta"), tuple(x.to("meta") for x in u),
                         t(0.3), ops.scales)
    with pytest.raises(ValueError):        # float64
        K.dual_update_2d(t(s["theta"]).double(), u, t(0.3), ops.scales)
    with pytest.raises(ValueError):        # shape mismatch
        K.rhs_2d(u, u, t(s["oty"])[:, :8], t(0.7), None, ops.scales)
    with pytest.raises(ValueError):        # odd axes for the folded DCT
        odd = torch.zeros((15, 32))
        K.xupdate_pcg_2d_packed(odd, odd, odd, ops.dct_halves_lp, odd, t(0.7), t(1.0),
                                ops.scales, 3)
    with pytest.raises(ValueError):        # non-contiguous
        K.rhs_2d(u, u, t(s["oty"]).T.contiguous().T, t(0.7), None, ops.scales)


def _ctypes_kind(param: str):
    """The ctypes type a C parameter declaration binds to."""
    if "*" in param:
        return K._P
    if "long long" in param:
        return K._LL
    return K._F if param.split()[0] == "float" else K._I


def test_argtypes_match_the_entry_points():
    """Every extern "C" entry point of csrc/*.cu has its ctypes signature
    in _ARGTYPES, parameter for parameter (pointer, float, int, long long),
    and _ARGTYPES names no other function: on the card a missing or short
    signature shows only as a crash or a cut pointer."""
    import re

    from multivartv_tpu_torch.ops import _build

    decl = re.compile(r'extern "C"\s+[\w ]+?\s\**(mvtv_\w+)\s*\(([^)]*)\)')
    found = {}
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        for name, params in decl.findall(src.read_text()):
            params = " ".join(params.split())
            found[name] = [_ctypes_kind(p) for p in params.split(",")] if params else []
    assert found and set(found) == set(K._ARGTYPES)
    for name, kinds in found.items():
        assert K._ARGTYPES[name] == kinds, name


def test_route_uses_the_tensor_device(setup):
    """The CPU route is chosen by the tensors' device only; counters count
    kernel launches, which never happen on the CPU."""
    s, ops = setup, setup["ops"]
    K.reset_launch_counts()
    K.dual_update_2d(t(s["theta"]), tuple(map(t, s["u"])), t(0.3), ops.scales)
    assert all(v == 0 for v in K.launch_counts.values())
    assert K._route(t(s["theta"])) == "cpu"
    with pytest.raises(ValueError):
        K._route(t(s["theta"]).to("meta"))
