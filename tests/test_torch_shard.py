"""The row-slab kernels of the sharded route (B8s, B9s, B11s) against the
JAX package's *_shard Pallas wrappers on the CPU.

The JAX side runs its shard kernels as tests/test_tiled_shard.py reaches
them, directly and in interpret mode (under jax.jit, so that the four
slabs share one compile), with 32-row panels so a 64-row slab holds two;
each of the S = 4 row slabs of a (256, 128) lattice gets the
same 8-row halo arrays (the neighbours' boundary rows, zeros at the global
edges) and global row offset on both sides.  On CPU tensors the port's
wrappers run their plain versions.  The concatenation of the slabs is also
held against the whole-lattice plain versions (B8, B9, B2)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from multivartv_tpu.config import SolverConfig as JSolverConfig
from multivartv_tpu.ops import diff as jdiff
from multivartv_tpu.ops import pallas_kernels as pk
from multivartv_tpu.solver import admm as jadmm
from multivartv_tpu.solver import problem as jproblem
from multivartv_tpu_torch import convert
from multivartv_tpu_torch.config import SolverConfig
from multivartv_tpu_torch.ops import kernels as K
from multivartv_tpu_torch.parallel import tiled_shard
from multivartv_tpu_torch.parallel.sharding import RowGroup, RowSlab
from multivartv_tpu_torch.solver import admm

M = (256, 128)
S = 4
ROWS = M[0] // S
HALO = pk.HALO
BINS = ((1, 1), (0, 1), (1, 0))
DELTAS = np.asarray([0.4, 0.9], np.float32)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    scales = tuple(float(s) for s in jdiff.delta_scales(BINS, jnp.asarray(DELTAS)))
    edge = [np.asarray(jdiff.edge_mask(M, b, jnp.float32)) for b in BINS]

    def lat():
        return rng.randn(*M).astype(np.float32)

    theta = lat()
    u = tuple((lat() * e).astype(np.float32) for e in edge)
    alpha = tuple((lat() * e).astype(np.float32) for e in edge)
    counts = rng.poisson(2, M).astype(np.float32)
    return scales, theta, u, alpha, counts, lat(), lat(), lat()


def _slab(x, r):
    return x[r * ROWS:(r + 1) * ROWS]


def _halos(x, r):
    """(top, bot): the HALO rows above and below slab r, zeros at the
    global edges."""
    z = np.zeros((HALO, M[1]), np.float32)
    top = x[r * ROWS - HALO:r * ROWS] if r > 0 else z
    bot = x[(r + 1) * ROWS:(r + 1) * ROWS + HALO] if r < S - 1 else z
    return top, bot


def _pair(xs, r):
    tops, bots = zip(*(_halos(x, r) for x in xs))
    return list(tops), list(bots)


def _t(xs):
    return [torch.as_tensor(x) for x in xs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


@functools.lru_cache(maxsize=None)
def _jitted(fn, **static):
    """pk.<fn> in interpret mode with 32-row panels, jitted with the
    keyword arguments `static` fixed (the row offset stays traced)."""
    return jax.jit(functools.partial(getattr(pk, fn), interpret=True, tile_rows=32, **static),
                   static_argnums=(5,) if fn != "rhs_tiled_2d_shard" else ())


@pytest.mark.parametrize("true_m", [None, (250, 100)])
@pytest.mark.parametrize("want_alpha", [True, False])
def test_dual_update_tiled_shard_matches_jax(true_m, want_alpha):
    """B8s on each slab: alpha (or its elision), u_new, the carries dta and
    dtu within 1e-5, the partial Boyd sums within 1e-5 relative; and the
    slabs together against B8's plain version on the whole lattice."""
    scales, theta, u, *_ = _inputs(3)
    kappa, us = np.float32(0.05), np.float32(0.5)
    got_all = []
    for r in range(S):
        tops, bots = _pair((theta, *u), r)
        want = _jitted("dual_update_tiled_2d_shard", true_m=true_m, want_adjoints=True,
                       want_alpha=want_alpha)(
            jnp.asarray(_slab(theta, r)), tuple(_j(_slab(w, r) for w in u)), _j(tops), _j(bots),
            r * ROWS, M[0], jnp.float32(kappa), scales, jnp.float32(us))
        got = K.dual_update_tiled_2d_shard(
            torch.as_tensor(_slab(theta, r)), tuple(_t(_slab(w, r) for w in u)), _t(tops),
            _t(bots), r * ROWS, M[0], torch.tensor(kappa), scales, u_scale=torch.tensor(us),
            true_m=true_m, want_adjoints=True, want_alpha=want_alpha)
        assert (got[0] is None) == (want[0] is None) == (not want_alpha)
        for g, w in zip((*(got[0] or ()), *got[1], got[3], got[4]),
                        (*(want[0] or ()), *want[1], want[3], want[4])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)
        got_all.append(got)
    whole = K.dual_update_tiled_2d_reference(
        torch.as_tensor(theta), tuple(_t(u)), torch.tensor(kappa), scales, torch.tensor(us),
        true_m, True, True)
    for k in range(3):
        np.testing.assert_allclose(torch.cat([g[1][k] for g in got_all]).numpy(),
                                   whole[1][k].numpy(), atol=1e-6)
    for k in (3, 4):
        np.testing.assert_allclose(torch.cat([g[k] for g in got_all]).numpy(),
                                   whole[k].numpy(), atol=1e-6)
    np.testing.assert_allclose(sum(g[2] for g in got_all).numpy(), whole[2].numpy(), rtol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_gram_residual_tiled_shard_matches_jax(fused):
    """B9s on each slab, b given or fused from (oty, dta, u_scale, dtu),
    within 1e-5 of JAX's; the slabs together equal B9's plain version on the
    whole lattice, and the matvec mode B10's."""
    scales, v, _, _, counts, oty, dta, dtu = _inputs(5)
    rho, us = np.float32(0.07), np.float32(0.5)
    b = (oty + rho * (dta + us * dtu)).astype(np.float32)
    got_all, av_all = [], []
    for r in range(S):
        top, bot = _halos(v, r)
        parts = [_slab(x, r) for x in (oty, dta, dtu)]
        jparts = (jnp.asarray(parts[0]), jnp.asarray(parts[1]), jnp.float32(us),
                  jnp.asarray(parts[2])) if fused else None
        want = _jitted("gram_residual_tiled_2d_shard")(
            None if fused else jnp.asarray(_slab(b, r)), jnp.asarray(_slab(v, r)),
            jnp.asarray(top), jnp.asarray(bot), r * ROWS, M[0], jnp.asarray(_slab(counts, r)),
            jnp.float32(rho), scales, jparts)
        tparts = (torch.as_tensor(parts[0]), torch.as_tensor(parts[1]), torch.tensor(us),
                  torch.as_tensor(parts[2])) if fused else None
        got = K.gram_residual_tiled_2d_shard(
            None if fused else torch.as_tensor(_slab(b, r)), torch.as_tensor(_slab(v, r)),
            torch.as_tensor(top), torch.as_tensor(bot), r * ROWS, M[0],
            torch.as_tensor(_slab(counts, r)), torch.tensor(rho), scales, rhs_parts=tparts)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        got_all.append(got)
        av_all.append(K.gram_matvec_tiled_2d_shard(
            torch.as_tensor(_slab(v, r)), torch.as_tensor(top), torch.as_tensor(bot), r * ROWS,
            M[0], torch.as_tensor(_slab(counts, r)), torch.tensor(rho), scales))
    t = torch.as_tensor
    whole = K.gram_residual_tiled_2d_reference(t(b), t(v), t(counts), torch.tensor(rho), scales)
    np.testing.assert_allclose(torch.cat(got_all).numpy(), whole.numpy(), atol=1e-5)
    av = K.gram_matvec_tiled_2d_reference(t(v), t(counts), torch.tensor(rho), scales)
    assert torch.equal(torch.cat(av_all), av)


def test_rhs_tiled_shard_matches_jax():
    """B11s on each slab within 1e-5 of JAX's, and the slabs together equal
    B2's plain version on the whole lattice."""
    scales, _, u, alpha, _, oty, *_ = _inputs(7)
    rho, us = np.float32(0.3), np.float32(1.5)
    got_all = []
    for r in range(S):
        tops, bots = _pair((*alpha, *u), r)
        want = _jitted("rhs_tiled_2d_shard")(
            tuple(_j(_slab(a, r) for a in alpha)), tuple(_j(_slab(w, r) for w in u)), _j(tops),
            _j(bots), r * ROWS, jnp.asarray(_slab(oty, r)), jnp.float32(rho), jnp.float32(us),
            scales)
        got = K.rhs_tiled_2d_shard(
            tuple(_t(_slab(a, r) for a in alpha)), tuple(_t(_slab(w, r) for w in u)), _t(tops),
            _t(bots), r * ROWS, torch.as_tensor(_slab(oty, r)), torch.tensor(rho),
            torch.tensor(us), scales)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        got_all.append(got)
    whole = K.rhs_2d_reference(tuple(_t(alpha)), tuple(_t(u)), torch.as_tensor(oty),
                               torch.tensor(rho), torch.tensor(us), scales)
    assert torch.equal(torch.cat(got_all), whole)


# Uneven cuts of M: np.array_split's 3 slabs (86, 85, 85 rows), and a cut
# whose first slab has 5 rows, so that one tile of 8 rows holds both of that
# slab's halo rows.
CUTS = {"array_split_3": tuple(len(a) for a in np.array_split(np.arange(M[0]), 3)),
        "first_slab_5_rows": (5, 123, 128)}


def _cut_slabs(rows):
    """(row_off, rows) of each slab of a cut."""
    offs = np.cumsum((0,) + rows)
    return [(int(o), int(r)) for o, r in zip(offs[:-1], rows)]


def _cut_halos(x, off, rows):
    """(top, bot): up to HALO rows above and below the slab, zeros at the
    global edges."""
    z = np.zeros((HALO, M[1]), np.float32)
    top = x[max(off - HALO, 0):off] if off > 0 else z
    bot = x[off + rows:off + rows + HALO] if off + rows < M[0] else z
    return top, bot


@functools.lru_cache(maxsize=None)
def _jax_whole(kernel, **kw):
    """JAX's whole-lattice tiled kernel in interpret mode (32-row panels) on
    _inputs(11), as numpy arrays."""
    scales, theta, u, _, counts, oty, dta, dtu = _inputs(11)
    j = jnp.asarray
    if kernel == "dual":
        out = pk.dual_update_tiled_2d(j(theta), tuple(map(j, u)), jnp.float32(0.05), scales,
                                      jnp.float32(0.5), interpret=True, tile_rows=32, **kw)
        return tuple(None if x is None else (tuple(map(np.asarray, x)) if isinstance(x, tuple)
                                             else np.asarray(x)) for x in out)
    rho, us = jnp.float32(0.07), jnp.float32(0.5)
    if kernel == "matvec":
        return np.asarray(pk.gram_matvec_tiled_2d(j(theta), j(counts), rho, scales,
                                                  interpret=True, tile_rows=32))
    b = (oty + np.float32(0.07) * (dta + np.float32(0.5) * dtu)).astype(np.float32)
    parts = (j(oty), j(dta), us, j(dtu)) if kw["fused"] else None
    return np.asarray(pk.gram_residual_tiled_2d(None if kw["fused"] else j(b), j(theta),
                                                j(counts), rho, scales, rhs_parts=parts,
                                                interpret=True, tile_rows=32))


@pytest.mark.parametrize("want_alpha", [True, False])
@pytest.mark.parametrize("cut", sorted(CUTS))
def test_uneven_slabs_dual_match_jax_whole_lattice(cut, want_alpha):
    """B8s's plain version on each slab of an uneven cut, with its halos:
    the slabs' alpha (or its elision), u_new and carries concatenated match
    JAX's whole-lattice dual_update_tiled_2d within 1e-5, their summed Boyd
    sums within rtol 1e-4."""
    scales, theta, u, *_ = _inputs(11)
    got = []
    for off, rows in _cut_slabs(CUTS[cut]):
        tops, bots = zip(*(_cut_halos(x, off, rows) for x in (theta, *u)))
        got.append(K.dual_update_tiled_2d_shard(
            torch.as_tensor(theta[off:off + rows]),
            tuple(torch.as_tensor(w[off:off + rows]) for w in u), _t(tops), _t(bots), off, M[0],
            torch.tensor(0.05), scales, u_scale=torch.tensor(0.5), want_adjoints=True,
            want_alpha=want_alpha))
    want = _jax_whole("dual", want_adjoints=True, want_alpha=want_alpha)
    assert (got[0][0] is None) == (want[0] is None) == (not want_alpha)
    for k in range(3):
        if want_alpha:
            np.testing.assert_allclose(torch.cat([g[0][k] for g in got]).numpy(), want[0][k],
                                       atol=1e-5)
        np.testing.assert_allclose(torch.cat([g[1][k] for g in got]).numpy(), want[1][k],
                                   atol=1e-5)
    for k in (3, 4):
        np.testing.assert_allclose(torch.cat([g[k] for g in got]).numpy(), want[k], atol=1e-5)
    np.testing.assert_allclose(sum(g[2] for g in got).numpy(), want[2], rtol=1e-4)


@pytest.mark.parametrize("mode", ["b_given", "fused", "matvec"])
@pytest.mark.parametrize("cut", sorted(CUTS))
def test_uneven_slabs_gram_match_jax_whole_lattice(cut, mode):
    """B9s's plain version (b given, fused) and its matvec mode on each slab
    of an uneven cut, with v's halos: the slabs concatenated match JAX's
    whole-lattice gram_residual_tiled_2d / gram_matvec_tiled_2d within
    1e-5."""
    scales, v, _, _, counts, oty, dta, dtu = _inputs(11)
    rho, us = torch.tensor(0.07), torch.tensor(0.5)
    b = (oty + np.float32(0.07) * (dta + np.float32(0.5) * dtu)).astype(np.float32)
    got = []
    for off, rows in _cut_slabs(CUTS[cut]):
        t = lambda x: torch.as_tensor(x[off:off + rows])
        top, bot = (torch.as_tensor(h) for h in _cut_halos(v, off, rows))
        if mode == "matvec":
            got.append(K.gram_matvec_tiled_2d_shard(t(v), top, bot, off, M[0], t(counts), rho,
                                                    scales))
            continue
        parts = (t(oty), t(dta), us, t(dtu)) if mode == "fused" else None
        got.append(K.gram_residual_tiled_2d_shard(None if parts else t(b), t(v), top, bot, off,
                                                  M[0], t(counts), rho, scales,
                                                  rhs_parts=parts))
    want = (_jax_whole("matvec") if mode == "matvec"
            else _jax_whole("gram", fused=mode == "fused"))
    np.testing.assert_allclose(torch.cat(got).numpy(), want, atol=1e-5)


def test_one_row_halos_and_bad_arguments():
    """The kernels read one row on each side: one-row halo arrays give the
    8-row ones' results.  Bad halos and offsets raise."""
    scales, theta, u, *_ = _inputs(9)
    kappa = torch.tensor(0.05)
    r = 1
    tops, bots = _pair((theta, *u), r)
    slabs = (torch.as_tensor(_slab(theta, r)), tuple(_t(_slab(w, r) for w in u)))
    eight = K.dual_update_tiled_2d_shard(*slabs, _t(tops), _t(bots), r * ROWS, M[0], kappa,
                                         scales)
    one = K.dual_update_tiled_2d_shard(*slabs, _t(t[-1:] for t in tops),
                                       _t(b[:1] for b in bots), r * ROWS, M[0], kappa, scales)
    for a, b in zip((*eight[0], *eight[1]), (*one[0], *one[1])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):      # a halo of another width
        K.gram_matvec_tiled_2d_shard(slabs[0], torch.zeros(1, 64), torch.zeros(1, 128), 0,
                                     M[0], slabs[0], kappa, scales)
    with pytest.raises(ValueError):      # a slab beyond the lattice
        K.gram_matvec_tiled_2d_shard(slabs[0], torch.zeros(1, 128), torch.zeros(1, 128),
                                     M[0] - 8, M[0], slabs[0], kappa, scales)


def test_dual_struct_probe_plain_version():
    """The structure probe's plain version: copies, and the prox of theta's
    circular forward differences against u, and the sum of d0^2."""
    rng = np.random.RandomState(1)
    ins = [torch.as_tensor(rng.randn(16, 32).astype(np.float32)) for _ in range(4)]
    outs, st = K.dual_struct_reference(ins, 6, prox=False)
    assert st is None and all(torch.equal(o, ins[k % 4]) for k, o in enumerate(outs))
    outs, st = K.dual_struct_reference(ins, 3, prox=True)
    th = ins[0].numpy()
    d0, d1 = np.roll(th, -1, 0) - th, np.roll(th, -1, 1) - th
    for k, o in enumerate(outs):
        z = (d0 if k % 2 else d1) - ins[1 + k % 3].numpy()
        np.testing.assert_allclose(o.numpy(), np.sign(z) * np.maximum(np.abs(z) - 0.01, 0),
                                   atol=1e-6)
    np.testing.assert_allclose(float(st), float(np.sum(d0 * d0)), rtol=1e-5)


def test_slab_from_numpy_cuts_the_jax_fields():
    """convert.slab_from_numpy on a 10 x 9 lattice cut over 3 ranks (no
    collective is needed to cut): the slabs of counts, O'y, theta and every
    block stack to the JAX arrays, gram_eigs is cut by columns, the dense
    DCT matrices and the samples stay whole, and such operators take the
    shard route only under their row group's key."""
    m = (10, 9)
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (300, 2))
    y = x[:, 0] + 0.3 * rng.randn(300)
    from multivartv_tpu import mesh as jmesh
    spec = jmesh.make_mesh_spec(jnp.asarray(x), m)
    jops = jproblem.build_operators(m, spec.deltas, JSolverConfig(), jnp.float32)
    jp = jproblem.build_problem(spec, jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32))
    js = jadmm.initial_state(jops, jp, rho0=jnp.float32(0.1))
    ops_np = dict(binaries=jops.binaries, m=m, scales=[float(v) for v in jops.scales],
                  deltas=np.asarray(jops.deltas), gram_eigs=np.asarray(jops.gram_eigs),
                  dct_mats=[np.asarray(t) for t in jops.dct_mats])
    pr_np = dict(counts=np.asarray(jp.counts), oty=np.asarray(jp.oty), ybar=np.asarray(jp.ybar),
                 flat_idx=np.asarray(jp.flat_idx).astype(np.int64), y=np.asarray(jp.y))
    st_np = dict(theta=np.asarray(js.theta), alpha=[np.asarray(a) for a in js.alpha],
                 u=[np.asarray(w) for w in js.u], rho=np.asarray(js.rho))
    parts = []
    for r in range(3):
        slab = RowSlab(RowGroup(rank=r, size=3), m)
        parts.append((slab, *convert.slab_from_numpy(slab, ops_np, pr_np, st_np, device="cpu")))
    assert [p[0].shape[0] for p in parts] == [4, 3, 3]
    cat = lambda f: torch.cat([f(p) for p in parts]).numpy()
    np.testing.assert_array_equal(cat(lambda p: p[2].counts), pr_np["counts"])
    np.testing.assert_array_equal(cat(lambda p: p[2].oty), pr_np["oty"])
    np.testing.assert_array_equal(cat(lambda p: p[3].theta), st_np["theta"])
    for k in range(3):
        np.testing.assert_array_equal(cat(lambda p: p[3].u[k]), st_np["u"][k])
    np.testing.assert_array_equal(torch.cat([p[1].gram_eigs for p in parts], dim=1).numpy(),
                                  ops_np["gram_eigs"])
    for slab, ops, pr, st in parts:
        assert ops.m == m and ops.local_m == slab.shape and ops.dct_halves is None
        assert ops.dct_mats[0].shape == (10, 10) and pr.y.shape == (300,)
        with pytest.raises(ValueError):      # no key for the operators' row group
            admm.solve_route(ops, SolverConfig())
        key = tiled_shard.register_shard_mesh(slab.group)
        assert admm.solve_route(ops, SolverConfig(tiled_shard_key=key)) == "shard"
