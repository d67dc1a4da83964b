"""The port's roofline model (multivartv_tpu_torch/utils/roofline.py): the
JAX package's structural checks (tests/test_roofline.py) on the H100's
peaks, the 2-D and 3-D stage tables equal to the JAX package's where the
two iterations agree, the kernel bounds equal to PERF.md section 6's bound
column, and chip_smoke.py reading its bounds from the module."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from multivartv_tpu.utils import roofline as jrl
from multivartv_tpu_torch.utils import roofline as rl

H100 = "NVIDIA H100 80GB HBM3"


def _gb(stages, ntheta):
    return sum(s.bytes_(ntheta) for s in stages) / 1e9


def test_floor_below_model():
    for m, lay in (((2048, 2048), "quartered"), ((4096, 4096), "quartered"),
                   ((256, 256, 256), "blocked"), ((128, 128, 128), "packed")):
        n = int(np.prod(m))
        assert _gb(rl.floor_stages(m, layout=lay), n) < _gb(rl.iteration_stages(m, layout=lay), n)


def test_block_count_scales_with_p():
    """p = 3 moves 7 blocks through the dual stage; the tiled routes fuse
    b's assembly into r0 and write the 2 carries instead of alpha."""
    s2 = {s.name: s for s in rl.iteration_stages((2048, 2048), vec_bf16=False)}
    s3 = {s.name: s for s in rl.iteration_stages((256, 256, 256), vec_bf16=False)}
    assert "rhs" not in s2 and "rhs" not in s3
    assert s2["cg.r0"].reads == 5 and s3["cg.r0"].reads == 5
    assert s2["dual"].writes == 5 and s3["dual"].writes == 9
    s2u = {s.name: s for s in rl.iteration_stages((2048, 2048), vec_bf16=False, tiled=False)}
    s3u = {s.name: s for s in rl.iteration_stages((256, 256, 256), vec_bf16=False,
                                                  tiled=False)}
    assert s2u["rhs"].reads == 7 and s2u["dual"].writes == 6
    assert s3u["rhs"].reads == 15 and s3u["dual"].writes == 14


def test_bf16_halves_cg_traffic():
    m = (4096, 4096)
    n = int(np.prod(m))
    assert _gb(rl.iteration_stages(m, vec_bf16=True), n) < _gb(
        rl.iteration_stages(m, vec_bf16=False), n)
    for nm in ("dual", "cg.r0"):
        a, b = (next(s for s in rl.iteration_stages(m, vec_bf16=v) if s.name == nm)
                for v in (False, True))
        assert a.bytes_(n) == b.bytes_(n)


def test_auto_rule_matches_solver():
    """The model's default vector type is the solver's
    (xupdate.spectral_vec_dtype): bf16 above 2^23 knots."""
    import torch

    from multivartv_tpu_torch.config import SolverConfig
    from multivartv_tpu_torch.solver import xupdate

    @dataclasses.dataclass
    class Ops:
        ntheta: int

    for m in ((4096, 4096), (2048, 2048), (4096, 2049)):
        n = int(np.prod(m))
        want = 2 if xupdate.spectral_vec_dtype(Ops(n), SolverConfig()) is torch.bfloat16 else 4
        got = {s.name: s.elem_bytes for s in rl.iteration_stages(m)}
        assert got["cg.step.ap[0]"] == want


def test_transform_flops():
    q = rl._transform_flops_per_knot((4096, 4096), "quartered")
    b = rl._transform_flops_per_knot((4096, 4096), "blocked")
    assert abs(q * 2 - b) < 1e-9
    assert abs(q - 2 * (4096 / 4) * 2) < 1e-9
    assert rl._transform_flops_per_knot((2048, 2048), "dense") == 2 * (2048 + 2048)


def test_device_peaks_fallback():
    assert rl.device_peaks(H100) == (3350.0, 989.0)
    assert rl.device_peaks("unknown-part") == rl._DEFAULT_PEAK
    assert abs(rl.PRACTICAL_BW_FRACTION - 0.8514) < 1e-4
    assert rl.PEAK_HBM_BYTES == 3.35e12 and rl.PEAK_BF16_FLOPS == 989e12


def test_model_report_fields():
    """The report's fields (a rate of 11.8 iterations/s is an input here,
    not a measurement)."""
    r = rl.model_report((4096, 4096), kind=H100, measured_iters_per_s=11.8)
    for k in ("model_bound_iters_per_s", "floor_bound_iters_per_s", "frac_of_model_bound",
              "frac_of_floor_bound", "frac_of_practical_bound", "achieved_gbps", "vec_bf16"):
        assert k in r
    assert 0 < r["frac_of_model_bound"] < 1.2
    assert r["floor_bound_iters_per_s"] > r["model_bound_iters_per_s"]
    assert r["practical_bound_iters_per_s"] < r["model_bound_iters_per_s"]


def test_model_report_residency_caveat():
    """A rate whose modelled traffic implies more than the copy probe's
    ceiling is flagged (the inputs are rates, not measurements)."""
    hot = rl.model_report((2048, 2048), kind=H100, measured_iters_per_s=2400.0)
    assert hot["frac_of_model_bound"] > 1.0 and "hbm_model_uninformative" in hot
    cool = rl.model_report((4096, 4096), kind=H100, measured_iters_per_s=11.8)
    assert "hbm_model_uninformative" not in cool


def _fields(stages):
    return [(s.name, s.reads, s.writes, s.flops_per_knot, s.elem_bytes) for s in stages]


@pytest.mark.parametrize("m,layout", [((2048, 2048), "quartered"), ((4096, 4096), "quartered"),
                                      ((256, 256, 256), "blocked"), ((128, 128, 128), "packed"),
                                      ((192, 8192), "packed")])
@pytest.mark.parametrize("tiled", [True, False])
@pytest.mark.parametrize("vec_bf16", [None, False, True])
@pytest.mark.parametrize("n_steps", [3, 5])
def test_stage_tables_equal_jax(m, layout, tiled, vec_bf16, n_steps):
    """The spectral CG's iteration has the JAX package's stages, stage for
    stage (names, arrays read and written, flops, element bytes), and the
    same floor; only the peaks differ."""
    assert _fields(rl.iteration_stages(m, n_steps, layout, tiled, vec_bf16)) == _fields(
        jrl.iteration_stages(m, n_steps, layout, tiled, vec_bf16))
    assert _fields(rl.floor_stages(m, n_steps, layout, vec_bf16)) == _fields(
        jrl.floor_stages(m, n_steps, layout, vec_bf16))
    mine = rl.model_report(m, n_steps, layout, kind=H100, vec_bf16=vec_bf16)
    jax = jrl.model_report(m, n_steps, layout, kind="v5 lite", vec_bf16=vec_bf16)
    for k in ("model_gb_per_iter", "model_tflop_per_iter", "floor_gb_per_iter"):
        assert mine[k] == jax[k]


# PERF.md section 6's bound column: (kernel, lattice, keywords, ms, bound by).
PERF_BOUNDS = [
    ("dual_update_2d", (1023, 1023), {}, 0.0125, "bytes"),
    ("dual_update_2d", (512, 512), {}, 0.0031, "bytes"),
    ("rhs_2d", (1023, 1023), {}, 0.0100, "bytes"),
    ("xupdate_pcg_2d_packed", (512, 512), {}, 0.0017, "bytes"),
    ("admm_iters_2d", (512, 512), {}, 0.0065, "operations"),
    ("admm_iters_2d_batched", (316, 316), {"batch": 5}, 0.0097, "bytes"),
    ("xupdate_pcg_2d", (1023, 1023), {}, 0.0260, "operations"),
    ("gram_matvec_2d", (1024, 1024), {}, 0.0038, "bytes"),
    ("dual_update_tiled_2d", (2048, 2048), {}, 0.0451, "bytes"),
    ("gram_residual_tiled_2d", (2048, 2048), {}, 0.0300, "bytes"),
    ("gram_matvec_tiled_2d", (2048, 2048), {}, 0.0150, "bytes"),
    ("gram_matvec_tiled_2d", (192, 8192), {}, 0.0056, "bytes"),
    ("dual_update_tiled_3d", (256, 256, 256), {}, 0.3406, "bytes"),
    ("gram_residual_tiled_3d", (256, 256, 256), {}, 0.1202, "bytes"),
    ("rhs_tiled_3d", (256, 256, 256), {}, 0.3205, "bytes"),
    ("dual_update_tiled_2d_shard", (2048, 2048), {}, 0.0451, "bytes"),
    ("gram_residual_tiled_2d_shard", (2048, 2048), {}, 0.0200, "bytes"),
    ("xupdate_tridiag", (1 << 20,), {}, 0.0038, "bytes"),
    ("xupdate_tridiag_segment", (1 << 18,), {}, 0.0016, "bytes"),
    ("partition_finish", (1 << 18,), {}, 0.0013, "bytes"),
]


@pytest.mark.parametrize("name,m,kw,ms,by", PERF_BOUNDS)
def test_bound_reproduces_perf_table(name, m, kw, ms, by):
    b_ms, b_by = rl.bound(name, m, **kw)
    assert round(b_ms, 4) == ms and b_by == by


def test_chip_smoke_reads_its_bounds_here():
    """chip_smoke.py's bound_ms column is roofline.bound (one count of each
    kernel's work for the smoke run and a later benchmark)."""
    import chip_smoke
    assert chip_smoke.roofline() is rl
    for name, m, kw, _, _ in PERF_BOUNDS:
        assert chip_smoke.bound(name, m, **kw) == rl.bound(name, m, **kw)


def test_iteration_1d_is_t1():
    """p = 1: the plain rhs and dual stage of the JAX model around T1, 12
    bytes a row (kernel_work's), in place of the cyclic reduction's 38 N
    elements."""
    n = 1 << 20
    stages = {s.name: s for s in rl.iteration_stages_1d(n)}
    jstages = {s.name: s for s in jrl.iteration_stages_1d(n)}
    assert set(stages) == {"rhs", "t1", "dual"}
    for nm in ("rhs", "dual"):
        assert _fields([stages[nm]]) == _fields([jstages[nm]])
    assert stages["t1"].bytes_(n) == rl.kernel_work("xupdate_tridiag", (n,))[0] == 12 * n
    rep = rl.model_report_1d(n, kind=H100, measured_iters_per_s=900.0)
    assert rep["layout"] == "t1" and rep["model_bound_iters_per_s"] > jrl.model_report_1d(
        n, kind="v5 lite")["model_bound_iters_per_s"]
    assert 0 < rep["frac_of_model_bound"] < 1


@pytest.mark.parametrize("x_update", ["natural", "pcg"])
def test_arm_models(x_update):
    """The x-update arms: b formed (3 arrays on the tiled route), one
    matvec (B10) for r0 and one per step, a transform pair per
    preconditioner application (the packed layout's bf16 products, or the
    dense float32 ones at PEAK_F32_FLOPS); above 2048 per axis the pcg arm
    has no dense preconditioner to model."""
    m, k = (2048, 2048), 4
    st = rl.iteration_stages(m, k, "quartered", x_update=x_update)
    names = [s.name for s in st]
    assert names[0] == "rhs" and st[0].reads == 3 and "dual" == names[-1]
    assert sum(s.name.startswith("cg.step.matvec") for s in st) == k
    transforms = [s for s in st if s.flops_per_knot]
    assert len(transforms) == 2 * (k + 1)
    layout = "dense" if x_update == "pcg" else "packed"
    assert transforms[0].flops_per_knot == rl._transform_flops_per_knot(m, layout)
    assert all(s.f32_flops == (x_update == "pcg") for s in transforms)
    rep = rl.model_report(m, k, x_update=x_update, kind=H100)
    assert rep["layout"] == layout and "floor_bound_iters_per_s" not in rep
    if x_update == "pcg":
        with pytest.raises(ValueError):
            rl.iteration_stages((4096, 4096), k, x_update="pcg")
    with pytest.raises(ValueError):
        rl.iteration_stages(m, k, x_update="bogus")


@pytest.mark.parametrize("x_update", ["spectral", "natural", "pcg"])
def test_shard_route_model(x_update):
    """model_report(ranks=W): one rank's share of the tiled route's stages
    (bytes, products and the bound divided by W), and the collectives of
    the shard route's x-update arm: per CG step the spectral CG's four
    all_to_alls (three in the forward transform, one in the inverse) and two
    group sums, the natural arm's four and its matvec's halo, the exact
    arm's two (the dense preconditioner's transposes); per iteration those
    of the steps and of the stages around them; each rank's all_to_all
    bytes (W - 1) / W of its share per call."""
    m, k, w = (2048, 2048), 3, 4
    whole = rl.model_report(m, k, x_update=x_update, kind=H100)
    rep = rl.model_report(m, k, x_update=x_update, kind=H100, ranks=w)
    assert rep["ranks"] == w
    assert rep["model_gb_per_iter"] == pytest.approx(whole["model_gb_per_iter"] / w, abs=1e-4)
    assert rep["model_bound_iters_per_s"] == pytest.approx(
        whole["model_bound_iters_per_s"] * w, rel=1e-3)
    step, it = rl.shard_collectives(x_update, k)
    assert rep["collectives_per_cg_step"] == step and rep["collectives_per_iter"] == it
    assert step["all_to_all"] == (2 if x_update == "pcg" else 4) and step["all_reduce"] == 2
    assert it["all_to_all"] == step["all_to_all"] * (k + 1)
    vb = 4
    assert rep["all_to_all_mb_per_rank_per_iter"] == pytest.approx(
        it["all_to_all"] * m[0] * m[1] * vb * (w - 1) / w / w / 1e6, abs=1e-3)
    assert "ranks" not in whole
    with pytest.raises(ValueError):
        rl.shard_collectives("bogus", k)
