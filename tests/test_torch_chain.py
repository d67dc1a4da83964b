"""The host half of B4/B5's persistent launch (csrc/chain.cu): the grid from
the kernel's occupancy, the work items, the partial-slot layout and the
work buffer's size, as ops/kernels.py computes them and passes them to the
kernel.  The kernel runs only on the card (chip_smoke.py, phase 3, holds it
against its plain version and B5's rows against B4 bit for bit); here the
arithmetic it is given is pinned: problem b's partial slots, and so the
order of its sums, must not depend on the batch size B."""
import re

import pytest

from multivartv_tpu_torch.ops import _build
from multivartv_tpu_torch.ops import kernels as K

H100_SMS = 132


def test_plan_fields_match_the_kernel_struct():
    """CHAIN_PLAN names csrc/chain.cu's Plan, field for field, in order:
    the kernel copies the ints it is given into that struct."""
    src = (_build.CSRC_DIR / "chain.cu").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.findall(r"int ([^;]+);", body):
        fields += [f.strip() for f in decl.split(",")]
    assert tuple(fields) == K.CHAIN_PLAN
    assert f"kPlanInts = {len(K.CHAIN_PLAN)};" in src


def test_dual_strips():
    """The dual stage's items are B1's march (csrc/dual.cuh) down column
    strips of up to 8 tiles, as many as the lattice has tile rows."""
    steps = [K.chain_plan(1, *m, per_sm=2, sms=H100_SMS)["dual_steps"]
             for m in ((16, 16), (64, 64), (316, 316), (1024, 1024))]
    assert steps == [2, 8, 8, 8]


@pytest.mark.parametrize("m, plan", [
    ((512, 512), dict(quad_cols=8, quad_items=256, dual_cols=16, dual_steps=8, dual_items=128,
                      fold_n=8, fold_mh=8, fold_m=16, p_rz=0, p_pap=128, p_rr=384, p_dual=640,
                      pstride=1280)),
    ((316, 316), dict(quad_cols=5, quad_items=100, dual_cols=10, dual_steps=8, dual_items=50,
                      fold_n=5, fold_mh=5, fold_m=10, p_rz=0, p_pap=50, p_rr=150, p_dual=250,
                      pstride=500)),
    ((1024, 1024), dict(quad_cols=16, quad_items=1024, dual_cols=32, dual_steps=8,
                        dual_items=512, fold_n=16, fold_mh=16, fold_m=32, p_rz=0, p_pap=512,
                        p_rr=1536, p_dual=2560, pstride=5120)),
    ((318, 130), dict(quad_cols=3, quad_items=60, dual_cols=5, dual_steps=8, dual_items=25,
                      fold_n=3, fold_mh=5, fold_m=10, p_rz=0, p_pap=30, p_rr=90, p_dual=150,
                      pstride=275)),
])
def test_plan_items_and_slots(m, plan):
    """The items of each stage at the main path's sizes, and each region of
    a problem's partials: <r, z> one per forward column-product tile (the
    stage kernels' folded_scale_blocks), <p, Ap> and |r|^2 one per quadrant
    item, the dual stage's 5 sums per column strip."""
    got = K.chain_plan(5, *m, per_sm=2, sms=H100_SMS)
    assert {k: got[k] for k in plan} == plan
    assert got["p_pap"] - got["p_rz"] == got["fold_m"] * got["fold_n"]
    assert got["p_rr"] - got["p_pap"] == got["quad_items"]
    assert got["p_dual"] - got["p_rr"] == got["quad_items"]
    assert got["pstride"] - got["p_dual"] == 5 * got["dual_items"]


@pytest.mark.parametrize("m", [(512, 512), (316, 316), (64, 96), (1024, 1024)])
def test_problem_slots_do_not_depend_on_the_batch(m):
    """The CPU half of "B5's row b == B4 on problem b, bit for bit": every
    count, offset and slot of problem b is the same for B = 1 .. 8 (only
    the grid may grow with B, and no value depends on the grid: each item
    computes the same bits in any CTA, and each sum adds its slots in slot
    order), and the B problems' partials tile the buffer without overlap."""
    one = K.chain_plan(1, *m, per_sm=2, sms=H100_SMS)
    fixed = {k: v for k, v in one.items() if k != "grid"}
    for batch in range(1, 9):
        plan = K.chain_plan(batch, *m, per_sm=2, sms=H100_SMS)
        assert {k: v for k, v in plan.items() if k != "grid"} == fixed
        slots = []
        for b in range(batch):
            base = b * plan["pstride"]
            regions = [(plan["p_rz"], plan["p_pap"]), (plan["p_pap"], plan["p_rr"]),
                       (plan["p_rr"], plan["p_dual"]), (plan["p_dual"], plan["pstride"])]
            for lo, hi in regions:
                slots += range(base + lo, base + hi)
            # problem b's slots are B = 1's, shifted by b rows
            assert [s - base for s in slots[-plan["pstride"]:]] == list(range(one["pstride"]))
        assert slots == list(range(batch * plan["pstride"]))


def test_grid_from_occupancy():
    """Every resident CTA (per_sm on each SM), one an SM while the quadrant
    items fit twice over the SMs, or as many as the largest stage has
    items; a kernel that cannot be resident raises: there is no fallback to
    another launch."""
    assert K.chain_plan(1, 512, 512, per_sm=2, sms=H100_SMS)["grid"] == 132
    assert K.chain_plan(1, 64, 64, per_sm=2, sms=H100_SMS)["grid"] == 4
    assert K.chain_plan(5, 316, 316, per_sm=2, sms=H100_SMS)["grid"] == 264
    assert K.chain_plan(5, 316, 316, per_sm=1, sms=H100_SMS)["grid"] == 132
    assert K.chain_plan(5, 1024, 1024, per_sm=3, sms=H100_SMS)["grid"] == 396
    assert K.chain_plan(1, 16, 16, per_sm=2, sms=H100_SMS)["grid"] == 2
    for per_sm, sms in ((0, H100_SMS), (2, 0)):
        with pytest.raises(RuntimeError, match="cannot be resident"):
            K.chain_plan(1, 512, 512, per_sm=per_sm, sms=sms)


@pytest.mark.parametrize("batch, m, floats", [
    (1, (512, 512), 1_966_084),
    (5, (316, 316), 3_551_844),
    (1, (318, 130), 323_956),
])
def test_work_floats(batch, m, floats):
    """The work buffer: u's scratch copy, r, p and Ap (6 lattices a
    problem), 4 floats of alignment slack, then the padded bf16 operands
    (4 blocks of m0 x pad8(m1/2) a problem, the four padded halves)."""
    assert K.chain_work_floats(batch, *m) == floats


def test_barriers_per_call():
    """20 grid barriers an iteration at n_steps = 3 (the residual, 12 in
    the three preconditioner applies, 6 in the CG steps, the dual stage),
    with the set-up's in place of the last iteration's."""
    assert K.chain_barriers(4, 3) == 80
    assert K.chain_barriers(1, 1) == 8
