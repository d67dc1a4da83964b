"""Roofline model of the port on an NVIDIA H100: each kernel's bound, and a
stage model of one ADMM iteration.

Counterpart of ``multivartv_tpu/utils/roofline.py``.  Two parts:

* **Kernel bounds** (``kernel_work``, ``bound``): the bytes one call of a
  hand-written kernel must move (each input read once, each output written
  once) and the operations it must do (its bf16 DCT products), and the
  least time the card takes for them, the larger of bytes over
  ``PEAK_HBM_BYTES`` and operations over ``PEAK_BF16_FLOPS``.
  ``chip_smoke.py`` prints these as its kernels' ``bound_ms``.
* **Iteration model** (``iteration_stages``, ``floor_stages``,
  ``iteration_stages_1d``, ``model_report``, ``model_report_1d``,
  ``stage_table``): one ADMM iteration split into stages, each with the
  lattice arrays it reads and writes and its DCT products' operations, and
  the bound of the iteration as the sum over stages of max(bytes / memory
  rate, operations / peak rate).  ``bytes_model`` counts one read per
  operand use and one write per produced array, with each elementwise
  expression fused into one pass; ``floor`` counts every array that
  carries information between stages once each way.

Where the port's model departs from the JAX package's:

* **Peaks**: an H100's, not a TPU's (``device_peaks``).
* **Practical bandwidth**: the JAX package's 0.81 of book bandwidth was
  measured on a TPU v5e.  Here it is this card's: ``chip_smoke.py``'s copy
  probe (``csrc/probe.cu`` ``stream_copy`` on 512 MB) reached 2,852.3
  GB/s on an NVIDIA H100 80GB HBM3 at 700 W, 0.85 of 3.35 TB/s
  (``PRACTICAL_BW_FRACTION``).
* **The p = 1 x-update** (``iteration_stages_1d``): the port's T1
  (``csrc/tridiag.cu``), one launch that reads counts and b and writes x,
  12 bytes a row, in place of the JAX package's XLA cyclic reduction
  modelled at 38 N elements (stages "cr.setup", "cr.reduce", "cr.backsub"
  become "t1").
* **The x-update arms** (``x_update``): the JAX model covers the spectral
  CG only.  "natural" (SolverConfig(spectral_cg=False)) and "pcg"
  (xla_packed=False) model the port's other two x-updates of the same
  routes; "pcg" takes its products in float32 on the CUDA cores (TF32
  off, the exact route's preconditioner) at ``PEAK_F32_FLOPS``.
* **The shard route** (``model_report(ranks=W)``, ``shard_collectives``):
  the JAX model has none; one rank's share of the same stages, and the
  collectives of each x-update arm across ranks.
* **The packed layout's r0**: the port forms b and then r0 through B10 (2-D)
  or B13 with b given (3-D); the model keeps the JAX stage ("cg.r0",
  b's assembly fused in), so it is a bound for that layout too.

The 2-D and 3-D stage tables of the spectral CG are the JAX package's
(the port's iteration has the same stages: B9/B13 form r0 with b's
assembly fused in, B8/B12 carry dta and dtu out and skip the alpha
writes).  They assume fused elementwise passes; the port runs many of
them as separate eager PyTorch kernels, so its eager passes move more
than the model and the gap shows as eager time (PERF.md section 5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

# The published peaks of an H100 SXM5 at its 700 W limit (NVIDIA H100
# Tensor Core GPU data sheet; dense rates, no sparsity): 3.35 TB/s of HBM3,
# 989 TFLOP/s in bf16 on the tensor cores (the DCT products' operands),
# 67 TFLOP/s in float32 outside them.
PEAK_HBM_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
_PEAKS = (
    # substring of the device name -> (memory GB/s, bf16 TFLOP/s)
    ("h100 80gb hbm3", (3350.0, 989.0)),
)
_DEFAULT_PEAK = (3350.0, 989.0)

# The device-memory rate the card reached: chip_smoke.py's copy probe on
# 512 MB, 2,852.3 GB/s on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
# section 6, the probe row), over the published 3,350 GB/s.
PRACTICAL_BW_GBPS = 2852.3
PRACTICAL_BW_FRACTION = PRACTICAL_BW_GBPS / 3350.0


def device_peaks(kind: Optional[str] = None) -> Tuple[float, float]:
    """(memory GB/s, bf16 TFLOP/s) of the named device, or of CUDA device
    0 with no name; an H100 SXM's where the name is not known."""
    if kind is None:
        import torch
        kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else ""
    kind = kind.lower()
    return next((v for k, v in _PEAKS if k in kind), _DEFAULT_PEAK)


# ---------------------------------------------------------------------------
# Kernel bounds
# ---------------------------------------------------------------------------

# The halo rows (planes at p = 3) a slab kernel reads besides its slab
# (csrc/dual.cu, tiled.cu, rhs.cu, tiled3.cu): theta above and below and u
# above; v above and below; alpha_0, alpha_2, u_0, u_2 above; at p = 3
# theta above and below and the 7 u blocks' plane below; v above and below.
SLAB_HALO_ROWS = {"dual_update_tiled_2d_shard": 5, "gram_residual_tiled_2d_shard": 2,
                  "gram_matvec_tiled_2d_shard": 2, "rhs_tiled_2d_shard": 4,
                  "dual_update_tiled_3d_shard": 9, "gram_residual_tiled_3d_shard": 2,
                  "gram_matvec_tiled_3d_shard": 2}

# Bytes per knot each kernel reads and writes (float32 lattices).
_BYTES_PER_KNOT = {
    "dual_update_2d": 16 + 24,            # theta, 3 u -> 3 alpha, 3 u_new
    "rhs_2d": 28 + 4,                     # 3 alpha, 3 u, oty -> b
    "xupdate_pcg_2d_packed": 16 + 4,      # b, x0, counts, eigs -> x
    "admm_iters_2d": 40 + 28,             # state, counts, oty, eigs -> state
    "dual_update_tiled_2d": 16 + 20,      # theta, 3 u -> 3 u_new, dta, dtu
    "gram_residual_tiled_2d": 20 + 4,     # v, counts, oty, dta, dtu -> r0
    "gram_matvec_tiled_2d": 8 + 4,        # v, counts -> A v
    "dual_update_tiled_3d": 32 + 36,      # theta, 7 u -> 7 u_new, dta, dtu
    "gram_residual_tiled_3d": 20 + 4,     # v, counts, oty, dta, dtu -> r0
    "rhs_tiled_3d": 60 + 4,               # 7 alpha, 7 u, oty -> b
    "xupdate_pcg_2d": 16 + 4,             # b, x0, counts, eigs -> x
    "gram_matvec_2d": 8 + 4,              # v, counts -> A v (and a dot)
    "rhs_tiled_2d": 28 + 4,               # 3 alpha, 3 u, oty -> b
    # the row-slab kernels: their twins', plus SLAB_HALO_ROWS
    "dual_update_tiled_2d_shard": 16 + 20,
    "gram_residual_tiled_2d_shard": 12 + 4,   # b, v, counts -> r0 (b given)
    "gram_matvec_tiled_2d_shard": 8 + 4,
    "rhs_tiled_2d_shard": 28 + 4,
    "xupdate_tridiag": 8 + 4,             # counts, b -> x
    # the plane-slab kernels: their twins', plus SLAB_HALO_ROWS planes
    "dual_update_tiled_3d_shard": 32 + 36,
    "gram_residual_tiled_3d_shard": 12 + 4,   # b, v, counts -> r0 (b given)
    "gram_matvec_tiled_3d_shard": 8 + 4,      # v, counts -> A v
    # T1's segment mode: counts, b -> 3 x (e_0, e_L formed in the kernel)
    "xupdate_tridiag_segment": 8 + 12,
    # the partition finish: y, l, r -> x (the W gathered ends aside)
    "partition_finish": 12 + 4,
}
# The slab kernels that form b from oty, dta and dtu with `fused`.
_FUSED_SLAB = ("gram_residual_tiled_2d_shard", "gram_residual_tiled_3d_shard")


def kernel_work(name: str, m, batch: int = 1, k_iters: int = 4, n_steps: int = 3,
                n_in: int = 0, n_out: int = 0, fused: bool = False):
    """(bytes, operations) one call of a kernel must move and do at lattice
    m: each input read once and each output written once (the per-block
    partial sums aside); operations are the folded DCT products'.  fused:
    B9s or B13s with b formed from oty, dta and dtu (24 bytes per knot, not
    16)."""
    n = int(np.prod(m))
    halves = sum(2 * 2 * (v // 2) ** 2 for v in m)    # bf16 (Te, To) per axis
    transform = n * sum(m)                            # one folded DCT, 2 flops per MAC
    if name == "admm_iters_2d_batched":               # counts and oty per fold, eigs shared
        return batch * 64 * n + 4 * n + halves, batch * k_iters * 2 * n_steps * transform
    if name == "dual_struct":                         # n_in lattices in, n_out out
        return 4 * n * (n_in + n_out), 0
    knot = 24 if fused and name in _FUSED_SLAB else _BYTES_PER_KNOT[name]
    nbytes = knot * n + 4 * int(np.prod(m[1:])) * SLAB_HALO_ROWS.get(name, 0)
    flops = 0
    if name == "xupdate_pcg_2d_packed":
        nbytes, flops = nbytes + halves, 2 * n_steps * transform
    elif name == "xupdate_pcg_2d":                    # bf16 T0, T1; dense: twice the folded
        nbytes, flops = nbytes + 2 * sum(v * v for v in m), 2 * n_steps * 2 * transform
    elif name == "admm_iters_2d":
        nbytes, flops = nbytes + halves, k_iters * 2 * n_steps * transform
    return nbytes, flops


def bound(name: str, m, **kw):
    """(bound_ms, bound_by): the larger of bytes over PEAK_HBM_BYTES and
    operations over PEAK_BF16_FLOPS, bound_by "bytes" or "operations"."""
    nbytes, flops = kernel_work(name, m, **kw)
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Iteration model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    reads: float    # lattice-array reads (units of ntheta elements)
    writes: float   # lattice-array writes
    flops_per_knot: float = 0.0   # product flops per lattice element
    note: str = ""
    elem_bytes: int = 4   # 2 where the CG vectors are stored bf16
    f32_flops: bool = False   # products in float32 on the CUDA cores

    def bytes_(self, ntheta: int) -> float:
        return (self.reads + self.writes) * ntheta * self.elem_bytes

    def flops(self, ntheta: int) -> float:
        return self.flops_per_knot * ntheta


def _transform_flops_per_knot(m: Tuple[int, ...], layout: str) -> float:
    """Product flops per lattice element of ONE p-dim DCT: per axis j each
    element takes part in a contraction of width m_j (dense), m_j / 2
    (folded: packed, blocked) or m_j / 4 (quartered); a MAC is 2 flops."""
    div = {"dense": 1, "packed": 2, "blocked": 2, "quartered": 4}[layout]
    return sum(2.0 * (mj / div) for mj in m)


def _vec_bytes(m, vec_bf16: Optional[bool]) -> int:
    """2 where the spectral CG stores its vectors in bf16 (None: the
    solver's auto rule, xupdate.spectral_vec_dtype: above 2^23 knots)."""
    if vec_bf16 is None:
        vec_bf16 = int(np.prod(m)) > (1 << 23)
    return 2 if vec_bf16 else 4


def _spectral_stages(m, n_steps: int, layout: str, tiled: bool, vb: int):
    """The spectral-correction CG's iteration (JAX roofline.py:118-203,
    the same stages and counts)."""
    B = (1 << len(m)) - 1   # difference blocks (2^p - 1)
    tf = _transform_flops_per_knot(m, layout)
    stages = ([] if tiled else [
        Stage("rhs", reads=2 * B + 1, writes=1, note="plain adjoint stencils"),
    ]) + [
        Stage("cg.r0", reads=5 if tiled else 3, writes=1,
              note="B9 / B13 with b's assembly fused in" if tiled else "plain residual"),
        Stage("cg.to_blocks", reads=1, writes=1, elem_bytes=(4 + vb) // 2),
        Stage("cg.fwd0", reads=1, writes=1, flops_per_knot=tf, elem_bytes=vb,
              note="folded DCT (bf16 products)"),
        Stage("cg.init_z", reads=2, writes=1, elem_bytes=vb,
              note="p = r/w; rz = sum(r^2/w) (z never stored)"),
    ]
    per_step = [
        Stage("cg.step.inv", reads=1, writes=1, flops_per_knot=tf, elem_bytes=vb),
        Stage("cg.step.cmul", reads=2, writes=1, elem_bytes=(4 + vb) // 2,
              note="counts_b * inv(p)"),
        Stage("cg.step.fwd", reads=1, writes=1, flops_per_knot=tf, elem_bytes=vb),
        Stage("cg.step.ap", reads=3, writes=1, elem_bytes=vb,
              note="ap = fwd + rl*p; dot(p, ap)"),
        Stage("cg.step.xh_rh", reads=4, writes=2, elem_bytes=vb,
              note="xh += a p; rh -= a ap; rz = sum(rh^2/w)"),
        Stage("cg.step.p", reads=3, writes=1, elem_bytes=vb,
              note="p = rh/w + b p (skipped on the last step)"),
    ]
    for s in range(n_steps):
        sel = per_step if s + 1 < n_steps else per_step[:-1]
        stages += [dataclasses.replace(st, name=f"{st.name}[{s}]") for st in sel]
    return stages + [
        Stage("cg.inv_final", reads=1, writes=1, flops_per_knot=tf, elem_bytes=vb),
        Stage("cg.from_blocks", reads=1, writes=1, elem_bytes=vb),
        Stage("cg.apply_dx", reads=2, writes=1, elem_bytes=(4 + vb) // 2,
              note="x = x0 + dx"),
    ]


def _natural_stages(m, n_steps: int, tiled: bool, x_update: str):
    """The natural-domain PCG of spectral_cg=False (n fixed steps, the bf16
    packed-layout DCT preconditioner) or of xla_packed=False (the steps it
    took, the dense float32 DCT preconditioner), with B10 as the matvec on
    the 2-D tiled route: b formed, then pcg_fused's / pcg's passes."""
    B = (1 << len(m)) - 1
    f32 = x_update == "pcg"
    tf = _transform_flops_per_knot(m, "dense" if f32 else "packed")
    mv = "B10" if tiled and len(m) == 2 else "plain matvec"
    stages = [
        Stage("rhs", reads=3 if tiled else 2 * B + 1, writes=1,
              note="b = oty + rho (dta + s dtu)" if tiled else "plain adjoint stencils"),
        Stage("cg.r0", reads=3, writes=1, note=f"r0 = b - A x0 ({mv})"),
    ]

    def precond(tag):
        return [Stage(f"{tag}.fwd", reads=1, writes=1, flops_per_knot=tf, f32_flops=f32),
                Stage(f"{tag}.scale", reads=2, writes=1, note="zhat = rhat / w; <rhat, zhat>"),
                Stage(f"{tag}.inv", reads=1, writes=1, flops_per_knot=tf, f32_flops=f32)]

    stages += precond("cg.precond0")
    for s in range(n_steps):
        stages += [Stage(f"cg.step.matvec[{s}]", reads=2, writes=1, note=f"A p ({mv})"),
                   Stage(f"cg.step.pap[{s}]", reads=2, writes=0, note="<p, A p>"),
                   Stage(f"cg.step.x_r[{s}]", reads=4, writes=2, note="x += a p; r -= a Ap")]
        stages += precond(f"cg.step.precond[{s}]")
        stages.append(Stage(f"cg.step.p[{s}]", reads=2, writes=1, note="p = z + b p"))
    return stages


def iteration_stages(m: Tuple[int, ...], n_steps: int = 3, layout: str = "quartered",
                     tiled: bool = True, vec_bf16: Optional[bool] = None,
                     x_update: str = "spectral") -> Tuple[Stage, ...]:
    """Per-stage model of one 2-D or 3-D ADMM iteration: the rhs, the
    x-update and the dual stage (arrays in units of ntheta elements; the
    difference blocks are stored at the full lattice shape, so each counts
    1).  tiled: the routes with the dta/dtu carries (B8 / B12 skip the
    alpha writes and write the carries; the spectral CG's r0 kernel forms b
    itself).  x_update: "spectral" (the defaults: the spectral-correction
    CG in layout, JAX's model stage for stage), "natural"
    (spectral_cg=False; the packed layout whatever layout says) or "pcg"
    (xla_packed=False, n_steps = the CG steps taken; the dense float32
    preconditioner, up to 2048 per axis).  vec_bf16: the spectral
    CG's vectors in bf16 (None: above 2^23 knots, as the solver)."""
    B = (1 << len(m)) - 1
    if x_update == "spectral":
        stages = _spectral_stages(m, n_steps, layout, tiled, _vec_bytes(m, vec_bf16))
    elif x_update in ("natural", "pcg"):
        if x_update == "pcg" and max(m) > 2048:
            raise ValueError("the pcg arm's model covers the dense float32 preconditioner "
                             f"(up to 2048 per axis), not m = {tuple(m)}")
        stages = _natural_stages(m, n_steps, tiled, x_update)
    else:
        raise ValueError(f"unknown x_update: {x_update!r}")
    stages.append(Stage("dual", reads=B + 1.0, writes=(B + 2.0) if tiled else 2.0 * B,
                        note="B8 / B12: one pass, sums in-kernel, alpha skipped" if tiled
                        else "plain prox and dual stencils"))
    return tuple(stages)


def floor_stages(m: Tuple[int, ...], n_steps: int = 3, layout: str = "quartered",
                 vec_bf16: Optional[bool] = None) -> Tuple[Stage, ...]:
    """The spectral CG iteration's floor (JAX roofline.py:206-230): every
    array between stages crosses device memory once each way, every
    elementwise chain fused, each transform read and written once."""
    vb = _vec_bytes(m, vec_bf16)
    B = (1 << len(m)) - 1
    tf = _transform_flops_per_knot(m, layout)
    n_tf = 2 + 2 * n_steps   # fwd0, per-step inv+fwd, final inv
    return (
        Stage("cg.r0", reads=5, writes=1,
              note="oty, dta, dtu, counts, x0 -> r0 (rhs, matvec and subtract in one pass)"),
        Stage("transforms", reads=float(n_tf), writes=float(n_tf),
              flops_per_knot=tf * n_tf, elem_bytes=vb,
              note="layout conversions fused into the first and last transform"),
        Stage("cg.elementwise", reads=2.0 * n_steps, writes=1.0 * n_steps, elem_bytes=vb,
              note="one fused pass per CG step between transforms"),
        Stage("cg.apply_dx", reads=2, writes=1),
        Stage("dual", reads=B + 1.0, writes=B + 2.0),
    )


def iteration_stages_1d(n: int) -> Tuple[Stage, ...]:
    """Per-stage model of one p = 1 iteration on the "tridiag" route: the
    plain rhs and dual stage (one block, the JAX package's stages) around
    T1, which reads counts and b and writes x (12 bytes a row; the JAX
    package models its XLA cyclic reduction at 38 N elements)."""
    return (
        Stage("rhs", reads=3, writes=1, note="plain adjoint stencil"),
        Stage("t1", reads=2, writes=1, note="T1: counts, b -> x in one launch"),
        Stage("dual", reads=4, writes=3, note="plain prox, dual and sums"),
    )


def _stage_time(s: Stage, ntheta: int, bw_b: float, fl_s: float) -> float:
    peak = PEAK_F32_FLOPS * fl_s / PEAK_BF16_FLOPS if s.f32_flops else fl_s
    return max(s.bytes_(ntheta) / bw_b, s.flops(ntheta) / peak)


def model_report_1d(n: int, kind: Optional[str] = None,
                    measured_iters_per_s: Optional[float] = None) -> Dict:
    """Roofline summary of one p = 1 iteration at n knots (the fused
    lasso, m = N)."""
    bw, _ = device_peaks(kind)
    bw_b = bw * 1e9
    stages = iteration_stages_1d(n)
    mb = sum(s.bytes_(n) for s in stages)
    mt = mb / bw_b
    rep = {"m": [n], "layout": "t1", "peak_gbps": bw,
           "model_gb_per_iter": round(mb / 1e9, 6),
           "model_bound_iters_per_s": round(1.0 / mt, 1)}
    if measured_iters_per_s:
        rep["measured_iters_per_s"] = round(measured_iters_per_s, 1)
        rep["frac_of_model_bound"] = round(measured_iters_per_s * mt, 4)
        rep["achieved_gbps"] = round(mb * measured_iters_per_s / 1e9, 1)
    return rep


def shard_collectives(x_update: str, n_steps: int) -> Tuple[Dict, Dict]:
    """(per CG step, per iteration) collective calls of the shard route's
    x-update arm with its stages around it (solver/xupdate.py,
    parallel/spectral.py): all_to_alls (the pencil transposes), all_reduces
    (the group sums) and halo exchanges.  The spectral CG: its forward
    transform 3 all_to_alls and its inverse 1, <p, A p> and r'z; the
    natural arm: the packed transform pair and the matvec's halo; the exact
    arm: the dense preconditioner's 2 transposes and its matvec's halo.
    Around them r0's halo (the natural arm: its matvec), and the dual
    stage's halo and one sum (B8s / B12s, or the plain stage's five sums in
    one call).  A group of one makes none of these calls."""
    n = n_steps
    if x_update == "spectral":
        step = {"all_to_all": 4, "all_reduce": 2, "halo": 0}
        it = {"all_to_all": 4 * n + 4, "all_reduce": 2 * n + 2, "halo": 2}
    elif x_update == "natural":
        step = {"all_to_all": 4, "all_reduce": 2, "halo": 1}
        it = {"all_to_all": 4 * n + 4, "all_reduce": 2 * n + 2, "halo": n + 2}
    elif x_update == "pcg":
        step = {"all_to_all": 2, "all_reduce": 2, "halo": 1}
        it = {"all_to_all": 2 * n + 2, "all_reduce": 2 * n + 2, "halo": n + 2}
    else:
        raise ValueError(f"unknown x_update: {x_update!r}")
    return step, it


def model_report(m: Tuple[int, ...], n_steps: int = 3, layout: str = "quartered",
                 kind: Optional[str] = None, measured_iters_per_s: Optional[float] = None,
                 vec_bf16: Optional[bool] = None, x_update: str = "spectral",
                 ranks: Optional[int] = None) -> Dict:
    """Roofline summary of one iteration of the tiled routes at lattice m
    (see iteration_stages): the model's bytes and operations, its bound in
    iterations/s at the published peaks and at the practical bandwidth,
    the floor's for the spectral CG, and with a measurement the fraction
    of each bound it reached.  ranks: the shard route on that many ranks
    (the same stages, each rank a 1/ranks share of every lattice array; the
    bound is one rank's), with its collectives per CG step and per
    iteration (shard_collectives) and the bytes each rank's all_to_alls
    send to the others per iteration."""
    ntheta = int(np.prod(m))
    bw, tflops = device_peaks(kind)
    bw_b, fl_s = bw * 1e9, tflops * 1e12

    def tally(stages, bw_rate=bw_b):
        byt = sum(s.bytes_(ntheta) for s in stages)
        flp = sum(s.flops(ntheta) for s in stages)
        return byt, flp, sum(_stage_time(s, ntheta, bw_rate, fl_s) for s in stages)

    stages_m = iteration_stages(m, n_steps, layout, vec_bf16=vec_bf16, x_update=x_update)
    mb, mf, mt = tally(stages_m)
    _, _, mt_prac = tally(stages_m, bw_b * PRACTICAL_BW_FRACTION)
    w = 1 if ranks is None else int(ranks)
    mb, mf, mt, mt_prac = mb / w, mf / w, mt / w, mt_prac / w
    rep = {
        "m": list(m),
        "layout": {"pcg": "dense", "natural": "packed"}.get(x_update, layout),
        "x_update": x_update, "cg_steps": n_steps,
        "vec_bf16": _vec_bytes(m, vec_bf16) == 2 and x_update == "spectral",
        "peak_gbps": bw, "peak_bf16_tflops": tflops,
        "model_gb_per_iter": round(mb / 1e9, 4),
        "model_tflop_per_iter": round(mf / 1e12, 4),
        "model_bound_iters_per_s": round(1.0 / mt, 1),
        "practical_bound_iters_per_s": round(1.0 / mt_prac, 1),
    }
    if ranks is not None:
        step, it = shard_collectives(x_update, n_steps)
        vb = _vec_bytes(m, vec_bf16) if x_update == "spectral" else 4
        rep.update(ranks=w, collectives_per_cg_step=step, collectives_per_iter=it,
                   all_to_all_mb_per_rank_per_iter=round(
                       it["all_to_all"] * ntheta * vb * (w - 1) / w / w / 1e6, 3))
    ft = None
    if x_update == "spectral":
        fb, _, ft = tally(floor_stages(m, n_steps, layout, vec_bf16))
        fb, ft = fb / w, ft / w
        rep["floor_gb_per_iter"] = round(fb / 1e9, 4)
        rep["floor_bound_iters_per_s"] = round(1.0 / ft, 1)
    if measured_iters_per_s:
        rep["measured_iters_per_s"] = round(measured_iters_per_s, 1)
        rep["frac_of_model_bound"] = round(measured_iters_per_s * mt, 3)
        rep["frac_of_practical_bound"] = round(measured_iters_per_s * mt_prac, 3)
        if ft is not None:
            rep["frac_of_floor_bound"] = round(measured_iters_per_s * ft, 3)
        achieved = mb * measured_iters_per_s / 1e9
        rep["achieved_gbps"] = round(achieved, 1)
        # A rate whose modelled traffic implies more than the card's
        # streaming ceiling means some of that traffic stayed in the 50 MB
        # L2: the model is then a lower bound, its fraction no efficiency.
        if achieved > bw * PRACTICAL_BW_FRACTION:
            rep["hbm_model_uninformative"] = (
                "implied bandwidth exceeds the measured streaming ceiling: some modelled "
                "traffic stayed in the L2; read the fractions as lower-bound ratios")
    return rep


def stage_table(m: Tuple[int, ...], n_steps: int = 3, layout: str = "quartered",
                kind: Optional[str] = None, x_update: str = "spectral") -> str:
    """A readable per-stage table of iteration_stages."""
    ntheta = int(np.prod(m))
    bw, tflops = device_peaks(kind)
    lines = [f"stage model for m={tuple(m)}, layout={layout}, cg_steps={n_steps}, "
             f"x_update={x_update}",
             f"{'stage':24s} {'GB':>8s} {'GFLOP':>9s} {'us_bound':>9s}  note"]
    for s in iteration_stages(m, n_steps, layout, x_update=x_update):
        b, f = s.bytes_(ntheta), s.flops(ntheta)
        t = _stage_time(s, ntheta, bw * 1e9, tflops * 1e12) * 1e6
        lines.append(f"{s.name:24s} {b / 1e9:8.4f} {f / 1e9:9.2f} {t:9.1f}  {s.note}")
    return "\n".join(lines)
