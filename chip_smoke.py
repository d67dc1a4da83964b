"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels of multivartv_tpu_torch/csrc, holds every kernel
against its plain PyTorch version on the card, drives the port's three main
paths through the entry points a user calls: mvtv_one on two workloads,
checked against the exact-f32 route; the cross-validated mvtv (5 folds,
20 lambdas) at n = 1e5 on the default 316^2 mesh, checked against the JAX
package's own fit of the same data (numbers embedded below) and, at 128^2,
against the port's exact-f32 route, and on one column (p = 1: the
"tridiag" route, T1 on every fold) against the same call on the CPU; and
the large-lattice route above 2^20 knots (the tiled kernels under the
spectral-correction CG): mvtv_one at
2048^2 (n = 2^22) and on a thin 192 x 8192 lattice, checked against the
exact-f32 route on the card (4096^2, n = 2^24, and mvtv(folds=1,
n_lambda=5) at 2048^2 in phase 14); and the p = 3 route: mvtv_one at 256^3 (the tiled3
kernels B12 and B13 under the same CG; 255 x 255 x 256 in phase 14) and at
128^3 (no kernel), and mvtv(folds=1, n_lambda=5) at 256 x 256 x 64,
checked against the exact-f32 route and lambda_max at 256^3 against the
same recomputation (mvtv(folds=3, n_lambda=3) there, the CV folds off the
whole-lattice route, in phase 18); and the sibling solver profiles and the remaining 2-D
x-update routes: mvtv_one at 1023^2 under the standalone C++ sibling's
profile (theta_inf stopping, unpadded: B2, B6 and B1 every iteration), at
1024^2 past the one-kernel gate of a 96 MB TPU part (B7 under the fused-dot
PCG, float32 and bf16 preconditioner), at 4096 x 256 (no dense DCT
matrices: the spectral CG between B2 and B1), mvtv(folds=1, n_lambda=5) at
1023^2 under the same profile, and mvtv_one at 316^2 under the reference
Python prototype's profile (the reduced block set, no kernel), each checked
against the exact-f32 route with the same configs, and the 1023^2 route
after a fixed number of iterations against the same route on the plain
versions and against the exact-f32 route; and the sharded fit
(multivartv_tpu_torch/parallel) as a row group of one NCCL rank on the
card: mvtv_sharded(folds=1, n_lambda=3) at 2048^2 against the exact-f32
route and mvtv_sharded(folds=2, n_lambda=3) at 1024^2 against the
single-card mvtv's tie set, mvtv_sharded at 16^4 and with the reduced
block set at 2048^2 (C7), and the shard route's three x-update arms at
2048^2 (the spectral CG across ranks, xla_packed=False, spectral_cg=False),
with its row-slab kernels B8s, B9s and B11s
also held, on four row slabs of the 2048^2 state with real halos, against
the whole-lattice kernels; and the two repaired routes, mvtv_one at
16384 x 256 (no folded DCT halves) and at 16^4 (p = 4), each against the
exact-f32 route.  Phase 3 also holds B6 at 511 x 2047 and B12 and B13 at
258 x 130 x 136, shapes that leave remainders in their kernels' tiles, B13
at the C3 folds' 256 x 256 x 64, and B1 and B7 at 1023^2 and 511 x 2047
(B7 also at 1024^2, its row march) with a second run bit for bit, and T1
(the exact p = 1 x-update, csrc/tridiag.cu) against the plain cyclic
reduction from 1 to 4,194,305 knots (above N_res, the segment solve's
largest size, the multi-level route) and g = rho s^2 from 1e-4 to 50, with
a second run bit for bit and, at 2^20, the float64 solution's distance.
Phase 20 drives the p = 1 path and user meshes: mvtv_one on the 1-D fused
lasso (m = N = 2^20, mesh = sorted x, float32 knots that coincide left
empty) against the exact route and its lambda_max against a float64
recomputation, mvtv(folds=5, n_lambda=20) on
the fused lasso at N = 1e5 against the JAX package's fit (FUSED_JAX), and
mvtv_one on a 316^2 point cloud, the kd-tree's assignment against the
device brute force's; phase 21 times T1 (316, 4096, 1e5 and 2^20 knots)
and the fused-lasso iteration.  Phase 22 runs the x-update arms of
SolverConfig at 2048^2 (n = 2^22) on the tiled route: the default,
xla_packed=False (the exact float32 DCT-PCG, B10 its matvec) and
spectral_cg=False (the bf16 natural-domain PCG) from one warm state,
xla_packed=False against the exact route after the same iterations and
spectral_cg=False against it after a capped mvtv_one, B10 timed at 2048^2;
then solve_path_checkpointed at 316^2 resumed from a manifest inside a
chunk against one uninterrupted path, and tv_penalty against a float64
sum.  Phase 23 drives the sharded fit at p = 3 and p = 1 on a row group of
one NCCL rank: mvtv_sharded at 256^3 (folds 1) through B12s and B13s, the
plane-slab modes of B12 and B13, under the spectral CG across ranks,
against the tiled3 route's cold solve, at 256 x 256 x 64 (folds 2) against
the single-card mvtv's tie set, and on the fused lasso at N = 2^20 and 1e5
through T1 against the tridiag route, each solve capped on both sides;
the shard route's three x-update arms at 256^3; then the shard route's ms
per iteration beside the single-card routes.  Phase 3 also holds B12s and B13s on plane
cuts of 256 x 256 x 64 (one-plane slabs included) against their plain
versions and the whole-lattice B12 and B13, and the p = 1 partition solve
(T1's segment mode and the finish kernel on 4 segments of a 2^20 chain,
one without counts, and on 16 even ones) against T1 on the whole chain.
The bounds come from
multivartv_tpu_torch/utils/roofline.py.
It shows through the launch counters that the paths ran every kernel,
measures the device-memory ceiling with a streaming-copy probe, times each
kernel beside its plain version and its bound (B3-B5 also with their
device time split by torch.profiler into DCT products, other stages and
finish passes, their launches per iteration and idle share, and their
products beside the same products on cuBLAS), and prints:

  * a JSON line {"kernels": [...]} with each kernel's launches on the main
    paths (each counted from 0), its largest error against the plain
    version, its time, the plain version's, and its bound;
  * as the last line {"ok": true, "device": {...}}.

Any failed check exits non-zero before the last line.  Without CUDA it
exits non-zero at once.  It imports nothing of JAX.  Phases: 1 device,
2 build, 3 kernel checks, 4/5 the whole-lattice main paths, 6 predict,
7 timing, 8 mvtv with the default 100 lambdas, 9 the large-lattice path,
10 its timing and profile, 12 the p = 3 path, 13 its timing and profile,
15 the profiles' and x-update routes' fits, 16 the sharded path and the
repaired routes, 17 the row-slab kernels' timing, 20 the p = 1 path and
user meshes, 21 T1's timing and the fused-lasso iteration, 22 the x-update
arms, the resumed lambda path and tv_penalty, 23 the sharded fit at p = 3
and p = 1.
Phase 11, run only when listed, re-solves the start of phase 9's 2048^2
path at a tighter tolerance on both routes (the witness for that phase's
gate); phase 14, run only when listed, runs the 4096^2 fits of phase 9
(lambda = 0.05 against the exact-f32 route, lambda_max against the float64
recomputation) and its 2048^2 lambda path on both routes, and holds the
256^3 and 255 x 255 x 256 fits and the 256^3 lambda path against the
exact-f32 route (about 20 minutes on an H100, past the default run's limit);
phase 18, run only when listed, runs C3's check (mvtv(folds=3,
n_lambda=3) at 256 x 256 x 64 on the tiled3 route against the exact-f32
route's tie set) at tol = 1e-4 and again at 1e-5 (the witness for its
tolerances; about 18 minutes);
phase 24, run only when listed, needs four cards: it runs mvtv_sharded
across them, one NCCL rank a card in spawned processes (a probe of every
collective, then 2048^2, 256^3 on both x-update arms, the fused lasso at
N = 2^20 and 1024^2 with 4 folds on dp = 4 and dp = 2 x sx = 2), each fit
against its witness on card 0 as a group of one, and times the iterations
on four ranks beside one; with fewer cards its first check fails;
phase 19, run only when listed, prints digests of the kernels' outputs on
seeded inputs and times B1, B2, B4, B5, B7, B8, B9, B9s and its matvec,
B10, B11s, B13 and T1 at their launch sizes with nothing else (copied into
an older checkout's root, it times that tree's kernels: an A/B in one
call).  Each
phase header carries the seconds since the start.

    python3 chip_smoke.py --phases 1,2,3      # build and kernel checks only
    python3 chip_smoke.py --phases 1,2,12,13  # the p = 3 path and its timing
    python3 chip_smoke.py --phases 1,2,15     # the profiles' fits
    python3 chip_smoke.py --phases 1,2,16,17  # the sharded path and its timing
    python3 chip_smoke.py --phases 1,2,11     # the path-gap witness
    python3 chip_smoke.py --phases 1,2,19     # kernels at their launch sizes
    python3 chip_smoke.py --phases 1,2,20,21  # the p = 1 path, meshes, T1's timing
    python3 chip_smoke.py --phases 1,2,22     # the x-update arms, the resumed path
    python3 chip_smoke.py --phases 1,2,23     # the sharded fit at p = 3 and p = 1
    python3 chip_smoke.py --phases 1,2,24     # the sharded fit across four cards
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time

import numpy as np

FAILURES = []
GPU_LINE = "unknown"
T_START = time.perf_counter()
# Set in phase 24's worker processes but the first: they print nothing.
QUIET = False


def log(msg: str) -> None:
    if QUIET:
        return
    if msg.startswith("phase "):
        msg += f" [{time.perf_counter() - T_START:.1f} s]"
    print(msg, flush=True)


def check(ok: bool, what: str) -> bool:
    log(("  ok   " if ok else "  FAIL ") + what)
    if not ok:
        FAILURES.append(what)
    return ok


def rel_err(got, ref) -> float:
    """max |got - ref| / max(1, max |ref|)."""
    got = got.double()
    ref = ref.double()
    return float((got - ref).abs().max() / max(1.0, float(ref.abs().max())))


def block_diffs(th: np.ndarray, deltas):
    """(scale, D_b th unscaled) of every block b of the full set: chained
    forward differences along the axes with b_j = 1, scaled by the product
    of the other axes' cell sizes."""
    p = th.ndim
    for n in range(1, 2 ** p):
        b = [(n >> (p - 1 - j)) & 1 for j in range(p)]
        v = th
        for j in range(p):
            if b[j]:
                v = np.diff(v, axis=j)
        yield float(np.prod([deltas[j] for j in range(p) if not b[j]])), v


def objective64(res: dict, full: bool = True) -> float:
    """0.5 ||y - O theta||^2 + lambda ||D theta||_1 in float64, from the fit's
    host arrays (the full block set of any p, or without full the reduced
    one: no all-ones block)."""
    th = res["theta_lattice"].astype(np.float64)
    deltas = [float(v) for v in res["mesh_spec"].deltas.cpu()]
    fid = 0.5 * np.sum((res["y"] - res["fitted"].astype(np.float64)) ** 2)
    blocks = list(block_diffs(th, deltas))
    pen = sum(s * np.abs(v).sum() for s, v in (blocks if full else blocks[:-1]))
    return fid + res["lambda"] * pen


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def bivariate_exp(n: int, seed: int = 117):
    """bench.py's e2e recipe: x ~ U(-1, 1)^2, y = exp(-|x|^2) + N(0, 0.3^2)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 2))
    return x, np.exp(-(x[:, 0] ** 2 + x[:, 1] ** 2)) + rng.randn(n) * 0.3


def bench_data(n: int, seed: int = 0):
    """The 512^2 headline workload's data (x ~ U(-1, 1)^2, y ~ N(0, 1))."""
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (n, 2)), rng.randn(n)


WORKLOADS = {
    # name: (data, m, lambda); lambda = 10 is near the truth-MSE optimum of
    # the bivariate-exp fit at 316^2 (a CPU scan of 0.3 .. 30).
    "316^2 n=1e5": (lambda: bivariate_exp(100_000), None, 10.0),
    "512^2 n=2^20": (lambda: bench_data(1 << 20), (512, 512), 0.05),
    "317^2 n=1e5 (padded to 318^2)": (lambda: bivariate_exp(100_000), (317, 317), 10.0),
}


# The lam=None (lambda_max) fit of "316^2 n=1e5".  Its optimum is known in
# closed form: theta == mean(y), objective f* = 0.5 sum (y - mean(y))^2.  At
# the default tol = 1e-4 Boyd's absolute tolerance (~1e-4 sqrt(3 m^2)) lets
# a smooth low-frequency drift of theta through, and lambda_max ~ 9e3
# multiplies its ||D theta||_1: the JAX package's own fit of this problem
# (exact-f32 route, CPU) stops at objective 7.3558 f* with
# max|theta - mean(y)| = 0.4471.  Both routes are held to that point, and
# the kernel route to the exact one at the spread of the card's
# run-dependent O'y sums (kernel vs exact 9.7e-5 .. 1.15e-3 over three H100
# runs), one-sided: where the stall detection lets the chunked loop run
# longer, the kernel route stops closer to the optimum (9.9e-3 below the
# exact route in one H100 run, 516 chunked iterations against 452).
LAMBDA_MAX_JAX = (7.3558, 0.4471)
LAMBDA_MAX_MARGIN = (1.01, 1.05)
LAMBDA_MAX_ROUTE_GAP = 3e-3
# The JAX package's mvtv on the "316^2 n=1e5" data with the port's fold
# labels, run on the CPU (its exact-f32 route; 149 s) by:
#
#   import jax.numpy as jnp, numpy as np
#   from multivartv_tpu import api
#   from multivartv_tpu.solver import cv
#   x, y = bivariate_exp(100_000)
#   labels = np.random.RandomState(123).permutation(np.arange(100_000) % 5)
#   cv.kfold_indices = lambda n, k, seed: jnp.asarray(labels, jnp.int32)
#   model = api.mvtv(x, y, n_lambda=20, folds=5)
#   # lambda_max = model.lambdas[0], best = model.lambda_minmse_ind,
#   # cv_mses = model.cv_mses, and per lambda i the objective
#   # 0.5 ||y - fitted||^2 + lambda ||D theta||_1 in float64 of
#   # model.models[i] (theta_hat unflattened from the reference order).
MVTV_JAX = dict(
    lambda_max=9146.8623046875, best=14,
    cv_mses=[0.09065904468297958, 0.09065737575292587, 0.09065575152635574,
             0.09065414220094681, 0.09065254777669907, 0.09065097570419312,
             0.09064944088459015, 0.09064791351556778, 0.0906464010477066,
             0.09064491838216782, 0.09064345806837082, 0.09064199775457382,
             0.0906405821442604, 0.09063916653394699, 0.09063845872879028,
             0.09073533117771149, 0.09102612733840942, 0.09169665724039078,
             0.09313014149665833, 0.09558068215847015],
    objectives=[79149.97008787579, 50275.174237374085, 32569.956337121075,
                21713.140884840243, 15055.283101802892, 10972.246527278687,
                8468.140873049246, 6932.320557223875, 5990.340267352103, 5412.571372603768,
                5058.193744716168, 4840.836450732243, 4707.527704006719, 4625.778635631743,
                4621.4583417641, 4628.6807402276, 4566.003624134675, 4500.51931276586,
                4411.465413331069, 4288.070960252],
    iters=[113, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 27, 134, 252, 477, 378, 273])
# mvtv's workloads: n samples on the default mesh (316^2 at n = 1e5), and
# the exact-route arm's (n, m, n_lambda, folds): 3 lambdas, not 20, and 2
# folds, not 5, to keep the run inside its time with the large-lattice,
# p = 3 and sharded phases (the exact route took 190-250 s of the run at 20
# lambdas, 71-117 s at 5, 54 s at 3 with 5 folds).
MVTV_N = 100_000
MVTV_ARM = (16_384, (128, 128), 3, 2)
# Gates of the 316^2 mvtv against MVTV_JAX, set from the first H100 run.
# Between lambda_max and index 13 the JAX path takes one iteration per
# lambda (Boyd's absolute tolerance is met at once after the warm start),
# the kernel route a chunk of 4, which moves each fit further toward its
# optimum: there the kernel route's CV curve lies up to 4.6e-4 below JAX's
# and its path objectives up to 3e-2 below (measured).  So:
#   * the chosen index is JAX's or one whose JAX CV MSE is within MVTV_TIE
#     of the minimum (indices 8-14: the curve is that flat there);
#   * the CV curve agrees to MVTV_CURVE (2x the measured 4.6e-4);
#   * the objective at the chosen lambda is no worse than JAX's at that
#     index by more than MVTV_OBJECTIVE (one-sided: a lower objective is a
#     fit closer to the optimum; measured 2.3e-3 lower).
MVTV_TIE = 1e-4
MVTV_CURVE = 1e-3
MVTV_OBJECTIVE = 2e-5
# Kernel vs the float64-summed plain version of B4 from mvtv_one's cold
# start.  A 1-ulp change of an f32 sum moves values across bf16 rounding
# boundaries: the plain version in float32 differs from the float64 one by
# up to 1.2e-3 of max|theta| (B4, K = 4, on the H100) and 3.9e-3 (B3 alone,
# 512^2, CPU); the kernel by up to 9.6e-4 (H100).  A wrong stencil or fold
# moves theta by O(1).
COLD_START_TOL = 5e-3
# B6 from x0 = 0 against its plain version summed in float64: each bf16
# rounding flip moves an element by one bf16 ulp (2^-8 of it), which the
# later CG steps carry, so the largest error counts flips and swings from
# run to run (on the H100 4.7e-3 and 9.3e-3 of max|x| in two runs, the
# float32 plain version 4.5e-3 and 4.8e-3), while the relative 2-norm
# holds still (1.29e-3 and 1.30e-3; plain float32 9.6e-4 and 9.3e-4).  The
# 2-norm gate holds the whole lattice; a wrong transform or stencil moves
# x by O(1).
B6_COLD_MAX = 2.0 ** -5
B6_COLD_L2 = 5e-3
# The large-lattice route (above 2^20 knots, the tiled kernels B8-B10 under
# the spectral-correction CG): mvtv_one at bench.py's 2048^2 (n = 2^22) and
# 4096^2 (n = 2^24) sizes on the default mesh, and a thin lattice whose short
# axis sends the spectral CG to the packed layout and its residual to B10.
LARGE = {
    "2048^2 n=2^22": (lambda: bench_data(1 << 22), None, 0.05),
    "4096^2 n=2^24": (lambda: bench_data(1 << 24), None, 0.05),
    "192x8192 n=2^21": (lambda: bench_data(1 << 21), (192, 8192), 0.05),
}
# Objective gap of a large-lattice fit to the port's exact-f32 route on the
# card (tests/test_pad_single.py:118, the gate of the 512^2 fits), one-sided:
# at tol = 1e-4 Boyd's test stops each route at its own point, and the exact
# route can stop first, further from the optimum (on the CPU at 64^2, n =
# 8192: 9.3e-5 above the kernel routes, which lie 1.3e-6 above the tol =
# 1e-5 optimum).  A lower objective is a fit closer to the optimum.
LARGE_GAP = 2e-5
TILED = ("dual_update_tiled_2d", "gram_residual_tiled_2d", "gram_matvec_tiled_2d")
# Phase 9's mvtv_one fits (LARGE name, lambda; None: lambda_max), and the
# 4096^2 fits that phase 14 runs with mvtv(folds=1, n_lambda=5) at 2048^2
# (51 and 104 s on an H100 with their exact arms), left out of the default
# run for time since the p = 1 path of phase 20 joined it.
LARGE_FITS = (("2048^2 n=2^22", 0.05), ("192x8192 n=2^21", 0.05))
LARGE_DEEP = (("4096^2 n=2^24", 0.05), ("4096^2 n=2^24", None))


def cube_data(n: int, seed: int = 0):
    """The 3-D cells' data (__graft_entry__._make_problem's recipe): x ~
    U(-1, 1)^3, y ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (n, 3)), rng.randn(n)


# The p = 3 route (phase 12): bench.py's 256^3 and 128^3 cells
# (bench.py:485-490), and an odd 255 x 255 x 256 lattice that pads to 256^3
# (the true_m masks in B12).  256^3 takes the tiled3 route (B12, B13), 128^3
# (below 2^22 knots) the no-kernel spectral route.  Gates as LARGE's.
CUBES = {
    "256^3 n=2^22": (lambda: cube_data(1 << 22), (256, 256, 256), 0.05),
    "255x255x256 n=2^22": (lambda: cube_data(1 << 22), (255, 255, 256), 0.05),
    "128^3 n=2^21": (lambda: cube_data(1 << 21), (128, 128, 128), 0.05),
    "256x256x64 n=2^22": (lambda: cube_data(1 << 22), (256, 256, 64), 0.05),
    "258x130x136 n=2^22": (lambda: cube_data(1 << 22), (258, 130, 136), 0.05),
}
# Phase 12's mvtv_one fits, those of them held against the exact-f32 route
# there, and its lambda path's lattice: 2^22 knots, the tiled3 route in the
# packed layout (64 / 2 < 128).  The 256^3 and 255 x 255 x 256 exact arms
# (88-90 s each on an H100), the 255 x 255 x 256 fit itself (48 s) and the
# 256^3 path on both routes (289.5 and 433.9 s) run in phase 14, and C3's
# check (109 s) in phase 18, to keep the default run inside 950 s with the
# p = 1 path of phase 20.
FITS3 = ("256^3 n=2^22", "128^3 n=2^21")
EXACT3 = ("128^3 n=2^21",)
PATH3 = "256x256x64 n=2^22"
TILED3 = ("dual_update_tiled_3d", "gram_residual_tiled_3d", "rhs_tiled_3d")
# The lattices on which phase 3 holds B12 and B13 against their plain
# versions: the main path's 256^3, and one of 2^22 knots or more whose m1
# and m2 are not multiples of the plane march's 8 x 64 tile nor m0 of its
# 32-plane chunk (its remainder tiles and wrap), B12 each with the true_m
# masks of a lattice one knot shorter on axes 0 and 1 (on 256^3: 255 x 255
# x 256); B13 also on PATH3, the C3 folds' lattice.
DUAL3_CHECKS = {"256^3 n=2^22": (255, 255, 256), "258x130x136 n=2^22": (257, 129, 136)}
# Phase 15: the sibling profiles' fits and the remaining 2-D x-update routes
# on bench.py's data (n = 2^20, lambda = 0.05) and the mvtv data (316^2):
# label -> (data, m, lambda, profile, SolverConfig overrides,
# XUPDATE_MAX_KNOTS, the whole route's x-update it takes).  1023^2 is the
# reference default mesh floor(sqrt(N)) of N = 1,046,529 samples, odd, so
# the standalone C++ sibling's theta_inf solve runs it unpadded through B6;
# 2^18 is the JAX package's one-kernel gate on a TPU granted 96 MB of VMEM
# (pallas_kernels.py:41-57, 552), where 1024^2 runs gram_matvec_2d (B7)
# under the fused-dot PCG; 4096 x 256 has no dense DCT matrices
# (problem.py:144-146).  The Python prototype's fixed rho = lambda makes
# every lambda of its own path (up to its "py" lambda_max, 0.097 on this
# data) stop within 6 iterations, and 1.3 to 300 times that run to its
# 5000 cap; lambda = 300 runs about 600 (a CPU scan).
SLICE = {
    "1023^2 cpp_standalone": (lambda: bench_data(1 << 20), (1023, 1023), 0.05,
                              "cpp_standalone", {}, None, "dense"),
    "1024^2 B7 f32 precond": (lambda: bench_data(1 << 20), (1024, 1024), 0.05, "rcpp", {},
                              1 << 18, "fused"),
    "1024^2 B7 bf16 precond": (lambda: bench_data(1 << 20), (1024, 1024), 0.05, "rcpp",
                               {"precond_bf16": True}, 1 << 18, "fused"),
    "4096x256": (lambda: bench_data(1 << 20), (4096, 256), 0.05, "rcpp", {}, None, "spectral"),
    "316^2 python": (lambda: bivariate_exp(100_000), None, 300.0, "python", {}, None, None),
}
SLICE_PATH = "1023^2 cpp_standalone"
# Phase 3 also holds B6 at an odd rectangle that is not a multiple of its
# tensor-core product's 128 x 64 and 64 x 128 tiles: bench.py's data on
# 511 x 2047 (below 2^20 knots: the whole route's dense x-update, as at
# 1023^2), with the 1023^2 gates.  No fit runs there.
SLICE_CHECKS = {"511x2047 cpp_standalone": (lambda: bench_data(1 << 20), (511, 2047), 0.05,
                                            "cpp_standalone", {}, None, "dense")}
# Objective gates of phase 15 against the exact-f32 route with the same
# configs.  Boyd fits: one-sided, LARGE_GAP.  theta_inf is a loose stop that
# leaves each route at its own point (at 316^2 under "python" the exact
# route stops after 167 iterations, 54 % above the kernel route's 595), so
# a theta_inf fit is held two-sided against the exact route run for as
# many iterations from the same state (FIXED_EXACT_GAP), and the 1023^2
# fit, which stops at the profile's 2000 cap, after FIXED_ITERS iterations
# against that route on the plain versions (PLAIN_GAP) and the exact route.
# The path's cold solve at its chosen lambda: against the plain versions,
# and one-sided (THETA_INF_GAP) against the exact route (the port's
# mvtv(folds=1) under the profile lay up to 5.5e-4 from the JAX package's
# CPU path at 15 x 17, tests/test_torch_profiles.py).
THETA_INF_GAP = 1e-3
FIXED_ITERS = 300
PLAIN_GAP = 1e-5
FIXED_EXACT_GAP = 5e-4
SLICE_KERNELS = ("xupdate_pcg_2d", "gram_matvec_2d")


def path_inputs(name: str, device, warm_iters: int = 8) -> dict:
    """The kernels' inputs on the main path: a workload's operators and
    problem (padded to even axes where mvtv_one pads), and the ADMM state
    after warm_iters plain iterations from mvtv_one's initial state."""
    import torch
    from multivartv_tpu_torch.api import _as_2d, _resolve_mesh
    from multivartv_tpu_torch.config import DEFAULT_MESH, SolverConfig
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import admm, pad
    from multivartv_tpu_torch.solver.problem import build_operators, build_problem

    make, m, lam = WORKLOADS[name]
    x, y = make()
    x = _as_2d(x)
    spec = _resolve_mesh(x, m, DEFAULT_MESH, device)
    ops = build_operators(spec.m, spec.deltas, SolverConfig(), device)
    problem = build_problem(spec, torch.as_tensor(x, dtype=torch.float32, device=device),
                            torch.as_tensor(y, dtype=torch.float32, device=device))
    lam_t = torch.tensor(lam, dtype=torch.float32, device=device)
    state = admm.initial_state(ops, problem, lam_t)
    true_m = None
    if pad.needs_padding(ops.m):
        true_m = ops.m
        problem = pad.pad_problem(problem, ops.m, ops.padded.m)
        state = pad.pad_state(state, ops.m, ops.padded.m)
        ops = ops.padded
    cbar = torch.sum(problem.counts) / ops.ntheta
    th, u, a, rho, us, _ = K.admm_iters_2d_reference(
        state.theta, state.u, state.alpha, problem.counts, problem.oty, ops.dct_halves_lp,
        ops.gram_eigs_packed, lam_t, state.rho, state.u_scale, cbar, ops.scales, warm_iters,
        3, true_m=true_m)
    return dict(ops=ops, problem=problem, state0=state, counts=problem.counts,
                oty=problem.oty, theta=th, u=u, alpha=a, rho=rho, u_scale=us, lam=lam_t,
                cbar=cbar, true_m=true_m, m=ops.m)


def cv_inputs(name: str, device, warm_iters: int = 8, folds: int = 5) -> dict:
    """B5's inputs on mvtv's CV path: a workload's fold problems (the port's
    fold labels), their batched initial state at rho = lambda, and the state
    after warm_iters plain B5 iterations at the workload's lambda."""
    import torch
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH, CVConfig, SolverConfig
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import admm, cv

    make, m, lam = WORKLOADS[name]
    x, y = make()
    _, _, spec, x_t, y_t, ops, _ = _setup(x, y, m, None, SolverConfig(), DEFAULT_MESH, device)
    labels = cv.kfold_indices(len(y), folds, CVConfig().seed)
    problems = cv.fold_problems(spec, x_t, y_t, labels, folds)
    lams = torch.full((folds,), lam, dtype=torch.float32, device=device)
    s0 = admm.initial_state_batched(ops, problems, lams)
    cbars = torch.sum(problems.counts, dim=(1, 2)) / ops.ntheta
    th, u, a, rho, us, _ = K.admm_iters_2d_batched_reference(
        s0.theta, s0.u, s0.alpha, problems.counts, problems.oty, ops.dct_halves_lp,
        ops.gram_eigs_packed, lams, s0.rho, s0.u_scale, cbars, ops.scales, warm_iters, 3)
    return dict(ops=ops, problems=problems, state0=s0, lams=lams, cbars=cbars, theta=th, u=u,
                alpha=a, rho=rho, u_scale=us, m=ops.m)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    global GPU_LINE
    import torch
    log("phase 1: device")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        GPU_LINE = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as exc:
        GPU_LINE = f"nvidia-smi unavailable ({exc})"
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    log(f"  nvidia-smi: {GPU_LINE}")
    log("  TF32 off for matmul and cuDNN")


def phase_build():
    from multivartv_tpu_torch.ops import _build
    log("phase 2: build")
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"  {path.relative_to(_build.PKG_DIR.parent)} in {time.perf_counter() - t0:.1f} s")


def compare_kernels(name, device, errs):
    """Each kernel against its plain version on one workload's main-path
    inputs; records the largest absolute error per kernel in errs."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K

    I = path_inputs(name, device)
    ops, sc, true_m = I["ops"], I["ops"].scales, I["true_m"]
    hv, eigs = ops.dct_halves_lp, ops.gram_eigs_packed
    rho, us = I["rho"], I["u_scale"]
    tag = f"{name} [{I['m'][0]}x{I['m'][1]}]"

    def note(kernel, got, ref):
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        e = max(float((g.double() - r.double()).abs().max()) for g, r in pairs)
        errs[kernel] = max(errs.get(kernel, 0.0), e)

    b = K.rhs_2d(I["alpha"], I["u"], I["oty"], rho, us, sc)
    b_ref = K.rhs_2d_reference(I["alpha"], I["u"], I["oty"], rho, us, sc)
    torch.cuda.synchronize()
    e = rel_err(b, b_ref)
    note("rhs_2d", b, b_ref)
    check(e <= 1e-5, f"rhs_2d {tag}: max err {e:.3e} <= 1e-5 x max(1, |ref|)")

    x, rsq = K.xupdate_pcg_2d_packed(b_ref, I["theta"], I["counts"], hv, eigs, rho, I["cbar"],
                                     sc, 3)
    x_r, rsq_r = K.xupdate_pcg_2d_packed_reference(b_ref, I["theta"], I["counts"], hv, eigs,
                                                   rho, I["cbar"], sc, 3)
    torch.cuda.synchronize()
    e = float((x - x_r).abs().max() / x_r.abs().max())
    note("xupdate_pcg_2d_packed", x, x_r)
    check(e <= 1e-3, f"xupdate_pcg_2d_packed {tag}: x err {e:.3e} <= 1e-3 x max|x|")
    check(torch.allclose(rsq.double(), rsq_r.double(), rtol=1e-2, atol=0),
          f"xupdate_pcg_2d_packed {tag}: |r|^2 {float(rsq):.6e} vs {float(rsq_r):.6e} "
          "(rtol 1e-2)")

    kappa = I["lam"] / rho
    a, un, st = K.dual_update_2d(x_r, I["u"], kappa, sc, us, true_m)
    a_r, un_r, st_r = K.dual_update_2d_reference(x_r, I["u"], kappa, sc, us, true_m)
    torch.cuda.synchronize()
    e = max(rel_err(p, q) for p, q in zip(a + un, a_r + un_r))
    note("dual_update_2d", a + un, a_r + un_r)
    check(e <= 1e-5, f"dual_update_2d {tag}: max err {e:.3e} <= 1e-5 x max(1, |ref|)")
    check(torch.allclose(st.double(), st_r.double(), rtol=1e-4, atol=0),
          f"dual_update_2d {tag}: stats {st.tolist()} vs {st_r.tolist()} (rtol 1e-4)")
    # The last CTA adds the partials in a fixed order: a second run repeats
    # bit for bit.
    again = K.dual_update_2d(x_r, I["u"], kappa, sc, us, true_m)
    check(all(torch.equal(p, q) for p, q in zip((*a, *un, st), (*again[0], *again[1], again[2]))),
          f"dual_update_2d {tag}: a second run is bit-identical")

    args = (I["theta"], I["u"], I["alpha"], I["counts"], I["oty"], hv, eigs, I["lam"], rho,
            us, I["cbar"], sc)
    scratch = {}   # held across calls, as a solve holds it: the second run reuses it
    out = K.admm_iters_2d(*args, k_iters=4, n_steps=3, true_m=true_m, scratch=scratch)
    ref = K.admm_iters_2d_reference(*args, k_iters=4, n_steps=3, true_m=true_m)
    torch.cuda.synchronize()
    e = float((out[0] - ref[0]).abs().max() / ref[0].abs().max())
    note("admm_iters_2d", out[0], ref[0])
    check(e <= 1e-3, f"admm_iters_2d {tag} K=4: theta err {e:.3e} <= 1e-3 x max|theta|")
    check(float(out[3]) == float(ref[3]) and float(out[4]) == float(ref[4]),
          f"admm_iters_2d {tag} K=4: (rho, u_scale) {float(out[3]), float(out[4])} == "
          f"{float(ref[3]), float(ref[4])}")
    check(torch.allclose(out[5].double(), ref[5].double(), rtol=1e-2, atol=0),
          f"admm_iters_2d {tag} K=4: stats {out[5].tolist()} vs {ref[5].tolist()} "
          "(rtol 1e-2)")
    # From mvtv_one's cold start (the first chunk of every fit), against the
    # plain version summed in float64 with the same bf16 rounding points.
    s0 = I["state0"]

    def cold(dt):
        return (s0.theta.to(dt), tuple(v.to(dt) for v in s0.u),
                tuple(v.to(dt) for v in s0.alpha), I["counts"].to(dt), I["oty"].to(dt), hv,
                eigs.to(dt), I["lam"].to(dt), s0.rho.to(dt), s0.u_scale.to(dt),
                I["cbar"].to(dt), sc)

    c_k = K.admm_iters_2d(*cold(torch.float32), k_iters=4, n_steps=3, true_m=true_m)
    c_32 = K.admm_iters_2d_reference(*cold(torch.float32), k_iters=4, n_steps=3, true_m=true_m)
    c_64 = K.admm_iters_2d_reference(*cold(torch.float64), k_iters=4, n_steps=3, true_m=true_m)
    torch.cuda.synchronize()
    top = float(c_64[0].abs().max())
    e_k = float((c_k[0].double() - c_64[0]).abs().max()) / top
    e_32 = float((c_32[0].double() - c_64[0]).abs().max()) / top
    check(e_k <= COLD_START_TOL,
          f"admm_iters_2d {tag} K=4 cold start: theta err {e_k:.3e} vs the float64-summed "
          f"plain version <= {COLD_START_TOL:g} x max|theta| (plain float32: {e_32:.3e})")
    check(float(c_k[3]) == float(c_32[3]) and float(c_k[4]) == float(c_32[4]),
          f"admm_iters_2d {tag} K=4 cold start: (rho, u_scale) "
          f"{float(c_k[3]), float(c_k[4])} == {float(c_32[3]), float(c_32[4])}")

    # No float atomics anywhere: a second run, the persistent launch again
    # on the same buffers, repeats bit for bit.
    again = K.admm_iters_2d(*args, k_iters=4, n_steps=3, true_m=true_m, scratch=scratch)
    check(all(torch.equal(p, q) for p, q in zip((out[0], *out[1], *out[2], out[5]),
                                                (again[0], *again[1], *again[2], again[5]))),
          f"admm_iters_2d {tag} K=4: a second run (the persistent launch again) is "
          "bit-identical")


def compare_b5(name, device, errs):
    """B5 against its plain version on the CV folds of a workload, against
    B4 row by row, under an activity mask, in shared mode, and against
    itself; records the largest absolute error in errs."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K

    I = cv_inputs(name, device)
    ops, counts, oty = I["ops"], I["problems"].counts, I["problems"].oty
    hv, eigs, sc, lams, cbars = ops.dct_halves_lp, ops.gram_eigs_packed, ops.scales, I["lams"], \
        I["cbars"]
    folds = int(lams.shape[0])
    tag = f"{name} [{folds} folds of {ops.m[0]}x{ops.m[1]}]"

    def state(src, dt=torch.float32):
        th, u, a = src
        return (th.to(dt).clone(), tuple(w.to(dt).clone() for w in u),
                tuple(x.to(dt).clone() for x in a))

    warm = (I["theta"], I["u"], I["alpha"])

    def run(src, active=None, shared=False, rho=None, us=None):
        c, o = (counts[0], oty[0]) if shared else (counts, oty)
        return K.admm_iters_2d_batched(*state(src), c, o, hv, eigs, lams,
                                       I["rho"] if rho is None else rho,
                                       I["u_scale"] if us is None else us, cbars, sc,
                                       k_iters=4, n_steps=3, active=active)

    out = run(warm)
    ref = K.admm_iters_2d_batched_reference(*state(warm), counts, oty, hv, eigs, lams,
                                            I["rho"], I["u_scale"], cbars, sc, 4, 3)
    torch.cuda.synchronize()
    e = max(float((out[0][b] - ref[0][b]).abs().max() / ref[0][b].abs().max())
            for b in range(folds))
    errs["admm_iters_2d_batched"] = float((out[0] - ref[0]).abs().max())
    check(e <= 1e-3, f"admm_iters_2d_batched {tag} K=4: theta err {e:.3e} <= 1e-3 x max|theta|")
    check(torch.equal(out[3], ref[3]) and torch.equal(out[4], ref[4]),
          f"admm_iters_2d_batched {tag} K=4: (rho, u_scale) {out[3].tolist()}, "
          f"{out[4].tolist()} == plain")
    check(torch.allclose(out[5].double(), ref[5].double(), rtol=1e-2, atol=0),
          f"admm_iters_2d_batched {tag} K=4: stats within rtol 1e-2 of plain")

    # Row b of B5 is B4 on fold b, bit for bit: B4 is the B = 1 launch of
    # the same persistent kernel, whose per-problem work items and summation
    # order do not depend on B.
    same = True
    for b in range(folds):
        one = K.admm_iters_2d(I["theta"][b], tuple(w[b] for w in I["u"]),
                              tuple(x[b] for x in I["alpha"]), counts[b], oty[b], hv, eigs,
                              lams[b], I["rho"][b], I["u_scale"][b], cbars[b], sc, 4, 3)
        same &= all(torch.equal(p, q) for p, q in zip(
            (out[0][b], *(w[b] for w in out[1]), *(x[b] for x in out[2]), out[3][b], out[4][b],
             out[5][b]), (one[0], *one[1], *one[2], one[3], one[4], one[5])))
    check(same, f"admm_iters_2d_batched {tag}: row b == admm_iters_2d on fold b, bit for bit")

    active = torch.tensor([b % 2 == 0 for b in range(folds)], device=device)
    masked = run(warm, active=active)
    frozen_ok = active_ok = True
    for b in range(folds):
        rows = (masked[0][b], *(w[b] for w in masked[1]), *(x[b] for x in masked[2]))
        if active[b]:
            active_ok &= torch.equal(masked[0][b], out[0][b]) and torch.equal(masked[5][b],
                                                                              out[5][b])
        else:
            frozen_ok &= all(torch.equal(r, w[b]) for r, w in zip(
                rows, (I["theta"], *I["u"], *I["alpha"])))
            frozen_ok &= (float(masked[3][b]) == float(I["rho"][b])
                          and float(masked[4][b]) == float(I["u_scale"][b])
                          and not bool(masked[5][b].any()))
    check(frozen_ok, f"admm_iters_2d_batched {tag}: frozen rows, rho, u_scale untouched "
          "bit for bit, stats 0")
    check(active_ok, f"admm_iters_2d_batched {tag}: active rows == the unmasked run")

    shared = run(warm, shared=True)
    per = K.admm_iters_2d_batched(*state(warm), counts[0].expand_as(counts).contiguous(),
                                  oty[0].expand_as(oty).contiguous(), hv, eigs, lams, I["rho"],
                                  I["u_scale"], cbars, sc, k_iters=4, n_steps=3)
    check(torch.equal(shared[0], per[0]) and torch.equal(shared[5], per[5]),
          f"admm_iters_2d_batched {tag}: shared counts/oty == the same counts per problem")

    again = run(warm)
    check(all(torch.equal(p, q) for p, q in zip((out[0], *out[1], *out[2], out[5]),
                                                (again[0], *again[1], *again[2], again[5]))),
          f"admm_iters_2d_batched {tag} K=4: a second run is bit-identical")

    # From the folds' cold start (the first chunk of the CV path), against
    # the plain version summed in float64 (COLD_START_TOL).
    s0 = I["state0"]
    cold = (s0.theta, s0.u, s0.alpha)
    c_k = run(cold, rho=s0.rho, us=s0.u_scale)
    c_32 = K.admm_iters_2d_batched_reference(*state(cold), counts, oty, hv, eigs, lams, s0.rho,
                                             s0.u_scale, cbars, sc, 4, 3)
    d = torch.float64
    c_64 = K.admm_iters_2d_batched_reference(*state(cold, d), counts.to(d), oty.to(d), hv,
                                             eigs.to(d), lams.to(d), s0.rho.to(d),
                                             s0.u_scale.to(d), cbars.to(d), sc, 4, 3)
    torch.cuda.synchronize()
    e_k = max(float((c_k[0][b].double() - c_64[0][b]).abs().max() / c_64[0][b].abs().max())
              for b in range(folds))
    e_32 = max(float((c_32[0][b].double() - c_64[0][b]).abs().max() / c_64[0][b].abs().max())
               for b in range(folds))
    check(e_k <= COLD_START_TOL,
          f"admm_iters_2d_batched {tag} K=4 cold start: theta err {e_k:.3e} vs the "
          f"float64-summed plain version <= {COLD_START_TOL:g} x max|theta| (plain float32: "
          f"{e_32:.3e})")
    check(torch.equal(c_k[3], c_32[3]) and torch.equal(c_k[4], c_32[4]),
          f"admm_iters_2d_batched {tag} K=4 cold start: (rho, u_scale) == plain float32")


def tiled_inputs(name: str, device, warm_iters: int = 4, workload=None) -> dict:
    """The tiled kernels' inputs on the large-lattice path: a LARGE
    workload's (or the given (make, m, lam)'s) operators and problem,
    mvtv_one's initial state with its adjoint carries seeded, and the state
    after warm_iters iterations of the tiled route (which launch the
    kernels)."""
    import torch
    from multivartv_tpu_torch.api import _as_2d, _resolve_mesh
    from multivartv_tpu_torch.config import DEFAULT_MESH, SolverConfig
    from multivartv_tpu_torch.solver import admm, pad
    from multivartv_tpu_torch.solver.problem import build_operators, build_problem

    make, m, lam = workload or LARGE[name]
    x, y = make()
    x = _as_2d(x)
    spec = _resolve_mesh(x, m, DEFAULT_MESH, device)
    cfg = SolverConfig()
    ops = build_operators(spec.m, spec.deltas, cfg, device)
    assert not pad.needs_padding(ops.m) and admm.tiled_route(ops, cfg)
    problem = build_problem(spec, torch.as_tensor(x, dtype=torch.float32, device=device),
                            torch.as_tensor(y, dtype=torch.float32, device=device))
    lam_t = torch.tensor(lam, dtype=torch.float32, device=device)
    state0 = admm._seed_adjoints(ops, admm.initial_state(ops, problem, lam_t))
    body = admm.make_admm_iteration(ops, problem, lam_t, cfg)
    s = state0
    for _ in range(warm_iters):
        s = body(s)
    return dict(ops=ops, problem=problem, state0=state0, s=s, lam=lam_t, cfg=cfg, m=ops.m)


def compare_tiled(name, device, errs):
    """B8, B9 and B10 against their plain versions on a large lattice's
    path inputs; records the largest absolute error per kernel in errs."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import admm, xupdate

    I = tiled_inputs(name, device)
    ops, pr, s = I["ops"], I["problem"], I["s"]
    sc = ops.scales
    tag = f"{name} [{I['m'][0]}x{I['m'][1]}, {xupdate.spectral_layout(ops)} layout]"

    def note(kernel, got, ref):
        e = max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref))
        errs[kernel] = max(errs.get(kernel, 0.0), e)
        return max(rel_err(g, r) for g, r in zip(got, ref))

    kappa = I["lam"] / s.rho
    # The two flag pairs the kernel is compiled for: the ADMM loop's
    # (carries, no alpha) and B1's (alpha, no carries).
    for want_adj, want_alpha in ((True, False), (False, True)):
        got = K.dual_update_tiled_2d(s.theta, s.u, kappa, sc, s.u_scale, None, want_adj,
                                     want_alpha)
        ref = K.dual_update_tiled_2d_reference(s.theta, s.u, kappa, sc, s.u_scale, None,
                                               want_adj, want_alpha)
        torch.cuda.synchronize()
        lat = [(*(g[0] or ()), *g[1], *g[3:]) for g in (got, ref)]
        e = note("dual_update_tiled_2d", *lat)
        check(e <= 1e-5, f"dual_update_tiled_2d {tag} want_adjoints={want_adj} want_alpha="
              f"{want_alpha}: alpha, u_new, dta, dtu max err {e:.3e} <= 1e-5 x max(1, |ref|)")
        check(torch.allclose(got[2].double(), ref[2].double(), rtol=1e-4, atol=0),
              f"dual_update_tiled_2d {tag}: stats {got[2].tolist()} vs {ref[2].tolist()} "
              "(rtol 1e-4)")

    parts = (pr.oty, s.dta, s.u_scale, s.dtu)
    b = pr.oty + s.rho * (s.dta + s.u_scale * s.dtu)
    for label, bb, rp in (("fused rhs", None, parts), ("b given", b, None)):
        r = K.gram_residual_tiled_2d(bb, s.theta, pr.counts, s.rho, sc, rhs_parts=rp)
        r_ref = K.gram_residual_tiled_2d_reference(bb, s.theta, pr.counts, s.rho, sc,
                                                   rhs_parts=rp)
        torch.cuda.synchronize()
        e = note("gram_residual_tiled_2d", [r], [r_ref])
        check(e <= 1e-5, f"gram_residual_tiled_2d {tag} ({label}): max err {e:.3e} <= 1e-5 x "
              "max(1, |ref|)")
    av = K.gram_matvec_tiled_2d(s.theta, pr.counts, s.rho, sc)
    av_ref = K.gram_matvec_tiled_2d_reference(s.theta, pr.counts, s.rho, sc)
    torch.cuda.synchronize()
    e = note("gram_matvec_tiled_2d", [av], [av_ref])
    check(e <= 1e-5, f"gram_matvec_tiled_2d {tag}: max err {e:.3e} <= 1e-5 x max(1, |ref|)")
    # B11 on the refreshed alpha of the warm state (the tiled loop leaves
    # the state's own alpha at its pre-loop value).
    alpha = admm._refresh_alpha(ops, s, I["lam"]).alpha
    bk = K.rhs_tiled_2d(alpha, s.u, pr.oty, s.rho, s.u_scale, sc)
    b_ref = K.rhs_2d_reference(alpha, s.u, pr.oty, s.rho, s.u_scale, sc)
    torch.cuda.synchronize()
    e = note("rhs_tiled_2d", [bk], [b_ref])
    check(e <= 1e-5, f"rhs_tiled_2d {tag}: max err {e:.3e} <= 1e-5 x max(1, |ref|)")


def cube_inputs(name: str, device, warm_iters: int = 4) -> dict:
    """The p = 3 kernels' inputs: a CUBES workload's operators and problem
    (padded to even axes where mvtv_one pads), mvtv_one's initial state
    with its adjoint carries seeded, and the state after warm_iters
    iterations of its route (the tiled3 route launches B12 and B13)."""
    import torch
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH, SolverConfig
    from multivartv_tpu_torch.solver import admm, pad

    make, m, lam = CUBES[name]
    x, y = make()
    cfg = SolverConfig()
    _, _, _, _, _, ops, problem = _setup(x, y, m, None, cfg, DEFAULT_MESH, device)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=device)
    state = admm.initial_state(ops, problem, lam_t)
    true_m = None
    if admm.pad_single_applies(ops, cfg):
        true_m = ops.m
        problem = pad.pad_problem(problem, ops.m, ops.padded.m)
        state = pad.pad_state(state, ops.m, ops.padded.m)
        ops = ops.padded
    state0 = admm._seed_adjoints(ops, state)
    body = admm.make_admm_iteration(ops, problem, lam_t, cfg, true_m=true_m)
    s = state0
    for _ in range(warm_iters):
        s = body(s)
    # The spectral route drops the carries; B13's fused inputs need them.
    s = admm._seed_adjoints(ops, s)
    return dict(ops=ops, problem=problem, state0=state0, s=s, lam=lam_t, cfg=cfg, m=ops.m,
                true_m=true_m, route=admm.solve_route(ops, cfg))


def compare_tiled3(device, errs):
    """B12 (both compiled flag pairs, and with a true_m mask) on each
    DUAL3_CHECKS lattice, B13 (fused and with b given) there and on the C3
    folds' 256 x 256 x 64, and B14 at 256^3, against their plain versions
    on warm state of the tiled3 route; records the largest absolute error
    per kernel in errs."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import admm, xupdate

    def note(kernel, got, ref):
        e = max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref))
        errs[kernel] = max(errs.get(kernel, 0.0), e)
        return max(rel_err(g, r) for g, r in zip(got, ref))

    for name in (*DUAL3_CHECKS, PATH3):
        I = cube_inputs(name, device)
        ops, pr, s = I["ops"], I["problem"], I["s"]
        sc = ops.scales
        tag = f"{name} [{'x'.join(map(str, I['m']))}, {xupdate.spectral_layout(ops)} layout]"
        check(I["route"] == "tiled3", f"{tag}: the tiled3 route ({I['route']})")
        kappa = I["lam"] / s.rho
        cases = (((True, False, None), (False, True, None), (True, False, DUAL3_CHECKS[name]))
                 if name in DUAL3_CHECKS else ())
        for want_adj, want_alpha, tm in cases:
            got = K.dual_update_tiled_3d(s.theta, s.u, kappa, sc, s.u_scale, tm, want_adj,
                                         want_alpha)
            ref = K.dual_update_tiled_3d_reference(s.theta, s.u, kappa, sc, s.u_scale, tm,
                                                   want_adj, want_alpha)
            torch.cuda.synchronize()
            lat = [(*(g[0] or ()), *g[1], *g[3:]) for g in (got, ref)]
            e = note("dual_update_tiled_3d", *lat)
            label = (f"dual_update_tiled_3d {tag} want_adjoints={want_adj} "
                     f"want_alpha={want_alpha} true_m={tm}")
            check(e <= 1e-5, f"{label}: alpha, u_new, dta, dtu max err {e:.3e} <= 1e-5 x "
                  "max(1, |ref|)")
            check(torch.allclose(got[2].double(), ref[2].double(), rtol=1e-4, atol=0),
                  f"{label}: stats {got[2].tolist()} vs {ref[2].tolist()} (rtol 1e-4)")
            del got, ref, lat
        parts = (pr.oty, s.dta, s.u_scale, s.dtu)
        b = pr.oty + s.rho * (s.dta + s.u_scale * s.dtu)
        for label, bb, rp in (("fused rhs", None, parts), ("b given", b, None)):
            r = K.gram_residual_tiled_3d(bb, s.theta, pr.counts, s.rho, sc, rhs_parts=rp)
            r_ref = K.gram_residual_tiled_3d_reference(bb, s.theta, pr.counts, s.rho, sc,
                                                       rhs_parts=rp)
            torch.cuda.synchronize()
            e = note("gram_residual_tiled_3d", [r], [r_ref])
            check(e <= 1e-5, f"gram_residual_tiled_3d {tag} ({label}): max err {e:.3e} <= "
                  "1e-5 x max(1, |ref|)")
            del r, r_ref
        if name != "256^3 n=2^22":
            del I, s, b, parts
            continue
        # B14 on the refreshed alpha of the warm state (the tiled3 loop leaves
        # the state's own alpha at its pre-loop value).
        alpha = admm._refresh_alpha(ops, s, I["lam"]).alpha
        bk = K.rhs_tiled_3d(alpha, s.u, pr.oty, s.rho, s.u_scale, sc)
        b_ref = K.rhs_tiled_3d_reference(alpha, s.u, pr.oty, s.rho, s.u_scale, sc)
        torch.cuda.synchronize()
        e = note("rhs_tiled_3d", [bk], [b_ref])
        check(e <= 1e-5, f"rhs_tiled_3d {tag}: max err {e:.3e} <= 1e-5 x max(1, |ref|)")
        del I, s, b, bk, b_ref, alpha, parts
    torch.cuda.empty_cache()


def slice_inputs(label: str, device, warm_iters: int = 4) -> dict:
    """A SLICE fit's operators and problem (unpadded), its configs, and the
    state after warm_iters iterations of the exact-f32 route from mvtv_one's
    initial state, the inputs of B1, B2, B6 and B7 on that path."""
    import dataclasses

    import torch
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.config import sibling_profile
    from multivartv_tpu_torch.solver import admm

    make, m, lam, prof, over, _, _ = {**SLICE, **SLICE_CHECKS}[label]
    x, y = make()
    scfg, pcfg, mcfg = sibling_profile(prof)
    scfg = dataclasses.replace(scfg, **over)
    _, _, _, _, _, ops, problem = _setup(x, y, m, None, scfg, mcfg, device)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=device)
    state0 = admm.initial_state(ops, problem, lam_t)
    body = admm.make_admm_iteration(ops, problem, lam_t,
                                    dataclasses.replace(scfg, use_kernels=False))
    s = state0
    for _ in range(warm_iters):
        s = body(s)
    return dict(ops=ops, problem=problem, state0=state0, s=s, lam=lam_t, cfg=scfg, pcfg=pcfg,
                mcfg=mcfg, m=ops.m, x=x, y=y, cbar=torch.sum(problem.counts) / ops.ntheta)


def compare_slice(device, errs):
    """B6 (from the warm state and from x0 = 0), B1 and B2 at 1023^2 and
    511 x 2047 and B7 there (rows not 16-byte aligned: its thread-per-knot
    kernel) and at 1024^2 (the row march) against their plain versions on
    the slice's path inputs, and B7 a second time bit for bit (its ticket
    back at 0); records the largest absolute error per kernel in errs."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K

    def note(kernel, got, ref):
        e = max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref))
        errs[kernel] = max(errs.get(kernel, 0.0), e)

    for label in ("1023^2 cpp_standalone", *SLICE_CHECKS, "1024^2 B7 f32 precond"):
        I = slice_inputs(label, device)
        ops, pr, s, cbar = I["ops"], I["problem"], I["s"], I["cbar"]
        sc, tag = ops.scales, f"{label} [{I['m'][0]}x{I['m'][1]}]"
        v, w = K.gram_matvec_2d(s.theta, pr.counts, s.rho, sc)
        v_r, w_r = K.gram_matvec_2d_reference(s.theta, pr.counts, s.rho, sc)
        torch.cuda.synchronize()
        note("gram_matvec_2d", [v], [v_r])
        e = rel_err(v, v_r)
        check(e <= 1e-5, f"gram_matvec_2d {tag}: A v max err {e:.3e} <= 1e-5 x max(1, |ref|)")
        check(torch.allclose(w.double(), w_r.double(), rtol=1e-5, atol=0),
              f"gram_matvec_2d {tag}: <v, A v> {float(w):.9e} vs {float(w_r):.9e} (rtol 1e-5)")
        v2, w2 = K.gram_matvec_2d(s.theta, pr.counts, s.rho, sc)
        torch.cuda.synchronize()
        route = "row march" if I["m"][1] % 4 == 0 else "thread per knot"
        check(torch.equal(v, v2) and torch.equal(w, w2),
              f"gram_matvec_2d {tag} ({route}): a second run is bit-identical")
        if I["m"][0] % 2 == 0:
            continue
        b = K.rhs_2d(s.alpha, s.u, pr.oty, s.rho, s.u_scale, sc)
        b_r = K.rhs_2d_reference(s.alpha, s.u, pr.oty, s.rho, s.u_scale, sc)
        torch.cuda.synchronize()
        note("rhs_2d", [b], [b_r])
        e = rel_err(b, b_r)
        check(e <= 1e-5, f"rhs_2d {tag}: max err {e:.3e} <= 1e-5 x max(1, |ref|)")
        mats, eigs = ops.dct_mats_lp, ops.gram_eigs
        x, rsq = K.xupdate_pcg_2d(b_r, s.theta, pr.counts, mats, eigs, s.rho, cbar, sc, 3)
        x_r, rsq_r = K.xupdate_pcg_2d_reference(b_r, s.theta, pr.counts, mats, eigs, s.rho,
                                                cbar, sc, 3)
        torch.cuda.synchronize()
        note("xupdate_pcg_2d", [x], [x_r])
        e = float((x - x_r).abs().max() / x_r.abs().max())
        check(e <= 1e-3, f"xupdate_pcg_2d {tag} (warm x0): x err {e:.3e} <= 0.001 x max|x|")
        check(torch.allclose(rsq.double(), rsq_r.double(), rtol=1e-2, atol=0),
              f"xupdate_pcg_2d {tag} (warm x0): |r|^2 {float(rsq):.6e} vs {float(rsq_r):.6e} "
              "(rtol 1e-2)")

        def cold(dt):
            return (b_r.to(dt), torch.zeros_like(s.theta, dtype=dt), pr.counts.to(dt), mats,
                    eigs.to(dt), s.rho.to(dt), cbar.to(dt), sc, 3)

        x, rsq = K.xupdate_pcg_2d(*cold(torch.float32))
        x_32, _ = K.xupdate_pcg_2d_reference(*cold(torch.float32))
        x_64, rsq_64 = K.xupdate_pcg_2d_reference(*cold(torch.float64))
        torch.cuda.synchronize()
        top, d = float(x_64.abs().max()), x.double() - x_64
        e, e_32 = float(d.abs().max()) / top, float((x_32.double() - x_64).abs().max()) / top
        l2, l2_32 = (float(d.norm() / x_64.norm()),
                     float((x_32.double() - x_64).norm() / x_64.norm()))
        check(e <= B6_COLD_MAX and l2 <= B6_COLD_L2,
              f"xupdate_pcg_2d {tag} (cold x0) vs the float64-summed plain version: x err "
              f"{e:.3e} <= {B6_COLD_MAX:g} x max|x|, relative 2-norm {l2:.3e} <= {B6_COLD_L2:g} "
              f"(plain float32: {e_32:.3e}, {l2_32:.3e})")
        check(torch.allclose(rsq.double(), rsq_64, rtol=1e-2, atol=0),
              f"xupdate_pcg_2d {tag} (cold x0): |r|^2 {float(rsq):.6e} vs {float(rsq_64):.6e} "
              "(rtol 1e-2)")
        kappa = I["lam"] / s.rho
        a, un, st = K.dual_update_2d(x_r, s.u, kappa, sc, s.u_scale)
        a_r, un_r, st_r = K.dual_update_2d_reference(x_r, s.u, kappa, sc, s.u_scale)
        torch.cuda.synchronize()
        note("dual_update_2d", a + un, a_r + un_r)
        e = max(rel_err(p, q) for p, q in zip(a + un, a_r + un_r))
        check(e <= 1e-5, f"dual_update_2d {tag}: max err {e:.3e} <= 1e-5 x max(1, |ref|)")
        check(torch.allclose(st.double(), st_r.double(), rtol=1e-4, atol=0),
              f"dual_update_2d {tag}: stats {st.tolist()} vs {st_r.tolist()} (rtol 1e-4)")
        dual2 = K.dual_update_2d(x_r, s.u, kappa, sc, s.u_scale)
        check(all(torch.equal(p, q) for p, q in zip((*a, *un, st),
                                                    (*dual2[0], *dual2[1], dual2[2]))),
              f"dual_update_2d {tag}: a second run is bit-identical")
        # No float atomics: a second run repeats bit for bit.
        again = K.xupdate_pcg_2d(b_r, s.theta, pr.counts, mats, eigs, s.rho, cbar, sc, 3)
        first = K.xupdate_pcg_2d(b_r, s.theta, pr.counts, mats, eigs, s.rho, cbar, sc, 3)
        check(torch.equal(again[0], first[0]), f"xupdate_pcg_2d {tag}: a second run is "
              "bit-identical")
        del I, s, b, b_r, x, x_r, again, first, dual2
    torch.cuda.empty_cache()


def phase_kernels(device, timed):
    log("phase 3: kernels against their plain versions on the card")
    errs = {}
    compare_kernels("512^2 n=2^20", device, errs)
    compare_kernels("316^2 n=1e5", device, {})
    compare_kernels("317^2 n=1e5 (padded to 318^2)", device, {})
    compare_b5("316^2 n=1e5", device, errs)
    compare_slice(device, errs)
    for name in LARGE:
        compare_tiled(name, device, errs)
    compare_tiled3(device, errs)
    compare_shard(device, errs)
    compare_shard3(device, errs)
    probe_dual_struct(device, errs, timed)
    compare_tridiag(device, errs)
    compare_partition(device, errs)
    return errs


def fit(x, y, m, lam, device, **cfg):
    import torch
    from multivartv_tpu_torch import SolverConfig, mvtv_one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mvtv_one(x, y, m=m, lam=lam, solver_config=SolverConfig(**cfg), device=device)
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    res["objective"] = objective64(res)
    return res


def route_split(res: dict) -> str:
    """Where a fit's iterations ran: admm_iters_2d chunks, the per-iteration
    kernels, or the exact-f32 route (the comparison arm, or the tail after
    the bf16 stall escape)."""
    d = res["diagnostics"]
    per_iter = d["iterations"] - d["chunked_iterations"] - d["exact_iterations"]
    return (f"{d['iterations']} iterations ({d['chunked_iterations']} chunked, {per_iter} "
            f"per-iteration kernels, {d['exact_iterations']} exact-f32; escape "
            f"{'fired' if d['escaped'] else 'not fired'})")


def check_lambda_max(name, y, res, ref, gap):
    """The lambda_max fits against the closed-form optimum theta == mean(y)
    and the JAX package's own stopping point (see LAMBDA_MAX_JAX)."""
    fstar = 0.5 * float(np.sum((y - y.mean()) ** 2))
    obj_lim = LAMBDA_MAX_JAX[0] * LAMBDA_MAX_MARGIN[0]
    dev_lim = LAMBDA_MAX_JAX[1] * LAMBDA_MAX_MARGIN[1]
    for route, r in (("kernel", res), ("exact", ref)):
        ratio = r["objective"] / fstar
        dev = float(np.max(np.abs(r["theta_lattice"].astype(np.float64) - y.mean())))
        check(ratio <= obj_lim,
              f"{name} {route} route: objective / closed-form optimum {ratio:.6f} <= "
              f"{obj_lim:.4f} (the JAX package stops at {LAMBDA_MAX_JAX[0]})")
        check(dev <= dev_lim,
              f"{name} {route} route: max|theta - mean(y)| {dev:.4f} <= {dev_lim:.4f} "
              f"(the JAX package stops at {LAMBDA_MAX_JAX[1]})")
    check(gap <= LAMBDA_MAX_ROUTE_GAP,
          f"{name}: objective (kernel - exact) / |exact| {gap:+.3e} <= {LAMBDA_MAX_ROUTE_GAP:g}")


def phase_main_path(device):
    """Phases 4 and 5, the first main path: mvtv_one under the launch
    counters, then the exact-f32 comparison solves (which launch no
    kernel)."""
    from multivartv_tpu_torch.ops import kernels as K
    log("phase 4/5: mvtv_one on the card (kernel route), counters reset")
    work = []
    for name, lam, cfg in (("316^2 n=1e5", None, {}), ("316^2 n=1e5", WORKLOADS["316^2 n=1e5"][2], {}),
                           ("512^2 n=2^20", WORKLOADS["512^2 n=2^20"][2], {}),
                           ("512^2 n=2^20", WORKLOADS["512^2 n=2^20"][2], {"chunk_iters": 1})):
        label = f"{name} lam={'lambda_max' if lam is None else f'{lam:g}'}"
        label += " chunk_iters=1" if cfg else ""
        work.append((label, WORKLOADS[name][0](), WORKLOADS[name][1], lam, cfg))
    K.reset_launch_counts()
    fits = []
    for name, (x, y), m, lam, cfg in work:
        before = dict(K.launch_counts)
        res = fit(x, y, m, lam, device, **cfg)
        used = {k: K.launch_counts[k] - before[k] for k in K.KERNELS}
        log(f"  {name}: mesh {res['m']}, {route_split(res)}, converged "
            f"{res['diagnostics']['converged']}, {res['seconds']:.2f} s, launches {used}")
        fits.append((name, (x, y), m, lam, cfg, res, used))
    launches = dict(K.launch_counts)
    log(f"  main-path launch counts: {launches}")
    for name, _, _, _, cfg, res, used in fits:
        check(res["diagnostics"]["converged"], f"{name}: converged")
        if cfg.get("chunk_iters") == 1:
            for k in ("rhs_2d", "xupdate_pcg_2d_packed", "dual_update_2d"):
                check(used[k] > 0, f"{name}: {k} launched ({used[k]})")
        else:
            check(used["admm_iters_2d"] > 0,
                  f"{name}: admm_iters_2d launched ({used['admm_iters_2d']})")
    for k in ("dual_update_2d", "rhs_2d", "xupdate_pcg_2d_packed", "admm_iters_2d"):
        check(launches[k] > 0, f"mvtv_one's path launched {k} ({launches[k]} times)")

    log("phase 4/5: the same problems on the exact-f32 route (use_kernels=False)")
    for name, (x, y), m, lam, cfg, res, _ in fits:
        ref = fit(x, y, m, lam, device, use_kernels=False)
        gap = abs(res["objective"] - ref["objective"]) / abs(ref["objective"])
        log(f"  {name}: exact route {route_split(ref)}, {ref['seconds']:.2f} s; objective "
            f"{res['objective']:.9e} vs {ref['objective']:.9e}")
        if lam is None:
            # O'y is summed with atomics on the card, so lambda_max moves in
            # its last bits from run to run (7e-6 relative between H100 runs).
            check(abs(res["lambda"] - ref["lambda"]) <= 5e-5 * ref["lambda"],
                  f"{name}: lambda_max {res['lambda']:.9g} vs {ref['lambda']:.9g} "
                  "(rtol 5e-5)")
            check_lambda_max(name, y, res, ref,
                             (res["objective"] - ref["objective"]) / abs(ref["objective"]))
        else:
            check(gap <= 2e-5, f"{name}: objective gap {gap:.3e} <= 2e-5")
        check(bool(np.all(np.isfinite(res["theta_lattice"]))), f"{name}: theta finite")
        # At the optimum the residuals sum to zero (TV ignores constants).
        fm, ym = float(res["fitted"].mean()), float(y.mean())
        check(abs(fm - ym) < 5e-4, f"{name}: mean(fitted) {fm:.5f} = mean(y) {ym:.5f} "
              "to 3 decimals")
    return launches, fits


def model_objective(model, i=None) -> float:
    """objective64 of an MVTVModel's fit at lambda index i (default: the
    chosen one), from its host arrays."""
    i = model.lambda_minmse_ind if i is None else i
    if i == model.lambda_minmse_ind:
        theta, fitted = model.theta_lattice, model.fitted
    else:
        theta = model.models[i]["theta_hat"].reshape(model.m[::-1]).T
        fitted = model.models[i]["fitted"]
    return objective64({"theta_lattice": theta, "fitted": fitted, "y": model.y,
                        "mesh_spec": model.mesh_spec, "lambda": float(model.lambdas[i])})


def mvtv_fit(x, y, m, device, n_lambda=20, folds=5, mesh=None, lambdas=None, **cfg):
    """mvtv on the card: (model, its CVResult (None for folds = 1), its
    full-data PathResult, seconds).  The two results are caught on their way
    through solver.cv.cross_validate and solver.path.solve_path."""
    import torch
    from multivartv_tpu_torch import SolverConfig, mvtv
    from multivartv_tpu_torch.solver import cv, path

    seen = {}
    cross_validate, solve_path = cv.cross_validate, path.solve_path

    def cv_spy(*a, **k):
        seen["cv"] = cross_validate(*a, **k)
        return seen["cv"]

    def path_spy(*a, **k):
        seen["path"] = solve_path(*a, **k)
        return seen["path"]

    cv.cross_validate, path.solve_path = cv_spy, path_spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = mvtv(x, y, m=m, mesh=mesh, n_lambda=n_lambda, lambdas=lambdas, folds=folds,
                     device=device, solver_config=SolverConfig(**cfg))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        cv.cross_validate, path.solve_path = cross_validate, solve_path
    return model, seen.get("cv"), seen["path"], seconds


def describe_mvtv(label, model, cvres, fpath, seconds, max_iters=3000):
    """Per lambda: the slowest fold's CV iterations, the fold solves that
    hit the cap, and the full path's iterations and route split."""
    fi = cvres.fold_iters.cpu().numpy()
    slowest, capped = fi.max(axis=0), (fi >= max_iters).sum(axis=0)
    it, ch, ex = (t.cpu().numpy() for t in (fpath.iters, fpath.chunked_iters, fpath.exact_iters))
    esc = fpath.escaped.cpu().numpy()
    log(f"  {label}: {seconds:.2f} s wall, mesh {model.m}, chosen index "
        f"{model.lambda_minmse_ind} (lambda {model.lambda_minmse:.6g}, lambda.1se "
        f"{model.lambda_1se:.6g}), lambda_max {float(model.lambdas[0]):.9g}")
    log(f"    CV: {int(fi.sum())} fold iterations; slowest fold per lambda {slowest.tolist()}; "
        f"capped fold solves per lambda {capped.tolist()} ({int(capped.sum())} in all)")
    log(f"    full path: {int(it.sum())} iterations = {int(ch.sum())} chunked + "
        f"{int(it.sum() - ch.sum() - ex.sum())} per-iteration kernels + {int(ex.sum())} "
        f"exact-f32; escape fired at {int(esc.sum())} of {len(esc)} lambdas; per lambda "
        f"{it.tolist()}")
    log(f"    CV curve {[float(f'{v:.8g}') for v in model.cv_mses]}")


# The p = 1 fit on the default mesh: one column, default config, on the
# card against the same call on the CPU (n, n_lambda, folds, seed).
P1 = (2000, 10, 3, 21)


def check_p1(device):
    """mvtv on one column under the default config (the "tridiag" route:
    T1 on the card, the plain cyclic reduction on the CPU) on the card and
    on the CPU: T1 launched once per iteration of every fold solve, the
    card's chosen index in the CPU run's tie set (CV MSE within MVTV_TIE of
    its minimum), and the objective at it within 1e-5."""
    n, n_lambda, folds, seed = P1
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 1))
    y = np.exp(-x[:, 0] ** 2) + rng.randn(n) * 0.3
    log(f"phase 4/5: mvtv on one column (p = 1, n = {n}, n_lambda = {n_lambda}, folds = "
        f"{folds}), default config (the tridiag route), card vs CPU")
    with t1_fold_spy() as seen:
        card, _, _, seconds = mvtv_fit(x, y, None, device, n_lambda=n_lambda, folds=folds)
    check_t1_folds("mvtv p = 1", seen, folds, n_lambda)
    cpu, _, _, _ = mvtv_fit(x, y, None, "cpu", n_lambda=n_lambda, folds=folds)
    cc = np.asarray(cpu.cv_mses, np.float64)
    best = card.lambda_minmse_ind
    ties = np.nonzero(cc <= cc.min() * (1 + MVTV_TIE))[0].tolist()
    log(f"  p = 1 mesh {card.m}: {seconds:.2f} s on the card [{GPU_LINE}]; CV curve "
        f"{card.cv_mses.tolist()} (CPU {cc.tolist()}); iterations per lambda "
        f"{[e['iters'] for e in card.models]}")
    check(best in ties, f"mvtv p = 1: chosen index {best} in the CPU run's tie set {ties}")
    obj, ref = model_objective(card), model_objective(cpu, best)
    check(abs(obj / ref - 1) <= 1e-5, f"mvtv p = 1: objective at the chosen lambda {obj:.9e} "
          f"vs the CPU run's {ref:.9e} (rel {obj / ref - 1:+.3e}, within 1e-5)")
    check(bool(np.all(np.isfinite(card.theta_lattice))) and card.fitted.shape == y.shape,
          "mvtv p = 1: theta finite, shapes")


def phase_mvtv(device):
    """Phases 4/5, the second main path: mvtv (5 folds, 20 lambdas) at n =
    1e5 on the default 316^2 mesh under the launch counters, gated against
    the JAX package's fit (MVTV_JAX); then at 128^2, n = 16,384, the kernel
    route against the port's exact-f32 route (launches not counted); then
    the p = 1 fit on the card against the CPU (check_p1)."""
    from multivartv_tpu_torch.ops import kernels as K

    log("phase 4/5: mvtv (folds=5, n_lambda=20) on the card, counters reset")
    x, y = bivariate_exp(MVTV_N)
    K.reset_launch_counts()
    model, cvres, fpath, seconds = mvtv_fit(x, y, None, device)
    launches = dict(K.launch_counts)
    describe_mvtv("316^2 n=1e5 kernel route", model, cvres, fpath, seconds)
    log(f"  mvtv launch counts: {launches}")
    for k in ("admm_iters_2d_batched", "admm_iters_2d"):
        check(launches[k] > 0, f"mvtv 316^2: {k} launched ({launches[k]} times)")
    jc = np.asarray(MVTV_JAX["cv_mses"])
    got = np.asarray(model.cv_mses, np.float64)
    best = model.lambda_minmse_ind
    ties = np.nonzero(jc <= jc.min() * (1 + MVTV_TIE))[0].tolist()
    lam_err = abs(float(model.lambdas[0]) / MVTV_JAX["lambda_max"] - 1)
    check(lam_err <= 5e-5, f"mvtv 316^2: lambda_max {float(model.lambdas[0]):.9g} vs JAX "
          f"{MVTV_JAX['lambda_max']:.9g} (rel {lam_err:.2e} <= 5e-5)")
    check(best == MVTV_JAX["best"] or best in ties,
          f"mvtv 316^2: chosen index {best} == JAX's {MVTV_JAX['best']} or in {ties} (JAX CV "
          f"MSE within {MVTV_TIE:g} of its minimum)")
    rel = got / jc - 1
    log(f"    CV curve / JAX's - 1: {[f'{v:+.1e}' for v in rel]}")
    curve = float(np.max(np.abs(rel)))
    check(curve <= MVTV_CURVE, f"mvtv 316^2: CV curve vs JAX max rel {curve:.3e} <= {MVTV_CURVE:g}")
    obj, jobj = model_objective(model), MVTV_JAX["objectives"][best]
    gap = obj / jobj - 1
    check(gap <= MVTV_OBJECTIVE, f"mvtv 316^2: objective at the chosen lambda {obj:.9e} vs "
          f"JAX's at index {best} {jobj:.9e} (rel {gap:+.3e} <= {MVTV_OBJECTIVE:g})")
    paths = [model_objective(model, i) / MVTV_JAX["objectives"][i] - 1 for i in range(len(jc))]
    log(f"    full-path objective / JAX's - 1 per lambda: {[f'{v:+.1e}' for v in paths]}")
    side = int(np.sqrt(MVTV_N))
    check(bool(np.all(np.isfinite(model.theta_lattice)))
          and model.theta_lattice.shape == (side, side) and model.fitted.shape == y.shape,
          "mvtv 316^2: theta finite, shapes")
    fm, ym = float(model.fitted.mean()), float(y.mean())
    check(abs(fm - ym) < 5e-4, f"mvtv 316^2: mean(fitted) {fm:.5f} = mean(y) {ym:.5f} to 3 "
          "decimals")

    log(f"phase 4/5: mvtv at 128^2 n=16384 n_lambda={MVTV_ARM[2]} folds={MVTV_ARM[3]}, kernel "
        "route vs the exact-f32 route")
    x2, y2 = bivariate_exp(MVTV_ARM[0])
    arms = {}
    for route, cfg in (("kernel", {}), ("exact", {"use_kernels": False})):
        arms[route] = mvtv_fit(x2, y2, MVTV_ARM[1], device, n_lambda=MVTV_ARM[2],
                               folds=MVTV_ARM[3], **cfg)
        describe_mvtv(f"128^2 n=16384 {route} route", *arms[route])
    km, em = arms["kernel"][0], arms["exact"][0]
    check(km.lambda_minmse_ind == em.lambda_minmse_ind,
          f"mvtv 128^2: chosen index {km.lambda_minmse_ind} (kernel) == "
          f"{em.lambda_minmse_ind} (exact)")
    curve = float(np.max(np.abs(np.asarray(km.cv_mses, np.float64) / em.cv_mses - 1)))
    check(curve <= MVTV_CURVE, f"mvtv 128^2: CV curve kernel vs exact max rel {curve:.3e} <= "
          f"{MVTV_CURVE:g}")
    i = em.lambda_minmse_ind
    gap = abs(model_objective(km, i) / model_objective(em, i) - 1)
    check(gap <= 2e-5, f"mvtv 128^2: objective at the chosen lambda kernel vs exact {gap:.3e} "
          "<= 2e-5")
    check_p1(device)
    return launches, model


def lam_max64(x, y, spec) -> float:
    """lambda_max recomputed on the host in float64 with numpy and scipy
    alone, independent of the port's code: every sample binned to its
    nearest knot of the fit's lattice (spec: float32 knots and cell sizes)
    with the float32 operations the mesh's definition prescribes (an exact
    midpoint goes to the lower knot; on an irregular axis the nearest of
    the two knots around it, and of equal float32 knots the first), so that
    the samples near a midpoint land where the fit put them; O'y summed in
    float64, (D'D)^+ O'y through scipy's DCT and the Gram eigenvalues of
    the full block set in closed form, prod_j (mu_j + d_j^2) - prod_j d_j^2
    with the Neumann eigenvalues mu = 4 sin^2(pi k / 2m) per axis, then
    5 ||D (D'D)^+ O'y||_inf (the reference's scale, utils.cpp:354).  Any
    p; x of shape (n, p) or (n,) for p = 1."""
    import scipy.fft
    m = tuple(int(v) for v in spec.m)
    x = np.asarray(x, np.float32).reshape(len(x), len(m))
    flat = np.zeros(len(x), np.int64)
    for j, mj in enumerate(m):
        k = spec.knots[j].cpu().numpy().astype(np.float32)
        if spec.regular:
            t = (x[:, j] - k[0]) / ((k[-1] - k[0]) / np.float32(mj - 1))
            i = np.floor(t)
            idx = i.astype(np.int64) + ((t - i) > 0.5)
        else:
            hi = np.clip(np.searchsorted(k, x[:, j], side="left"), 1, mj - 1)
            idx = np.where((k[hi] - x[:, j]) < (x[:, j] - k[hi - 1]), hi, hi - 1)
        flat = flat * mj + np.clip(idx, 0, mj - 1)
    oty = np.bincount(flat, weights=np.asarray(y, np.float64),
                      minlength=int(np.prod(m))).reshape(m)
    d = spec.deltas.double().cpu().numpy()
    mus = np.meshgrid(*(4 * np.sin(np.pi * np.arange(mj) / (2 * mj)) ** 2 for mj in m),
                      indexing="ij", sparse=True)
    prod = 1.0
    for mu, dj in zip(mus, d):
        prod = prod * (mu + dj ** 2)
    eigs = prod - np.prod(d ** 2)
    coef = scipy.fft.dctn(oty, type=2, norm="ortho")
    coef = np.where(eigs > 0, coef / np.where(eigs > 0, eigs, 1.0), 0.0)
    pinv = scipy.fft.idctn(coef, type=2, norm="ortho")
    return 5.0 * max(s * float(np.abs(v).max()) for s, v in block_diffs(pinv, d))


def check_lambda_max64(label, lam, x, y, spec) -> None:
    """The port's lambda_max (float64 through torch.fft) against lam_max64.
    O'y is summed in float32 on the card and in float64 here; binned in
    float64 instead, samples near a midpoint moved lambda_max by 7.5e-5 at
    4096^2 on an H100."""
    ref = lam_max64(x, y, spec)
    err = abs(lam / ref - 1)
    check(err <= 1e-5, f"{label}: lambda_max {lam:.9g} vs {ref:.9g} (numpy and scipy, "
          f"float64): rel {err:.2e} <= 1e-5")


def float32_lambda_max(x, y, device) -> float:
    """lambda_max as the JAX package takes it up to 2048 per axis: float32
    through the dense DCT matrices (TF32 off).  A reading for ROADMAP Queue
    C; no route of the port uses it."""
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH, PathConfig, SolverConfig
    from multivartv_tpu_torch.ops import dct, diff

    _, _, _, _, _, ops, problem = _setup(x, y, None, None, SolverConfig(), DEFAULT_MESH, device)
    pinv = dct.gram_pinv_apply(problem.oty, ops.gram_eigs, ops.dct_mats)
    return float(PathConfig().lam_max_scale * diff.blocks_abs_max(ops.apply_D(pinv)))


def phase_large(device, work=LARGE_FITS, path: bool = False, tag: str = "phase 9"):
    """Phase 9, the third main path: mvtv_one above 2^20 knots (the tiled
    route: B8, B9 or B10 and the spectral-correction CG; work: (LARGE name,
    lambda or None for lambda_max)) and, with path, mvtv(folds=1,
    n_lambda=5) at 2048^2 under the launch counters, then the same problems
    on the port's exact-f32 route (launches not counted).  Phase 14 runs
    the LARGE_DEEP fits and the path through it."""
    from multivartv_tpu_torch.ops import kernels as K

    log(f"{tag}: the large-lattice route (above 2^20 knots) on the card, counters reset")
    data = {name: LARGE[name][0]() for name in dict.fromkeys(n for n, _ in work)}
    K.reset_launch_counts()
    fits = []
    for name, lam in work:
        (x, y), m = data[name], LARGE[name][1]
        before = dict(K.launch_counts)
        res = fit(x, y, m, lam, device)
        used = {k: K.launch_counts[k] - before[k] for k in K.KERNELS if K.launch_counts[k]
                != before[k]}
        label = f"{name} lam={'lambda_max' if lam is None else f'{lam:g}'}"
        log(f"  {label}: mesh {res['m']}, {route_split(res)}, converged "
            f"{res['diagnostics']['converged']}, {res['seconds']:.2f} s [{GPU_LINE}], "
            f"launches {used}")
        fits.append((label, name, lam, res, used))
    if path:
        x2, y2 = data.get("2048^2 n=2^22") or LARGE["2048^2 n=2^22"][0]()
        before = dict(K.launch_counts)
        model, _, fpath, seconds = mvtv_fit(x2, y2, None, device, n_lambda=5, folds=1)
        used_path = {k: K.launch_counts[k] - before[k] for k in K.KERNELS
                     if K.launch_counts[k] != before[k]}
        log(f"  mvtv 2048^2 folds=1 n_lambda=5: {seconds:.2f} s [{GPU_LINE}], chosen index "
            f"{model.lambda_minmse_ind}, iterations per lambda {fpath.iters.tolist()} "
            f"(exact-f32 {fpath.exact_iters.tolist()}), launches {used_path}")
    launches = dict(K.launch_counts)
    log(f"  large-lattice launch counts: {launches}")

    for label, name, lam, res, used in fits:
        d = res["diagnostics"]
        check(d["converged"], f"{label}: converged")
        tiled_iters = d["iterations"] - d["exact_iterations"]
        r0 = "gram_matvec_tiled_2d" if name.startswith("192x") else "gram_residual_tiled_2d"
        for k in ("dual_update_tiled_2d", r0):
            check(used.get(k, 0) == tiled_iters,
                  f"{label}: {k} launched once per tiled iteration ({used.get(k, 0)} for "
                  f"{tiled_iters})")
    for k in TILED[:2]:
        check(launches[k] > 0, f"the large-lattice path launched {k} ({launches[k]} times)")
    if any(name.startswith("192x") for name, _ in work):
        check(launches[TILED[2]] > 0,
              f"the large-lattice path launched {TILED[2]} ({launches[TILED[2]]} times)")
    if path:
        check(used_path.get("dual_update_tiled_2d", 0) > 0,
              f"mvtv 2048^2 folds=1: dual_update_tiled_2d launched "
              f"({used_path.get('dual_update_tiled_2d', 0)} times)")

    log(f"{tag}: the same problems on the exact-f32 route (use_kernels=False)")
    for label, name, lam, res, _ in fits:
        (x, y), m = data[name], LARGE[name][1]
        check(bool(np.all(np.isfinite(res["theta_lattice"]))), f"{label}: theta finite")
        fm, ym = float(res["fitted"].mean()), float(y.mean())
        check(abs(fm - ym) < 5e-4, f"{label}: mean(fitted) {fm:.5f} = mean(y) {ym:.5f} to 3 "
              "decimals")
        if lam is None:
            check_lambda_max64(label, res["lambda"], x, y, res["mesh_spec"])
            fstar = 0.5 * float(np.sum((y - y.mean()) ** 2))
            dev = float(np.max(np.abs(res["theta_lattice"].astype(np.float64) - y.mean())))
            log(f"  {label}: objective / closed-form optimum {res['objective'] / fstar:.6f}, "
                f"max|theta - mean(y)| {dev:.4f}")
            continue
        ref = fit(x, y, m, lam, device, use_kernels=False)
        gap = (res["objective"] - ref["objective"]) / abs(ref["objective"])
        log(f"  {label}: exact route {route_split(ref)}, {ref['seconds']:.2f} s; objective "
            f"{res['objective']:.9e} vs {ref['objective']:.9e}")
        check(gap <= LARGE_GAP, f"{label}: objective (tiled - exact) / |exact| {gap:+.3e} <= "
              f"{LARGE_GAP:g}")
    if not path:
        return launches

    em, _, epath, eseconds = mvtv_fit(x2, y2, None, device, n_lambda=5, folds=1,
                                      use_kernels=False)
    log(f"  mvtv 2048^2 folds=1 n_lambda=5 exact route: {eseconds:.2f} s, iterations per "
        f"lambda {epath.iters.tolist()}")
    # O'y is summed with atomics on the card: lambda_max moves in its last
    # bits from run to run (see phase 4/5).
    check(np.allclose(model.lambdas, em.lambdas, rtol=5e-5, atol=0),
          "mvtv 2048^2 folds=1: the same lambda grid (rtol 5e-5)")
    gaps = [model_objective(model, i) / model_objective(em, i) - 1
            for i in range(len(em.lambdas))]
    log(f"    per-lambda objective (tiled - exact) / |exact|: {[f'{g:+.2e}' for g in gaps]}")
    # Near lambda_max Boyd's absolute tolerance stops both routes far from
    # the optimum, each at its own point (on an H100: +0.18, +0.040 and
    # +0.0029 at the first three lambdas; PERF.md): gated, as mvtv 316^2
    # is, at the chosen lambda, one-sided.
    best = em.lambda_minmse_ind
    check(gaps[best] <= LARGE_GAP, f"mvtv 2048^2 folds=1: objective at the chosen lambda "
          f"(tiled - exact) / |exact| {gaps[best]:+.3e} <= {LARGE_GAP:g}")
    check(model.lambda_minmse_ind == em.lambda_minmse_ind,
          f"mvtv 2048^2 folds=1: chosen index {model.lambda_minmse_ind} == exact route's "
          f"{em.lambda_minmse_ind}")
    check_lambda_max64("mvtv 2048^2 folds=1", float(model.lambdas[0]), x2, y2, model.mesh_spec)
    f32 = float32_lambda_max(x2, y2, device)
    log(f"  2048^2: lambda_max in float32 through the dense DCT matrices (the JAX package's "
        f"route) {f32:.9g}, {f32 / float(model.lambdas[0]) - 1:+.3e} against the port's")
    return launches


def cube_route(m) -> str:
    from multivartv_tpu_torch.solver import admm, pad
    return admm.lattice_route(pad.pad_target_m(m))


def run_cube_path(name, device, **cfg):
    """mvtv(folds=1, n_lambda=5) on a CUBES lattice: (model, path,
    seconds), logged with its route split."""
    (x, y), m = CUBES[name][0](), CUBES[name][1]
    model, _, fpath, seconds = mvtv_fit(x, y, m, device, n_lambda=5, folds=1, **cfg)
    route = "exact" if cfg else cube_route(m)
    log(f"  mvtv {name} folds=1 n_lambda=5 ({route} route): {seconds:.2f} s [{GPU_LINE}], "
        f"chosen index {model.lambda_minmse_ind}, iterations per lambda "
        f"{fpath.iters.tolist()} (exact-f32 {fpath.exact_iters.tolist()})")
    return model, fpath, seconds


def check_cube_fit(label, m, y, res, used=None):
    """A 3-D fit's convergence, values and (with used) its launches."""
    d = res["diagnostics"]
    check(d["converged"], f"{label}: converged")
    check(bool(np.all(np.isfinite(res["theta_lattice"])))
          and res["theta_lattice"].shape == tuple(m), f"{label}: theta finite, shape {m}")
    fm, ym = float(res["fitted"].mean()), float(y.mean())
    check(abs(fm - ym) < 5e-4, f"{label}: mean(fitted) {fm:.5f} = mean(y) {ym:.5f} to 3 decimals")
    if used is None:
        return
    if cube_route(m) == "tiled3":
        tiled_iters = d["iterations"] - d["exact_iterations"]
        for k in TILED3[:2]:
            check(used.get(k, 0) == tiled_iters, f"{label}: {k} launched once per tiled "
                  f"iteration ({used.get(k, 0)} for {tiled_iters})")
    else:
        check(not used, f"{label}: the spectral route launched no kernel ({used})")


def check_against_exact(label, x, y, m, lam, res, device):
    """The one-sided objective gate of a 3-D fit against the exact-f32
    route's fit of the same problem."""
    ref = fit(x, y, m, lam, device, use_kernels=False)
    gap = (res["objective"] - ref["objective"]) / abs(ref["objective"])
    log(f"  {label}: exact route {route_split(ref)}, {ref['seconds']:.2f} s; objective "
        f"{res['objective']:.9e} vs {ref['objective']:.9e}")
    check(gap <= LARGE_GAP, f"{label}: objective ({cube_route(m)} - exact) / |exact| {gap:+.3e} "
          f"<= {LARGE_GAP:g}")


# C3's card check at 256 x 256 x 64 (CUBES' pure-noise data: the CV curve is
# flat at its top).  On that flat top the fold solves converge slowly and
# the CV MSE moves with where a solve stops: on an H100 the exact route's
# at lambda_max moved 3.1e-3 from tol = 1e-4 to tol = 1e-5 (where both
# routes' solves there hit the 3000-iteration cap), and the tiled3 route's
# lay 3.35e-3 (tol 1e-4, two runs) and 2.63e-3 (tol 1e-5) above the exact
# route's, while the exact route's first two lambdas lie 2.2e-4 (3.8e-4)
# apart.  So the chosen index is held to the exact route's tie set at
# MVTV_TIE3 and the whole CV curve to MVTV_GAP3 of the exact route's
# (relative); off the flat top, at the smallest lambda, where every fold
# solve converges, the two curves agreed to 2.0e-5-2.4e-5 at both
# tolerances, and are held to MVTV_LOW3.  A wrong fold solve moves the
# curve by O(1) (the third lambda: 1.527 against 1.003).  Phase 18 runs
# the check at tol = 1e-5, the witness for these numbers.
MVTV_TIE3 = 5e-3
MVTV_GAP3 = 5e-3
MVTV_LOW3 = 1e-4


def exact_cv(x, y, m, n_lambda: int, folds: int, device, tol: float):
    """(lambda grid, CVResult) of mvtv's cross-validation alone on the
    exact-f32 route (no full-data path) at Boyd tolerance tol: the same
    grid, fold labels and fold problems as mvtv."""
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH, CVConfig, PathConfig, SolverConfig
    from multivartv_tpu_torch.solver import cv, path

    cfg, pcfg, cvcfg = SolverConfig(use_kernels=False, tol=tol), \
        PathConfig(n_lambda=n_lambda), CVConfig(folds=folds)
    _, y_np, spec, x_t, y_t, ops, problem = _setup(x, y, m, None, cfg, DEFAULT_MESH, device)
    grid = path.create_lambdas(path.lam_max(ops, problem, pcfg), pcfg)
    problems = cv.fold_problems(spec, x_t, y_t, cv.kfold_indices(len(y_np), folds, cvcfg.seed),
                                folds)
    return grid, cv.cross_validate(ops, problems, grid, cfg, pcfg, cvcfg)


def check_cube_folds(device, tol: float = 1e-4) -> dict:
    """C3 on the card: mvtv(folds=3, n_lambda=3) at 256 x 256 x 64 at Boyd
    tolerance tol, each fold's solve on the tiled3 route (B12 and B13) one
    after another, escape off (the batched solve's semantics), under the
    launch counters; against the exact-f32 route's cross-validation alone
    (exact_cv) at the same tol: its chosen index in that route's tie set
    (MVTV_TIE3), its CV curve within MVTV_GAP3 of that route's and within
    MVTV_LOW3 at the smallest lambda (relative).  Returns the launches of
    the kernel-route fit."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K

    (x, y), m = CUBES[PATH3][0](), CUBES[PATH3][1]
    label = f"mvtv {PATH3} folds=3 tol={tol:g}"
    before = dict(K.launch_counts)
    model, cvres, fpath, seconds = mvtv_fit(x, y, m, device, n_lambda=3, folds=3, tol=tol)
    used = {k: K.launch_counts[k] - before[k] for k in K.KERNELS
            if K.launch_counts[k] != before[k]}
    describe_mvtv(f"{label} n_lambda=3 (tiled3 route)", model, cvres, fpath, seconds)
    log(f"    launches {used}")
    for k in TILED3[:2]:
        check(used.get(k, 0) > 0, f"{label}: {k} launched ({used.get(k, 0)} times)")
    check(bool(np.all(np.isfinite(model.cv_mses))) and model.theta_lattice.shape == m,
          f"{label}: CV curve finite, theta of shape {m}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid, ref = exact_cv(x, y, m, 3, 3, device, tol)
    rc = ref.mean_mse.cpu().numpy().astype(np.float64)
    fi = ref.fold_iters.cpu().numpy()
    log(f"  {label} n_lambda=3, its cross-validation on the exact-f32 route: "
        f"{time.perf_counter() - t0:.2f} s, {int(fi.sum())} fold iterations, slowest fold per "
        f"lambda {fi.max(axis=0).tolist()}; CV curve {[float(f'{v:.8g}') for v in rc]}")
    check(np.allclose(grid.cpu().numpy(), model.lambdas, rtol=1e-6, atol=0),
          f"{label}: the exact route's lambda grid is the kernel route's")
    ties = np.nonzero(rc <= rc.min() * (1 + MVTV_TIE3))[0].tolist()
    check(model.lambda_minmse_ind in ties,
          f"{label}: chosen index {model.lambda_minmse_ind} in the exact-f32 route's tie set "
          f"{ties} (CV MSE within {MVTV_TIE3:g} of its minimum)")
    rel = np.abs(np.asarray(model.cv_mses, np.float64) - rc) / rc
    check(float(rel.max()) <= MVTV_GAP3, f"{label}: the two routes' CV curves "
          f"{float(rel.max()):.3e} apart (relative; per lambda {rel.tolist()}) <= {MVTV_GAP3:g}")
    check(float(rel[-1]) <= MVTV_LOW3, f"{label}: at the smallest lambda the two routes' CV "
          f"MSEs {float(rel[-1]):.3e} apart (relative) <= {MVTV_LOW3:g}")
    return used


def phase_c3_tight(device):
    """Phase 18, run only when asked for (--phases 18; about 18 minutes on
    an H100): C3's card check (check_cube_folds at tol = 1e-4, left out of
    the default run for time), then its witness, the same check with both
    routes at tol = 1e-5."""
    log("phase 18: C3's card check (CV folds on the tiled3 route) at tol = 1e-4")
    check_cube_folds(device)
    log("phase 18: C3's card check at tol = 1e-5 (the witness for its tolerances)")
    check_cube_folds(device, tol=1e-5)


def phase_cubes(device):
    """Phase 12, the fourth main path, under the launch counters: mvtv_one
    on 3-D lattices (256^3 on the tiled3 route, 128^3 on the no-kernel
    spectral route) and mvtv(folds=1, n_lambda=5) at 256 x 256 x 64
    (tiled3 in the packed layout: B13 with b given; C3's folds there run in
    phase 18).  Then,
    launches not counted: 128^3 against the exact-f32 route,
    the path's chosen lambda against a cold exact-f32 fit there, lambda_max
    at 256^3 against lam_max64, and predict (phase 14 holds the rest
    against the exact route)."""
    import torch
    from multivartv_tpu_torch import predict_mvtv
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH, PathConfig, SolverConfig
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import path

    log("phase 12: the p = 3 route on the card, counters reset")
    data = {name: CUBES[name][0]() for name in FITS3}
    K.reset_launch_counts()
    fits = []
    for name in FITS3:
        (x, y), (_, m, lam) = data[name], CUBES[name]
        before = dict(K.launch_counts)
        res = fit(x, y, m, lam, device)
        used = {k: K.launch_counts[k] - before[k] for k in K.KERNELS
                if K.launch_counts[k] != before[k]}
        log(f"  {name} lam={lam:g}: mesh {res['m']}, route {cube_route(m)}, {route_split(res)}, "
            f"converged {res['diagnostics']['converged']}, {res['seconds']:.2f} s [{GPU_LINE}], "
            f"launches {used}")
        fits.append((name, m, lam, res, used))
    before = dict(K.launch_counts)
    model, _, _ = run_cube_path(PATH3, device)
    used_path = {k: K.launch_counts[k] - before[k] for k in K.KERNELS
                 if K.launch_counts[k] != before[k]}
    launches = dict(K.launch_counts)
    log(f"  mvtv {PATH3} launches {used_path}; p = 3 launch counts: {launches}")
    for name, m, lam, res, used in fits:
        check_cube_fit(f"{name} lam={lam:g}", m, data[name][1], res, used)
    for k in TILED3[:2]:
        check(launches[k] > 0, f"the p = 3 path launched {k} ({launches[k]} times)")
        check(used_path.get(k, 0) > 0, f"mvtv {PATH3} folds=1: {k} launched "
              f"({used_path.get(k, 0)} times)")

    log("phase 12: against the exact-f32 route (use_kernels=False)")
    for name, m, lam, res, _ in fits:
        if name in EXACT3:
            check_against_exact(f"{name} lam={lam:g}", *data[name], m, lam, res, device)
    (xp, yp), mp = CUBES[PATH3][0](), CUBES[PATH3][1]
    best = model.lambda_minmse_ind
    lam_best = float(model.lambdas[best])
    check(bool(np.all(np.isfinite(model.theta_lattice))) and model.theta_lattice.shape == mp,
          f"mvtv {PATH3} folds=1: theta finite, shape {mp}")
    check_against_exact(f"mvtv {PATH3} folds=1 at the chosen lambda {lam_best:.6g} (index "
                        f"{best}; the exact fit cold)", xp, yp, mp, lam_best,
                        {"objective": model_objective(model)}, device)
    x, y = data["256^3 n=2^22"]
    _, _, spec, _, _, ops, problem = _setup(x, y, CUBES["256^3 n=2^22"][1], None,
                                            SolverConfig(), DEFAULT_MESH, device)
    check_lambda_max64("256^3", float(path.lam_max(ops, problem, PathConfig())), x, y, spec)
    del ops, problem
    torch.cuda.empty_cache()

    log("phase 12: predict on 3-D data")
    rng = np.random.RandomState(6)
    xq = rng.uniform(-1, 1, (10_000, 3))
    res = fits[0][3]
    pred = predict_mvtv(res, xq)
    check(pred.shape == (10_000,) and bool(np.all(np.isfinite(pred))),
          f"predict_mvtv(mvtv_one 256^3 result): shape {pred.shape}, finite")
    check(np.array_equal(predict_mvtv(res, res["data"]), res["fitted"]),
          "predict_mvtv(256^3 training data) == fitted")
    pred = model.predict(xq)
    check(pred.shape == (10_000,) and bool(np.all(np.isfinite(pred)))
          and np.array_equal(predict_mvtv(model, xq), pred),
          f"MVTVModel.predict ({PATH3}): shape, finite, == predict_mvtv(model)")
    return launches


def phase_cubes_exact(device):
    """Phase 14, run only when asked for (--phases 14): the fits that
    phases 9 and 12 leave out for time: 4096^2 at lambda = 0.05 against the
    exact-f32 route and at lambda_max against lam_max64 (LARGE_DEEP),
    mvtv(folds=1, n_lambda=5) at 2048^2 on both routes; 256^3
    and 255 x 255 x 256 against the exact-f32 route, and mvtv(folds=1,
    n_lambda=5) at 256^3 on both routes (the same grid, the same chosen
    index, the objective at it one-sided, lambda_max against lam_max64)."""
    phase_large(device, LARGE_DEEP, path=True, tag="phase 14")
    log("phase 14: the p = 3 exact-route arms")
    for name in ("256^3 n=2^22", "255x255x256 n=2^22"):
        (x, y), (_, m, lam) = CUBES[name][0](), CUBES[name]
        res = fit(x, y, m, lam, device)
        log(f"  {name} lam={lam:g}: {route_split(res)}, {res['seconds']:.2f} s [{GPU_LINE}]")
        check_cube_fit(f"{name} lam={lam:g}", m, y, res)
        check_against_exact(f"{name} lam={lam:g}", x, y, m, lam, res, device)
    name = "256^3 n=2^22"
    model, _, _ = run_cube_path(name, device)
    em, _, _ = run_cube_path(name, device, use_kernels=False)
    check(np.allclose(model.lambdas, em.lambdas, rtol=5e-5, atol=0),
          f"mvtv {name} folds=1: the same lambda grid (rtol 5e-5)")
    gaps = [model_objective(model, i) / model_objective(em, i) - 1
            for i in range(len(em.lambdas))]
    log(f"    per-lambda objective (tiled3 - exact) / |exact|: {[f'{g:+.2e}' for g in gaps]}")
    best = em.lambda_minmse_ind
    check(model.lambda_minmse_ind == best, f"mvtv {name} folds=1: chosen index "
          f"{model.lambda_minmse_ind} == exact route's {best}")
    check(gaps[best] <= LARGE_GAP, f"mvtv {name} folds=1: objective at the chosen lambda "
          f"(tiled3 - exact) / |exact| {gaps[best]:+.3e} <= {LARGE_GAP:g}")
    x, y = CUBES[name][0]()
    check_lambda_max64(f"mvtv {name} folds=1", float(model.lambdas[0]), x, y, model.mesh_spec)


def slice_configs(label, **extra):
    """(SolverConfig, PathConfig, MeshConfig) of a SLICE fit."""
    import dataclasses
    from multivartv_tpu_torch.config import sibling_profile
    _, _, _, prof, over, _, _ = SLICE[label]
    scfg, pcfg, mcfg = sibling_profile(prof)
    return dataclasses.replace(scfg, **over, **extra), pcfg, mcfg


class xupdate_gate:
    """Context manager: admm.XUPDATE_MAX_KNOTS set to a SLICE fit's value."""

    def __init__(self, label):
        self.knots = SLICE[label][5]

    def __enter__(self):
        from multivartv_tpu_torch.solver import admm
        self.old = admm.XUPDATE_MAX_KNOTS
        if self.knots is not None:
            admm.XUPDATE_MAX_KNOTS = self.knots

    def __exit__(self, *exc):
        from multivartv_tpu_torch.solver import admm
        admm.XUPDATE_MAX_KNOTS = self.old


def slice_fit(label, data, device, **extra):
    """mvtv_one of a SLICE fit with its profile's configs (extra replaces
    SolverConfig fields), timed, with its float64 objective."""
    import torch
    from multivartv_tpu_torch import mvtv_one
    scfg, pcfg, mcfg = slice_configs(label, **extra)
    x, y = data
    with xupdate_gate(label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mvtv_one(x, y, m=SLICE[label][1], lam=SLICE[label][2], solver_config=scfg,
                       path_config=pcfg, mesh_config=mcfg, device=device)
        torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    res["objective"] = objective64(res, scfg.include_full_mixed)
    return res


def slice_route(label, data, device) -> str:
    """The route of a SLICE fit and, on the whole route, its x-update."""
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.solver import admm, xupdate
    scfg, _, mcfg = slice_configs(label)
    _, _, _, _, _, ops, _ = _setup(*data, SLICE[label][1], None, scfg, mcfg, device)
    with xupdate_gate(label):
        route = admm.solve_route(ops, scfg)
        if route == "whole":
            route += " / " + xupdate.whole_xupdate(ops, scfg, admm.xupdate_supported(ops.m))
    return route


class plain_versions:
    """Context manager: every kernel wrapper runs its plain PyTorch version,
    on CUDA tensors too (the dispatch the wrappers take for CPU tensors), so
    a route runs its own arithmetic with no kernel launched."""

    def __enter__(self):
        from multivartv_tpu_torch.ops import kernels as K
        self.old = K._route
        K._route = lambda *tensors: "cpu"

    def __exit__(self, *exc):
        from multivartv_tpu_torch.ops import kernels as K
        K._route = self.old


def solve_objective(ops, problem, spec, y, lam, rho0, cfg, n_iters=None):
    """(float64 objective, iterations, seconds) of a solve from
    mvtv_one's initial state with rho0: admm_solve, or exactly n_iters
    iterations (admm_fixed_iterations)."""
    import torch
    from multivartv_tpu_torch.ops import interp
    from multivartv_tpu_torch.solver import admm
    state = admm.initial_state(ops, problem, rho0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if n_iters is None:
        state = admm.admm_solve(ops, problem, lam, state, cfg)
    else:
        state = admm.admm_fixed_iterations(ops, problem, lam, state, cfg, n_iters)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fitted = interp.gather_fitted(state.theta, problem.flat_idx)
    obj = objective64({"theta_lattice": state.theta.cpu().numpy(),
                       "fitted": fitted.cpu().numpy(), "y": y, "mesh_spec": spec,
                       "lambda": float(lam)}, cfg.include_full_mixed)
    return obj, int(state.counter) if n_iters is None else n_iters, seconds


def check_route_arms(label, kernel_obj, arms):
    """Log and gate a kernel-route objective against each arm (the same
    solve on the plain versions or on the exact route), two-sided at the
    arm's limit; arms: {name: ((objective, iterations, seconds), limit)}."""
    for arm, ((obj, iters, seconds), lim) in arms.items():
        gap = kernel_obj / obj - 1
        log(f"  {label}, {arm}: {iters} iterations, {seconds:.2f} s [{GPU_LINE}]; objective "
            f"{kernel_obj:.9e} vs {obj:.9e}")
        check(abs(gap) <= lim, f"{label}: objective (kernel - {arm}) / |{arm}| {gap:+.3e}, "
              f"|.| <= {lim:g}")


def phase_slice(device):
    """Phase 15, the fifth main path, under the launch counters: mvtv_one
    at 1023^2 under the standalone C++ sibling's profile (B2, B6, B1 every
    iteration, unpadded), at 1024^2 with the one-kernel gate of a 96 MB TPU
    part (B2, B7 under the fused-dot PCG, B1; float32 and bf16
    preconditioner), at 4096 x 256 (B2, the spectral CG with a plain r0,
    B1), mvtv(folds=1, n_lambda=5) at 1023^2 under that profile, and
    mvtv_one at 316^2 under the Python prototype's profile (no kernel).
    Then, launches not counted: each Boyd fit against the exact-f32 route
    with the same configs, one-sided (LARGE_GAP); the 316^2 theta_inf fit
    two-sided against the exact route run for as many iterations; the
    1023^2 fit, which stops at the cap on both routes: its route runs
    FIXED_ITERS iterations from mvtv_one's state on the kernels, on their
    plain versions and on the exact route, held two-sided.  The path's fit
    at its chosen lambda (a cold solve) is held against the same cold solve
    on the plain versions (two-sided) and on the exact route (one-sided)."""
    import torch
    from multivartv_tpu_torch import mvtv
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.ops import kernels as K

    log("phase 15: the profiles' and x-update routes' fits on the card, counters reset")
    data = {label: SLICE[label][0]() for label in SLICE}
    routes = {label: slice_route(label, data[label], device) for label in SLICE}
    K.reset_launch_counts()
    fits = {}
    for label in SLICE:
        before = dict(K.launch_counts)
        res = slice_fit(label, data[label], device)
        used = {k: K.launch_counts[k] - before[k] for k in K.KERNELS
                if K.launch_counts[k] != before[k]}
        log(f"  {label} lam={res['lambda']:.6g}: mesh {res['m']}, route {routes[label]}, "
            f"{route_split(res)}, converged {res['diagnostics']['converged']}, "
            f"{res['seconds']:.2f} s [{GPU_LINE}], launches {used}")
        fits[label] = (res, used)
    x, y = data[SLICE_PATH]
    scfg, pcfg, mcfg = slice_configs(SLICE_PATH)
    before = dict(K.launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = mvtv(x, y, m=SLICE[SLICE_PATH][1], n_lambda=5, folds=1, solver_config=scfg,
                 path_config=pcfg, mesh_config=mcfg, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    used_path = {k: K.launch_counts[k] - before[k] for k in K.KERNELS
                 if K.launch_counts[k] != before[k]}
    launches = dict(K.launch_counts)
    log(f"  mvtv {SLICE_PATH} folds=1 n_lambda=5: {seconds:.2f} s [{GPU_LINE}], chosen index "
        f"{model.lambda_minmse_ind}, iterations per lambda "
        f"{[mm['iters'] for mm in model.models]}, launches {used_path}")
    log(f"  phase 15 launch counts: {launches}")

    for label, (res, used) in fits.items():
        d = res["diagnostics"]
        # The standalone C++ sibling caps its theta_inf solve at 2000
        # iterations (cpp-code/solvers.cpp); at 1023^2 and lambda = 0.05 both
        # routes stop there, so the cap counts as a stop for theta_inf fits.
        cfg = slice_configs(label)[0]
        capped = cfg.stop_rule == "theta_inf" and d["iterations"] == cfg.max_iters
        check(d["converged"] or capped, f"{label}: converged"
              + (f" or stopped at the profile's cap ({d['iterations']} iterations)"
                 if cfg.stop_rule == "theta_inf" else ""))
        check(bool(np.all(np.isfinite(res["theta_lattice"]))), f"{label}: theta finite")
        kind = SLICE[label][6]
        kernel_iters = d["iterations"] - d["exact_iterations"]
        check(d["chunked_iterations"] == 0, f"{label}: no fused chunk ({routes[label]})")
        if kind is None:
            check(not used, f"{label}: the no-kernel spectral route launched nothing ({used})")
            continue
        for k in ("rhs_2d", "dual_update_2d"):
            check(used.get(k, 0) == kernel_iters, f"{label}: {k} launched once per iteration "
                  f"({used.get(k, 0)} for {kernel_iters})")
        if kind == "dense":
            check(used.get("xupdate_pcg_2d", 0) == kernel_iters,
                  f"{label}: xupdate_pcg_2d launched once per iteration "
                  f"({used.get('xupdate_pcg_2d', 0)} for {kernel_iters})")
        elif kind == "fused":
            want = (1 + 3) * kernel_iters      # pcg_fused: x0's matvec and 3 steps
            check(used.get("gram_matvec_2d", 0) == want,
                  f"{label}: gram_matvec_2d launched 4 times per iteration "
                  f"({used.get('gram_matvec_2d', 0)} for {kernel_iters})")
        else:
            others = {k: v for k, v in used.items() if k not in ("rhs_2d", "dual_update_2d")}
            check(not others, f"{label}: no x-update kernel on the spectral x-update ({others})")
    for k in SLICE_KERNELS:
        check(launches[k] > 0, f"phase 15 launched {k} ({launches[k]} times)")
    check(used_path.get("xupdate_pcg_2d", 0) > 0, f"mvtv {SLICE_PATH} folds=1: "
          f"xupdate_pcg_2d launched ({used_path.get('xupdate_pcg_2d', 0)} times)")

    log("phase 15: the same fits on the exact-f32 route (use_kernels=False)")
    for label, (res, _) in fits.items():
        cfg, _, mcfg_l = slice_configs(label)
        if label == SLICE_PATH:
            continue
        if cfg.stop_rule == "theta_inf":
            n = res["diagnostics"]["iterations"]
            _, y_l, spec_l, _, _, ops_l, prob_l = _setup(*data[label], SLICE[label][1], None, cfg,
                                                         mcfg_l, device)
            lam = torch.tensor(SLICE[label][2], dtype=torch.float32, device=device)
            ref = solve_objective(ops_l, prob_l, spec_l, y_l, lam, lam,
                                  slice_configs(label, use_kernels=False)[0], n)
            check_route_arms(label, res["objective"], {"exact": (ref, FIXED_EXACT_GAP)})
            del ops_l, prob_l
            continue
        ref = slice_fit(label, data[label], device, use_kernels=False)
        gap = (res["objective"] - ref["objective"]) / abs(ref["objective"])
        log(f"  {label}: exact route {route_split(ref)}, {ref['seconds']:.2f} s; objective "
            f"{res['objective']:.9e} vs {ref['objective']:.9e}")
        check(gap <= LARGE_GAP, f"{label}: objective (kernel - exact) / |exact| {gap:+.3e} <= "
              f"{LARGE_GAP:g}")

    _, y_np, spec, _, _, ops, problem = _setup(x, y, SLICE[SLICE_PATH][1], None, scfg, mcfg,
                                               device)
    exact_cfg = slice_configs(SLICE_PATH, use_kernels=False)[0]
    label = f"{SLICE_PATH} after {FIXED_ITERS} iterations"
    lam = torch.tensor(SLICE[SLICE_PATH][2], dtype=torch.float32, device=device)
    args = (ops, problem, spec, y_np, lam, lam)
    obj, _, sec = solve_objective(*args, scfg, FIXED_ITERS)
    log(f"phase 15: {label} from mvtv_one's state, kernel route {sec:.2f} s [{GPU_LINE}]")
    with plain_versions():
        plain = solve_objective(*args, scfg, FIXED_ITERS)
    check_route_arms(label, obj, {"plain": (plain, PLAIN_GAP),
                                  "exact": (solve_objective(*args, exact_cfg, FIXED_ITERS),
                                            FIXED_EXACT_GAP)})

    best = model.lambda_minmse_ind
    check(abs(model.lambdas[-1] / model.lambdas[0] / 1e-5 - 1) < 1e-3,
          f"mvtv {SLICE_PATH} folds=1: the grid spans lambda_max to 1e-5 lambda_max")
    grid = torch.as_tensor(model.lambdas, device=device)
    label = (f"mvtv {SLICE_PATH} folds=1 at the chosen lambda {model.lambdas[best]:.6g} "
             f"(index {best}, a cold solve)")
    args = (ops, problem, spec, y_np, grid[best], grid[0] / 5.0)
    with plain_versions():
        plain = solve_objective(*args, scfg)
    obj = model_objective(model)
    check_route_arms(label, obj, {"plain": (plain, PLAIN_GAP)})
    ref, iters, sec = solve_objective(*args, exact_cfg)
    gap = obj / ref - 1
    log(f"  {label}, exact: {iters} iterations, {sec:.2f} s; objective {obj:.9e} vs {ref:.9e}")
    check(gap <= THETA_INF_GAP, f"{label}: objective (kernel - exact) / |exact| {gap:+.3e} "
          f"<= {THETA_INF_GAP:g}")
    check(bool(np.all(np.isfinite(model.theta_lattice)))
          and model.theta_lattice.shape == SLICE[SLICE_PATH][1],
          f"mvtv {SLICE_PATH} folds=1: theta finite, shape")
    del ops, problem
    torch.cuda.empty_cache()
    return launches


def dense_products_cublas(ops, b):
    """B6's 12 dense DCT products (three forward-inverse pairs) as bf16
    torch.matmul calls (cuBLAS) of the same shapes: a yardstick for the
    tensor-core product, never a path."""
    import torch
    t0, t1 = ops.dct_mats_lp
    v = b.to(torch.bfloat16)
    for _ in range(3):
        z = t0 @ v
        z = z @ t1.T
        z = t0.T @ z
        z = z @ t1
    return z


def kernel_share(run, match) -> tuple:
    """torch.profiler over run(): (device ms of the kernels whose name
    matches, device ms of all kernels); (0, 0) when the profiler saw no
    device time."""
    times = device_times(run)
    return (sum(us for us, _, key in times if match(key)) / 1e3,
            sum(us for us, _, _ in times) / 1e3)


def phase_timing_slice(device):
    """Phase 7's part for the slice: B6 at 1023^2 and 511 x 2047 and B7 at
    1024^2 beside their plain versions and bounds, B6's dense products
    beside the same 12 products on cuBLAS and their share of B6's device
    time (torch.profiler), and the 1023^2 whole-route iteration (B2, B6,
    B1) under the standalone C++ sibling's profile with its profile, and
    B1 and B2 at 1023^2 (time_call).  Returns {kernel: (ms, plain_ms, m)}
    at 1023^2 (B6, B1) and 1024^2 (B7)."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import admm

    times = {}
    for label in (SLICE_PATH, *SLICE_CHECKS, "1024^2 B7 f32 precond"):
        I = slice_inputs(label, device)
        ops, pr, s, cbar, m = I["ops"], I["problem"], I["s"], I["cbar"], I["m"]
        sc = ops.scales
        if m[0] % 2:
            b = K.rhs_2d_reference(s.alpha, s.u, pr.oty, s.rho, s.u_scale, sc)
            name = "xupdate_pcg_2d"
            args = (b, s.theta, pr.counts, ops.dct_mats_lp, ops.gram_eigs, s.rho, cbar, sc, 3)
            kern, plain = (lambda: K.xupdate_pcg_2d(*args)), (lambda: K.xupdate_pcg_2d_reference(
                *args))
        else:
            name = "gram_matvec_2d"
            kern = lambda: K.gram_matvec_2d(s.theta, pr.counts, s.rho, sc)
            plain = lambda: K.gram_matvec_2d_reference(s.theta, pr.counts, s.rho, sc)
        reps = 5 if name == "xupdate_pcg_2d" else 20
        p1, k1, k2, p2 = (cuda_time_ms(plain, reps), cuda_time_ms(kern, reps),
                          cuda_time_ms(kern, reps), cuda_time_ms(plain, reps))
        b_ms, b_by = bound(name, m)
        if label not in SLICE_CHECKS:
            times[name] = (min(k1, k2), min(p1, p2), m)
        log(f"  {name} {label}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}) [{GPU_LINE}]")
        if name == "xupdate_pcg_2d":
            n_calls = 5
            lib_ms = cuda_time_ms(lambda: dense_products_cublas(ops, b), 20)
            prod, busy = kernel_share(lambda: [kern() for _ in range(n_calls)],
                                      lambda key: "dense_mma_kernel" in key)
            if busy > 0:
                log(f"  xupdate_pcg_2d {label}: its 12 tensor-core DCT products "
                    f"{prod / n_calls:.4f} ms per call, {prod / busy:.3f} of its device time "
                    f"({busy / n_calls:.4f} ms per call, torch.profiler); the same 12 products "
                    f"as bf16 torch.matmul (cuBLAS, a yardstick) {lib_ms:.4f} ms: "
                    f"{prod / n_calls / lib_ms:.2f}x [{GPU_LINE}]")
            else:
                log(f"  xupdate_pcg_2d {label}: the profiler saw no device time; the 12 products "
                    f"as bf16 torch.matmul (cuBLAS, a yardstick) {lib_ms:.4f} ms [{GPU_LINE}]")
        if label == SLICE_PATH:
            # B1 and B2 where their launches are (the route's every
            # iteration); B1's row of the kernels line is this one.
            kappa = I["lam"] / s.rho
            dual = (s.theta, s.u, kappa, sc, s.u_scale)
            p1 = cuda_time_ms(lambda: K.dual_update_2d_reference(*dual), 10)
            k_ms = time_call("dual_update_2d", label, lambda: K.dual_update_2d(*dual), m)
            p2 = cuda_time_ms(lambda: K.dual_update_2d_reference(*dual), 10)
            times["dual_update_2d"] = (k_ms, min(p1, p2), m)
            log(f"  dual_update_2d {label}: plain {p1:.4f} / {p2:.4f} ms [{GPU_LINE}]")
            time_call("rhs_2d", label,
                      lambda: K.rhs_2d(s.alpha, s.u, pr.oty, s.rho, s.u_scale, sc), m)
            n_it = 10
            cfg, state0, lam = I["cfg"], I["state0"], I["lam"]

            def run():
                return admm.admm_fixed_iterations(ops, pr, lam, state0, cfg, n_it)

            ms = cuda_time_ms(run, 2, warmup=1) / n_it
            log(f"  {label} (whole route, B2 / B6 / B1): admm_fixed_iterations {ms:.3f} ms per "
                f"iteration = {1e3 / ms:.1f} iterations/s [{GPU_LINE}]")
            profile_iterations(label, run, n_it, ms)
        del I, s
        torch.cuda.empty_cache()
    return times


def phase_timing_cubes(device):
    """Phase 13: B12, B13 and B14 at 256^3 beside their plain versions and
    bounds, the tiled3 iteration's time and profile, B13 at 256 x 256 x 64
    (time_call there and at 256^3) and B12 at 128^3.
    Returns {kernel: (ms, plain_ms, m)} at 256^3."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import admm, xupdate

    log(f"phase 13: the p = 3 route's timing on {GPU_LINE} (CUDA events)")
    times = {}
    for name in ("256^3 n=2^22",):
        I = cube_inputs(name, device)
        ops, pr, s, lam, cfg, m = I["ops"], I["problem"], I["s"], I["lam"], I["cfg"], I["m"]
        sc = ops.scales
        kappa = lam / s.rho
        parts = (pr.oty, s.dta, s.u_scale, s.dtu)
        alpha = admm._refresh_alpha(ops, s, lam).alpha
        cases = {
            "dual_update_tiled_3d": (
                lambda: K.dual_update_tiled_3d(s.theta, s.u, kappa, sc, s.u_scale, None, True,
                                               False),
                lambda: K.dual_update_tiled_3d_reference(s.theta, s.u, kappa, sc, s.u_scale,
                                                         None, True, False)),
            "gram_residual_tiled_3d": (
                lambda: K.gram_residual_tiled_3d(None, s.theta, pr.counts, s.rho, sc,
                                                 rhs_parts=parts),
                lambda: K.gram_residual_tiled_3d_reference(None, s.theta, pr.counts, s.rho, sc,
                                                           rhs_parts=parts)),
            "rhs_tiled_3d": (
                lambda: K.rhs_tiled_3d(alpha, s.u, pr.oty, s.rho, s.u_scale, sc),
                lambda: K.rhs_tiled_3d_reference(alpha, s.u, pr.oty, s.rho, s.u_scale, sc)),
        }
        if I["route"] != "tiled3":
            del cases["rhs_tiled_3d"]
        for k, (kern, plain) in cases.items():
            p1, k1, k2, p2 = (cuda_time_ms(plain, 5), cuda_time_ms(kern, 20),
                              cuda_time_ms(kern, 20), cuda_time_ms(plain, 5))
            b_ms, b_by = bound(k, m)
            log(f"  {k} {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}) [{GPU_LINE}]")
            if name.startswith("256"):
                times[k] = (min(k1, k2), min(p1, p2), m)
        time_call("gram_residual_tiled_3d", name, cases["gram_residual_tiled_3d"][0], m)
        n_it = 20
        state0 = I["state0"]

        def run():
            return admm.admm_fixed_iterations(ops, pr, lam, state0, cfg, n_it)

        ms = cuda_time_ms(run, 2, warmup=1) / n_it
        log(f"  {name} ({I['route']} route, {xupdate.spectral_layout(ops)} layout, vectors "
            f"{xupdate.spectral_vec_dtype(ops, cfg) or torch.float32}): admm_fixed_iterations "
            f"{ms:.3f} ms per iteration = {1e3 / ms:.1f} iterations/s [{GPU_LINE}]")
        profile_iterations(name, run, n_it, ms)
        del I, s, state0, cases, alpha
        torch.cuda.empty_cache()
    # B13 on the C3 folds' lattice, where most of its launches are.
    I = cube_inputs(PATH3, device)
    pr, s, m = I["problem"], I["s"], I["m"]
    gram = (None, s.theta, pr.counts, s.rho, I["ops"].scales)
    parts = (pr.oty, s.dta, s.u_scale, s.dtu)
    p1 = cuda_time_ms(lambda: K.gram_residual_tiled_3d_reference(*gram, rhs_parts=parts), 5)
    time_call("gram_residual_tiled_3d", PATH3,
              lambda: K.gram_residual_tiled_3d(*gram, rhs_parts=parts), m)
    p2 = cuda_time_ms(lambda: K.gram_residual_tiled_3d_reference(*gram, rhs_parts=parts), 5)
    log(f"  gram_residual_tiled_3d {PATH3}: plain {p1:.4f} / {p2:.4f} ms [{GPU_LINE}]")
    del I, s, pr, gram, parts
    torch.cuda.empty_cache()
    # B12 alone at 128^3, on the warm state of that lattice's route (the
    # no-kernel spectral3 route: below 2^22 knots no path launches B12).
    name = "128^3 n=2^21"
    I = cube_inputs(name, device)
    s, sc, m = I["s"], I["ops"].scales, I["m"]
    kappa = I["lam"] / s.rho
    args = (s.theta, s.u, kappa, sc, s.u_scale, None, True, False)
    p1, k1, k2, p2 = (cuda_time_ms(lambda: K.dual_update_tiled_3d_reference(*args), 5),
                      cuda_time_ms(lambda: K.dual_update_tiled_3d(*args), 20),
                      cuda_time_ms(lambda: K.dual_update_tiled_3d(*args), 20),
                      cuda_time_ms(lambda: K.dual_update_tiled_3d_reference(*args), 5))
    b_ms, b_by = bound("dual_update_tiled_3d", m)
    log(f"  dual_update_tiled_3d {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
        f"{p2:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{GPU_LINE}]")
    del I, s, args
    torch.cuda.empty_cache()
    return times


# Phase 11's iteration cap per lambda (the default max_iters is 3000).
PATH_GAP_MAX_ITERS = 30_000


def phase_path_gap(device):
    """Phase 11, run only when asked for (--phases 11): the witness for
    phase 9's gate of mvtv(folds=1) at 2048^2 at the chosen lambda alone.
    The first three lambdas of its 5-lambda grid, where the tiled route's
    objective lies above the exact route's at tol = 1e-4, solved as a path
    on both routes at tol = 1e-4 and 1e-5.  If the two routes' objectives
    meet as the tolerance tightens, the gap is where Boyd's test stops each
    route, not a difference in what the routes solve."""
    import torch
    from multivartv_tpu_torch import SolverConfig, mvtv
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH, PathConfig
    from multivartv_tpu_torch.solver import path

    log(f"phase 11: mvtv(folds=1) at 2048^2, the first 3 lambdas of the 5-lambda grid, tol "
        f"1e-4 and 1e-5, tiled and exact routes [{GPU_LINE}]")
    x, y = LARGE["2048^2 n=2^22"][0]()
    _, _, _, _, _, ops, problem = _setup(x, y, None, None, SolverConfig(), DEFAULT_MESH, device)
    pcfg = PathConfig(n_lambda=5)
    grid = path.create_lambdas(path.lam_max(ops, problem, pcfg), pcfg)[:3].cpu().numpy()
    del ops, problem
    for tol in (1e-4, 1e-5):
        objs = {}
        for route, cfg in (("tiled", {}), ("exact", {"use_kernels": False})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = mvtv(x, y, lambdas=grid, folds=1, device=device,
                         solver_config=SolverConfig(tol=tol, max_iters=PATH_GAP_MAX_ITERS, **cfg))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            objs[route] = [model_objective(model, i) for i in range(len(grid))]
            iters = [int(mm["iters"]) for mm in model.models]
            check(all(np.isfinite(objs[route])), f"tol {tol:g} {route}: objectives finite")
            log(f"  tol {tol:g} {route} route: {seconds:.2f} s, iterations per lambda {iters} "
                f"(cap {PATH_GAP_MAX_ITERS}), objectives {[f'{v:.9e}' for v in objs[route]]}")
        gaps = [t / e - 1 for t, e in zip(objs["tiled"], objs["exact"])]
        log(f"  tol {tol:g}: objective (tiled - exact) / |exact| per lambda "
            f"{[f'{g:+.3e}' for g in gaps]}")


def phase_predict(fits, model):
    from multivartv_tpu_torch import predict_mvtv
    log("phase 6: predict_mvtv and MVTVModel.predict on 1e4 points")
    rng = np.random.RandomState(5)
    xq = rng.uniform(-1, 1, (10_000, 2))
    if fits:
        res = fits[0][5]
        pred = predict_mvtv(res, xq)
        check(pred.shape == (10_000,) and bool(np.all(np.isfinite(pred))),
              f"predict_mvtv(mvtv_one result): shape {pred.shape}, finite")
        same = predict_mvtv(res, res["data"])
        check(np.array_equal(same, res["fitted"]), "predict_mvtv(training data) == fitted")
    if model is not None:
        pred = model.predict(xq)
        check(pred.shape == (10_000,) and bool(np.all(np.isfinite(pred))),
              f"MVTVModel.predict: shape {pred.shape}, finite")
        check(np.array_equal(predict_mvtv(model, xq), pred), "predict_mvtv(model) == predict")
        check(np.array_equal(model.predict(model.data), model.fitted),
              "MVTVModel.predict(training data) == fitted")
        # The knot matrix as an explicit mesh: the brute-force nearest row is
        # the nearest knot, but the float32 |x|^2 - 2 x.m + |m|^2 form (the
        # JAX package's) cancels, so points close to a cell boundary may go
        # either way: 0.9994 of the points agree on the H100.
        agree = float(np.mean(model.predict(xq, mesh=model.mesh) == pred))
        check(agree >= 0.998, f"MVTVModel.predict(mesh=knots) agrees with the lattice lookup "
              f"on {agree:.5f} of the points (>= 0.998)")


def folded_products_cublas(ops, batch: int):
    """B3-B5's folded DCT products as bf16 torch.bmm (cuBLAS) of the same
    shapes, a yardstick never on a path: returns run(n_precond), which
    issues per preconditioner apply the four launches of the chain's
    product (forward axis 0 and 1, inverse axis 0 and 1), each one strided
    batched product over the pair of half products (even and odd) and the
    batch of problems, from contiguous operands made beforehand."""
    import torch
    (te0, to0), (te1, to1) = ops.dct_halves_lp
    m0, m1 = ops.m
    h0, h1 = m0 // 2, m1 // 2

    def pairs(a, b):
        return torch.stack([a, b]).expand(batch, 2, *a.shape).reshape(2 * batch, *a.shape)

    a0, a1 = pairs(te0, to0).contiguous(), pairs(te1, to1).contiguous()
    a0t, a1t = a0.transpose(1, 2).contiguous(), a1.transpose(1, 2).contiguous()
    x0 = torch.ones((2 * batch, h0, m1), dtype=torch.bfloat16, device=te0.device)
    x1 = torch.ones((2 * batch, m0, h1), dtype=torch.bfloat16, device=te0.device)

    def run(n_precond):
        for _ in range(n_precond):
            torch.bmm(a0, x0)
            torch.bmm(x1, a1t)
            torch.bmm(a0t, x0)
            torch.bmm(x1, a1)
    return run


# The kernels of B3's chain (csrc/xupdate.cu, dct_fold.cu, reduce.cu) and of
# B4/B5's persistent launch (csrc/chain.cu) by the share of a call they
# stand for.
def _chain_group(key: str) -> str:
    k = key.lower()
    if "admm_chain_kernel" in k:
        return "persistent chain (one launch)"
    if "fold_mma_kernel" in k:
        return "products"
    if "fold_in_kernel" in k or "pad_halves_kernel" in k:
        return "bf16 staging"
    if "finish_kernel" in k or "init_scalars" in k:
        return "finish passes"
    if "memcpy" in k or "memset" in k:
        return "copies"
    if any(t in k for t in ("residual_kernel", "gram_matvec_dot", "cg_update", "spectral_scale",
                            "dual_tile_kernel", "rho_adapt", "copy_blocks")):
        return "stencil, CG and dual stages"
    return "wrapper passes (eager)"


def profile_chain(label: str, run, n_calls: int, iters: int, wall_ms: float, lib,
                  barriers: int = 0) -> None:
    """torch.profiler over n_calls of run() (one B3, B4 or B5 call of
    `iters` ADMM iterations each, or 1 for B3): device ms per call by share
    of the chain, kernels per call and per iteration, grid barriers per
    iteration (`barriers` a call: B4/B5's persistent launch), the device's
    idle share against the CUDA-event time per call (wall_ms), and the
    products beside the same products on cuBLAS (lib(), one call's worth):
    their device time (torch.profiler) and their CUDA-event time, which
    adds PyTorch's host time per call.  B4/B5's products run inside the
    persistent kernel, which the profiler sees whole: their share is not
    measured there."""
    lib_ms = cuda_time_ms(lib, 20)
    lib_dev = sum(us for us, _, _ in device_times(lib)) / 1e3
    groups, launches = {}, 0
    for us, count, key in device_times(lambda: [run() for _ in range(n_calls)]):
        g = _chain_group(key)
        groups[g] = groups.get(g, 0.0) + us / 1e3 / n_calls
        launches += count
    busy = sum(groups.values())
    if busy <= 0:
        log(f"  {label}: the profiler saw no device time; products on cuBLAS {lib_ms:.4f} ms "
            f"per call [{GPU_LINE}]")
        return
    parts = ", ".join(f"{g} {v:.4f}" for g, v in sorted(groups.items(), key=lambda kv: -kv[1]))
    prod = groups.get("products", 0.0)
    ratio = f" ({prod / lib_dev:.2f}x)" if prod > 0 and lib_dev > 0 else ""
    lib_part = (f"device time {lib_dev:.4f} ms{ratio}" if lib_dev > 0
                else "device time not measured (the profiler saw none)")
    prod_part = (f"its products {prod:.4f} ms" if prod > 0 else
                 "its products inside the persistent kernel (not measured apart)")
    log(f"  {label} profile, device ms per call: {parts}; busy {busy:.4f} of {wall_ms:.4f} ms "
        f"wall, idle share {max(0.0, 1 - busy / wall_ms):.3f}; {launches / n_calls:.1f} kernels "
        f"per call, {launches / n_calls / iters:.1f} per iteration; {barriers / iters:.1f} grid "
        f"barriers per iteration; {prod_part} beside the same products as bf16 torch.bmm "
        f"(cuBLAS, a yardstick): {lib_part}, CUDA-event time {lib_ms:.4f} ms [{GPU_LINE}]")


def phase_timing(device):
    """Per-kernel and per-iteration times at 512^2, kernel beside plain."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch import SolverConfig
    from multivartv_tpu_torch.solver import admm

    log(f"phase 7: timing at 512^2 on {GPU_LINE} (CUDA events, after warm-up)")
    I = path_inputs("512^2 n=2^20", device)
    ops, sc = I["ops"], I["ops"].scales
    hv, eigs, cbar = ops.dct_halves_lp, ops.gram_eigs_packed, I["cbar"]
    rho, us, lam = I["rho"], I["u_scale"], I["lam"]
    kappa = lam / rho
    b = K.rhs_2d_reference(I["alpha"], I["u"], I["oty"], rho, us, sc)
    chain = (I["theta"], I["u"], I["alpha"], I["counts"], I["oty"], hv, eigs, lam, rho, us,
             cbar, sc)
    b4_scratch, b5_scratch = {}, {}   # each held across its calls, as one solve holds it
    cases = {
        "rhs_2d": (lambda: K.rhs_2d(I["alpha"], I["u"], I["oty"], rho, us, sc),
                   lambda: K.rhs_2d_reference(I["alpha"], I["u"], I["oty"], rho, us, sc)),
        "dual_update_2d": (lambda: K.dual_update_2d(I["theta"], I["u"], kappa, sc, us),
                           lambda: K.dual_update_2d_reference(I["theta"], I["u"], kappa, sc,
                                                              us)),
        "xupdate_pcg_2d_packed": (
            lambda: K.xupdate_pcg_2d_packed(b, I["theta"], I["counts"], hv, eigs, rho, cbar,
                                            sc, 3),
            lambda: K.xupdate_pcg_2d_packed_reference(b, I["theta"], I["counts"], hv, eigs,
                                                      rho, cbar, sc, 3)),
        "admm_iters_2d": (lambda: K.admm_iters_2d(*chain, k_iters=4, n_steps=3,
                                                  scratch=b4_scratch),
                          lambda: K.admm_iters_2d_reference(*chain, k_iters=4, n_steps=3)),
    }
    times = {}
    for name, (kern, plain) in cases.items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1 = cuda_time_ms(plain, 10)
        k1 = cuda_time_ms(kern, 20)
        k2 = cuda_time_ms(kern, 20)
        p2 = cuda_time_ms(plain, 10)
        times[name] = (min(k1, k2), min(p1, p2))
        log(f"  {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms "
            f"[{GPU_LINE}]")
    time_call("dual_update_2d", "512^2", cases["dual_update_2d"][0], ops.m)
    # Where a B3 and a B4 call spend their device time, their launches and
    # their products beside the same products on cuBLAS.
    for name, n_precond, iters in (("xupdate_pcg_2d_packed", 3, 1), ("admm_iters_2d", 12, 4)):
        lib = folded_products_cublas(ops, 1)
        profile_chain(f"{name} 512^2" + (" K=4" if iters > 1 else ""), cases[name][0], 5,
                      iters, times[name][0], lambda: lib(n_precond),
                      K.chain_barriers(iters, 3) if iters > 1 else 0)

    problem, s0 = I["problem"], I["state0"]
    cfg = SolverConfig()
    n_iters = 400

    def kernel_route():
        return admm.admm_fixed_iterations(ops, problem, lam, s0, cfg, n_iters)

    def plain_route():
        s = (s0.theta, s0.u, s0.alpha, s0.rho, s0.u_scale)
        for _ in range(n_iters // 4):
            th, u, a, r, usc, _ = K.admm_iters_2d_reference(
                s[0], s[1], s[2], problem.counts, problem.oty, hv, eigs, lam, s[3], s[4],
                cbar, sc, 4, 3)
            s = (th, u, a, r, usc)
        return s

    rates = {}
    for name, fn, reps in (("plain", plain_route, 1), ("kernel", kernel_route, 3),
                           ("kernel", kernel_route, 3), ("plain", plain_route, 1)):
        ms = cuda_time_ms(fn, reps, warmup=1)
        rates.setdefault(name, []).append(n_iters / (ms / 1e3))
    for name, r in rates.items():
        log(f"  admm_fixed_iterations 512^2 x {n_iters} ({name} route, chunk 4): "
            f"{r[0]:.1f} / {r[1]:.1f} iterations/s [{GPU_LINE}]")

    # Where mvtv_one's wall time at 316^2 goes: set-up (binning, operators;
    # a fit capped at 0 iterations) and the chunked iterations' rate; the
    # rest of a fit is its per-iteration or exact-f32 tail.
    x, y = WORKLOADS["316^2 n=1e5"][0]()
    setup = min(fit(x, y, None, 10.0, device, max_iters=0)["seconds"] for _ in range(3))
    J = path_inputs("316^2 n=1e5", device, warm_iters=0)
    ms = cuda_time_ms(lambda: admm.admm_fixed_iterations(J["ops"], J["problem"], J["lam"],
                                                         J["state0"], cfg, n_iters), 3,
                      warmup=1)
    log(f"  316^2 n=1e5: mvtv_one set-up {setup:.4f} s (max_iters=0); "
        f"admm_fixed_iterations x {n_iters} (kernel route, chunk 4) "
        f"{n_iters / (ms / 1e3):.1f} iterations/s [{GPU_LINE}]")

    # B5 on the five CV folds of the same problem, kernel beside plain, and
    # what one launch per stage for five folds buys: batched iterations/s
    # (each advances every fold) beside B4's single-problem rate, in turns.
    C = cv_inputs("316^2 n=1e5", device)
    folds = int(C["lams"].shape[0])
    pr, c_ops = C["problems"], C["ops"]
    b5_args = (pr.counts, pr.oty, c_ops.dct_halves_lp, c_ops.gram_eigs_packed, C["lams"],
               C["rho"], C["u_scale"], C["cbars"], c_ops.scales)
    th0, u0, a0 = C["theta"], C["u"], C["alpha"]

    def b5_kernel():
        # The kernel updates its state in place: start from copies each time
        # (the copies are part of both arms' times).
        return K.admm_iters_2d_batched(th0.clone(), tuple(w.clone() for w in u0),
                                       tuple(x.clone() for x in a0), *b5_args, k_iters=4,
                                       n_steps=3, scratch=b5_scratch)

    def b5_plain():
        return K.admm_iters_2d_batched_reference(th0.clone(), tuple(w.clone() for w in u0),
                                                 tuple(x.clone() for x in a0), *b5_args, 4, 3)

    p1, k1, k2, p2 = (cuda_time_ms(b5_plain, 5), cuda_time_ms(b5_kernel, 20),
                      cuda_time_ms(b5_kernel, 20), cuda_time_ms(b5_plain, 5))
    times["admm_iters_2d_batched"] = (min(k1, k2), min(p1, p2))
    log(f"  admm_iters_2d_batched 316^2 B={folds} K=4: kernel {k1:.4f} / {k2:.4f} ms, plain "
        f"{p1:.4f} / {p2:.4f} ms [{GPU_LINE}]")
    lib = folded_products_cublas(c_ops, folds)
    profile_chain(f"admm_iters_2d_batched 316^2 B={folds} K=4", b5_kernel, 5, 4,
                  min(k1, k2), lambda: lib(12), K.chain_barriers(4, 3))
    s0 = C["state0"]

    def batched_route():
        return admm.admm_fixed_iterations_batched(c_ops, pr, C["lams"], s0, cfg, n_iters)

    def single_route():
        return admm.admm_fixed_iterations(J["ops"], J["problem"], J["lam"], J["state0"], cfg,
                                          n_iters)

    brates = {}
    for name, fn in (("single", single_route), ("batched", batched_route),
                     ("batched", batched_route), ("single", single_route)):
        brates.setdefault(name, []).append(n_iters / (cuda_time_ms(fn, 2, warmup=1) / 1e3))
    (s1, s2), (b1, b2) = brates["single"], brates["batched"]
    log(f"  316^2 x {n_iters} iterations, chunk 4: admm_fixed_iterations (one problem) "
        f"{s1:.1f} / {s2:.1f} iterations/s; admm_fixed_iterations_batched ({folds} folds) "
        f"{b1:.1f} / {b2:.1f} batched iterations/s = {folds * b1:.1f} / {folds * b2:.1f} "
        f"fold-iterations/s [{GPU_LINE}]")
    return times, rates


def roofline():
    """The port's roofline module (multivartv_tpu_torch/utils/roofline.py):
    the published peaks of an H100 SXM at 700 W (device memory, the bytes
    bound's denominator; bf16 on the tensor cores, the operations bound of
    the DCT products), each kernel's work (kernel_work, SLAB_HALO_ROWS) and
    its bound, which the kernels line prints as bound_ms.  The streaming-
    copy probe's and copy_'s measured rates are printed beside the peaks as
    ceilings the card reached, not used as denominators."""
    from multivartv_tpu_torch.utils import roofline as rl
    return rl


def bound(name: str, m, **kw):
    """(bound_ms, bound_by) of one call of a kernel at lattice m
    (roofline.bound)."""
    return roofline().bound(name, m, **kw)


def copy_ceiling(device) -> float:
    """The device-memory rate the card reaches, in bytes/s: the
    streaming-copy probe (csrc/probe.cu, launched by no solver path) on
    512 MB, bytes read plus bytes written over its time, with torch's copy_
    of the same tensors timed beside it; both beside the published peak."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K
    src = torch.rand(128 << 20, device=device)
    dst = torch.zeros_like(src)
    K.stream_copy(src, dst)
    torch.cuda.synchronize()
    check(torch.equal(src, dst), "stream_copy probe: dst == src on 512 MB")
    nbytes = 2 * src.numel() * 4
    k1, lib, k2 = (cuda_time_ms(lambda: K.stream_copy(src, dst), 20, warmup=3),
                   cuda_time_ms(lambda: dst.copy_(src), 20, warmup=3),
                   cuda_time_ms(lambda: K.stream_copy(src, dst), 20, warmup=3))
    rate = nbytes / (min(k1, k2) / 1e3)
    log(f"  stream_copy probe, 512 MB: {k1:.4f} / {k2:.4f} ms = {rate / 1e9:.1f} GB/s read + "
        f"written; torch copy_ {lib:.4f} ms = {nbytes / lib / 1e6:.1f} GB/s; bytes bound "
        f"{nbytes / roofline().PEAK_HBM_BYTES * 1e3:.4f} ms at the published peak "
        f"{roofline().PEAK_HBM_BYTES / 1e9:.0f} GB/s (the bytes bound's denominator) "
        f"[{GPU_LINE}]")
    del src, dst
    torch.cuda.empty_cache()
    return rate


def _profile_group(key: str) -> str:
    k = key.lower()
    if "dual3_march_kernel" in k:
        return "B12 dual_update_tiled_3d"
    if "gram3_march_kernel" in k:
        return "B13 gram_residual_tiled_3d"
    if "lap3_matvec_kernel" in k:
        return "B13s's slab matvec (the Laplacian march)"
    if "fold_mma_kernel" in k:
        return "B3-B5 DCT products (dct_fold.cu)"
    if "fold_in_kernel" in k or "pad_halves_kernel" in k:
        return "B3-B5 bf16 operand staging (dct_fold.cu)"
    if "dense_mma_kernel" in k:
        return "B6 DCT products (dct_mma.cu)"
    if "pad_bf16_kernel" in k:
        return "B6 bf16 operand staging (dct_mma.cu)"
    if any(t in k for t in ("residual_kernel", "rhs_kernel", "gram_matvec_dot", "cg_update",
                            "spectral_scale")):
        return "B2 and the B3/B6 CG stages"
    head = k.split("(")[0]      # the kernel's name and template arguments
    if "gram_dot_knot_kernel" in head or "gram_march_kernel<3" in head:
        return "B7 gram_matvec_2d"
    if "dual_tile_kernel" in head and head.endswith("true>"):
        return "B8s dual_update_tiled_2d_shard"
    if "dual_tile_kernel<true" in head:
        return "B1 dual_update_2d"
    if "dual_tile_kernel" in head:
        return "B8 dual_update_tiled_2d"
    if "gram_march_kernel" in head and ", true," in head:    # <MODE, kSlab, kVec>
        return "B9s gram_residual_tiled_2d_shard and its matvec mode"
    if "gram_march_kernel<0" in head:
        return "B10 gram_matvec_tiled_2d"
    if "gram_march_kernel" in head:
        return "B9 gram_residual_tiled_2d"
    if "nccl" in k:
        return "NCCL collectives"
    if "at::" not in head and any(t in head for t in ("segment_kernel<", "reduce_kernel<",
                                                        "recover_kernel<")):
        return "T1 xupdate_tridiag (whole chain or segment mode)"
    if "finish_kernel(float const*, int, int" in k:
        return "partition_finish"
    if "finish_kernel" in k or "init_scalars" in k:
        return "B8/B12 scalars and finish pass"
    if any(t in k for t in ("gemm", "sm90_", "xmma", "cutlass", "cublas")):
        return "torch.matmul transforms"
    if "fft" in k:
        return "FFT"
    if "memcpy" in k or "memset" in k:
        return "copies"
    return "eager elementwise and reduction passes"


def device_times(run, tries: int = 3) -> list:
    """torch.profiler over run(): (device us, calls, name) per kernel, or []
    when no trace saw device time.  Each trace runs run() once as a warm-up
    step, whose events are dropped, and once more as its one recorded step:
    late in a process that has profiled often, a trace can miss launches,
    or all of them, so a trace that saw no device time is taken again, up
    to `tries` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _step in range(2):
                run()
                torch.cuda.synchronize()
                prof.step()
        times = [(float(getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0.0) or 0.0), e.count, e.key)
                 for e in prof.key_averages()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")
                 and not e.key.startswith("ProfilerStep")]  # the step's span, not a kernel
        if sum(us for us, _, _ in times) > 0:
            return times
    return []


def profile_iterations(label: str, run, n_iters: int, wall_ms: float) -> None:
    """torch.profiler over run() (n_iters ADMM iterations): device time per
    iteration by kernel group, and the device's idle share against the
    CUDA-event wall time per iteration (wall_ms)."""
    groups, top = {}, []
    for us, count, key in device_times(run):
        g = _profile_group(key)
        groups[g] = groups.get(g, 0.0) + us
        top.append((us, count, key[:90]))
    busy = sum(groups.values()) / 1e3 / n_iters
    if busy <= 0:
        log(f"  {label}: the profiler saw no device time (CUDA-event wall {wall_ms:.3f} ms per "
            "iteration)")
        return
    parts = ", ".join(f"{g} {v / 1e3 / n_iters:.3f}" for g, v in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
    log(f"  {label} profile, ms per iteration: {parts}; device busy {busy:.3f} of "
        f"{wall_ms:.3f} ms wall, idle share {max(0.0, 1 - busy / wall_ms):.3f} [{GPU_LINE}]")
    for us, count, key in sorted(top, reverse=True)[:8]:
        log(f"    {us / 1e3 / n_iters:.4f} ms/it  x{count / n_iters:g}/it  {key}")


def digest(out) -> str:
    """A short sha256 of a call's outputs (tensors, nested tuples, None)."""
    import torch
    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                feed(y)
        elif isinstance(x, torch.Tensor):
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
        else:
            h.update(repr(x).encode())
    feed(out)
    return h.hexdigest()[:16]


def time_call(name: str, label: str, run, m, n: int = 20, **kw) -> float:
    """One kernel call at its launch size: CUDA-event ms per call (two runs
    of n), torch.profiler device ms and kernels per call, and host us per
    call (the enqueue of n calls on an idle device, no synchronize inside);
    printed beside the bound.  Returns the smaller CUDA-event time."""
    import torch
    k1, k2 = cuda_time_ms(run, n), cuda_time_ms(run, n)
    times = device_times(lambda: [run() for _ in range(n)])
    dev = sum(us for us, _, _ in times) / 1e3 / n
    kpc = sum(count for _, count, _ in times) / n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    b_ms, b_by = bound(name, m, **kw)
    log(f"  {name} {label}: {k1:.4f} / {k2:.4f} ms per call (CUDA events), device "
        f"{dev:.4f} ms in {kpc:.1f} kernels per call (torch.profiler), host {host_us:.1f} us "
        f"per call, bound {b_ms:.4f} ms ({b_by}) [{GPU_LINE}]")
    return min(k1, k2)


def launch_bits(device):
    """Digests of the dual stage's and the Gram kernels' outputs (B1, B8,
    B8s, B4, B5 with their dual stage, B9, B10, B9s), of B2 (512^2, 1023^2),
    of B7's A v and dot apart (1024^2: the row march; 1023^2 and 511 x
    2047: the thread-per-knot kernel; its dot beside the plain version's,
    rtol 1e-5) and of B6 (1023^2) on inputs drawn from a seeded generator on
    the card, the DCT operators of the 512^2, 316^2 and 1023^2 fits (the
    warm states of the main paths differ from run to run: O'y is summed
    with atomics).  Phase 19 run from two trees in one call shows by them
    whether the trees give the same bits."""
    import torch
    from multivartv_tpu_torch.api import _resolve_mesh
    from multivartv_tpu_torch.config import DEFAULT_MESH, SolverConfig
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver.problem import build_operators

    gen = torch.Generator(device=device).manual_seed(10)

    def lat(*m, scale=1.0):
        return torch.randn(m, device=device, generator=gen) * scale

    def scalar(x, n=None):
        return torch.full(() if n is None else (n,), x, dtype=torch.float32, device=device)

    def bits(label, out):
        torch.cuda.synchronize()
        log(f"  bits {label}: {digest(out)}")

    sc = (0.37, 0.81, 1.3)
    kappa, us, rho = scalar(0.05), scalar(0.7), scalar(0.4)
    for m in ((512, 512), (1023, 1023), (511, 2047)):
        th, u = lat(*m), tuple(lat(*m) for _ in range(3))
        bits(f"dual_update_2d {m}", K.dual_update_2d(th, u, kappa, sc, us))
        bits(f"dual_update_2d {m} true_m", K.dual_update_2d(th, u, kappa, sc, us,
                                                           (m[0] - 1, m[1] - 1)))
    for m in ((512, 512), (1023, 1023)):
        a, u, oty = tuple(lat(*m) for _ in range(3)), tuple(lat(*m) for _ in range(3)), lat(*m)
        bits(f"rhs_2d {m}", K.rhs_2d(a, u, oty, rho, us, sc))
        bits(f"rhs_2d {m} u_scale None", K.rhs_2d(a, u, oty, rho, None, sc))
    for m in ((1024, 1024), (1023, 1023), (511, 2047)):
        v, c = lat(*m), lat(*m).abs()
        av, dot = K.gram_matvec_2d(v, c, rho, sc)
        bits(f"gram_matvec_2d {m} A v", av)
        bits(f"gram_matvec_2d {m} dot", dot)
        _, dot_r = K.gram_matvec_2d_reference(v, c, rho, sc)
        check(torch.allclose(dot.double(), dot_r.double(), rtol=1e-5, atol=0),
              f"gram_matvec_2d {m}: dot {float(dot):.9e} vs the plain version's "
              f"{float(dot_r):.9e} (rtol 1e-5)")
    del a, u, oty, v, c, av, dot, dot_r
    m = (2048, 2048)
    th, u = lat(*m), tuple(lat(*m) for _ in range(3))
    zero = torch.zeros(8, m[1], device=device)
    for flags in ((True, False), (False, True)):
        bits(f"dual_update_tiled_2d {m} want_adjoints={flags[0]}",
             K.dual_update_tiled_2d(th, u, kappa, sc, us, None, *flags))
        bits(f"dual_update_tiled_2d_shard {m} one-rank slab want_adjoints={flags[0]}",
             K.dual_update_tiled_2d_shard(th, u, [zero] * 4, [zero] * 4, 0, m[0], kappa, sc, us,
                                          None, *flags))
    v, c, b = lat(*m), lat(*m).abs(), lat(*m)
    parts = (b, lat(*m), us, lat(*m))
    bits(f"gram_residual_tiled_2d {m} b given", K.gram_residual_tiled_2d(b, v, c, rho, sc))
    bits(f"gram_residual_tiled_2d {m} fused",
         K.gram_residual_tiled_2d(None, v, c, rho, sc, rhs_parts=parts))
    bits(f"gram_matvec_tiled_2d {m}", K.gram_matvec_tiled_2d(v, c, rho, sc))
    bits(f"gram_residual_tiled_2d_shard {m} one-rank slab b given",
         K.gram_residual_tiled_2d_shard(b, v, zero, zero, 0, m[0], c, rho, sc))
    bits(f"gram_matvec_tiled_2d_shard {m} one-rank slab",
         K.gram_matvec_tiled_2d_shard(v, zero, zero, 0, m[0], c, rho, sc))
    del th, u, v, c, b, parts, zero
    ops = build_operators((1023, 1023), (2.0 / 1022, 2.0 / 1022), SolverConfig(), device)
    m = ops.m
    b, x0, counts = lat(*m), lat(*m, scale=0.1), lat(*m).abs().round()
    bits(f"xupdate_pcg_2d {m} n_steps=3",
         K.xupdate_pcg_2d(b, x0, counts, ops.dct_mats_lp, ops.gram_eigs, rho,
                          scalar(float(counts.mean())), ops.scales, 3))
    del ops, b, x0, counts
    for name, batch in (("512^2 n=2^20", 1), ("316^2 n=1e5", 5)):
        make, mm, _ = WORKLOADS[name]
        spec = _resolve_mesh(make()[0], mm, DEFAULT_MESH, device)
        ops = build_operators(spec.m, spec.deltas, SolverConfig(), device)
        m, lead = ops.m, (batch,) if batch > 1 else ()
        st = (lat(*lead, *m), *(lat(*lead, *m, scale=0.1) for _ in range(6)))
        counts, oty = lat(*m).abs().round(), lat(*m)
        sc2, halves, eigs = ops.scales, ops.dct_halves_lp, ops.gram_eigs_packed
        cbar = float(counts.mean())
        if batch == 1:
            out = K.admm_iters_2d(st[0], st[1:4], st[4:7], counts, oty, halves, eigs,
                                  scalar(0.05), rho, us, scalar(cbar), sc2, k_iters=4, n_steps=3)
            bits(f"admm_iters_2d {m} K=4", out)
        else:
            out = K.admm_iters_2d_batched(
                st[0], st[1:4], st[4:7], counts, oty, halves, eigs, scalar(0.05, batch),
                scalar(0.4, batch), scalar(0.7, batch), scalar(cbar, batch), sc2, k_iters=4,
                n_steps=3)
            bits(f"admm_iters_2d_batched {m} B={batch} K=4", out)
        del st, counts, oty, out, ops


def phase_launch_sizes(device):
    """Phase 19 (only when listed): the redesigned kernels and their neighbours
    at the sizes where the main paths launch them, with time_call's four
    numbers each: B1 at 512^2 and 1023^2, B2 at 512^2 and 1023^2, B7 at
    1024^2 (its fits' lattice; the row march) and 1023^2 (rows not 16-byte
    aligned: the thread-per-knot kernel), B4 at 512^2 (K = 4), B5 at 316^2 (B = 5, K =
    4, the state's copies included, as in phase 7), B8 at 2048^2, B8s
    (carries) on the 2048^2 one-rank slab and on one of SHARD_SLABS slabs,
    B9s (b given and fused) on the 2048^2 one-rank slab, B9 (fused) and B10
    at 2048^2 and 192 x 8192, B9s's matvec mode on the one-rank 1024^2
    slab, B11s on a 512-row slab of 2048^2, B13 (fused) at 256^3 and 256
    x 256 x 64 and T1 at T1_LAUNCH.  It calls only the wrappers' Python
    entry points, whose arguments stay fixed, so the same file, copied into
    an older checkout's root, times that tree's kernels in the same call
    (parent, change, change, parent)."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import admm

    log(f"phase 19: kernels at their launch sizes on {GPU_LINE}")
    launch_bits(device)
    I = path_inputs("512^2 n=2^20", device)
    sc, m, us = I["ops"].scales, I["m"], I["u_scale"]
    kappa = I["lam"] / I["rho"]
    time_call("dual_update_2d", "512^2", lambda: K.dual_update_2d(I["theta"], I["u"], kappa,
                                                                  sc, us), m)
    time_call("rhs_2d", "512^2", lambda: K.rhs_2d(I["alpha"], I["u"], I["oty"], I["rho"], us,
                                                  sc), m)
    ops = I["ops"]
    chain = (I["theta"], I["u"], I["alpha"], I["counts"], I["oty"], ops.dct_halves_lp,
             ops.gram_eigs_packed, I["lam"], I["rho"], us, I["cbar"], sc)
    scratch = {}
    time_call("admm_iters_2d", "512^2 K=4",
              lambda: K.admm_iters_2d(*chain, k_iters=4, n_steps=3, scratch=scratch), m)
    del I, chain, scratch
    C = cv_inputs("316^2 n=1e5", device)
    pr, c_ops = C["problems"], C["ops"]
    b5 = (pr.counts, pr.oty, c_ops.dct_halves_lp, c_ops.gram_eigs_packed, C["lams"], C["rho"],
          C["u_scale"], C["cbars"], c_ops.scales)
    scratch = {}
    time_call("admm_iters_2d_batched", "316^2 B=5 K=4",
              lambda: K.admm_iters_2d_batched(
                  C["theta"].clone(), tuple(w.clone() for w in C["u"]),
                  tuple(x.clone() for x in C["alpha"]), *b5, k_iters=4, n_steps=3,
                  scratch=scratch), C["m"], batch=5)
    del C, b5, scratch
    I = slice_inputs(SLICE_PATH, device)
    pr, s, sc, m = I["problem"], I["s"], I["ops"].scales, I["m"]
    kappa = I["lam"] / s.rho
    time_call("dual_update_2d", "1023^2", lambda: K.dual_update_2d(s.theta, s.u, kappa, sc,
                                                                   s.u_scale), m)
    time_call("rhs_2d", "1023^2", lambda: K.rhs_2d(s.alpha, s.u, pr.oty, s.rho, s.u_scale, sc),
              m)
    time_call("gram_matvec_2d", "1023^2 (thread per knot)",
              lambda: K.gram_matvec_2d(s.theta, pr.counts, s.rho, sc), m)
    del I, s, pr
    I = slice_inputs("1024^2 B7 f32 precond", device)
    pr, s = I["problem"], I["s"]
    time_call("gram_matvec_2d", "1024^2",
              lambda: K.gram_matvec_2d(s.theta, pr.counts, s.rho, I["ops"].scales), I["m"])
    del I, s, pr
    I = tiled_inputs("2048^2 n=2^22", device)
    s, sc = I["s"], I["ops"].scales
    kappa = I["lam"] / s.rho
    time_call("dual_update_tiled_2d", "2048^2",
              lambda: K.dual_update_tiled_2d(s.theta, s.u, kappa, sc, s.u_scale, None, True,
                                             False), I["m"])
    pr, m = I["problem"], I["m"]
    for slabs in (1, SHARD_SLABS):
        r = 1 if slabs > 1 else 0
        lo, hi = r * m[0] // slabs, (r + 1) * m[0] // slabs
        tops, bots = slab_halos((s.theta, *s.u), lo, hi)
        dual = (s.theta[lo:hi], tuple(w[lo:hi] for w in s.u), tops, bots, lo, m[0], kappa, sc,
                s.u_scale, None, True, False)
        time_call("dual_update_tiled_2d_shard", f"{hi - lo}x{m[1]} slab {r} of 2048^2",
                  lambda: K.dual_update_tiled_2d_shard(*dual), (hi - lo, m[1]))
    (vt,), (vb,) = slab_halos((s.theta,), 0, m[0])
    b = pr.oty + s.rho * (s.dta + s.u_scale * s.dtu)
    time_call("gram_residual_tiled_2d_shard", "2048^2 one-rank slab, b given",
              lambda: K.gram_residual_tiled_2d_shard(b, s.theta, vt, vb, 0, m[0], pr.counts,
                                                     s.rho, sc), m)
    parts = (pr.oty, s.dta, s.u_scale, s.dtu)
    time_call("gram_residual_tiled_2d_shard", "2048^2 one-rank slab, fused",
              lambda: K.gram_residual_tiled_2d_shard(None, s.theta, vt, vb, 0, m[0], pr.counts,
                                                     s.rho, sc, rhs_parts=parts), m, fused=True)
    alpha = admm._refresh_alpha(I["ops"], s, I["lam"]).alpha
    lo, hi = m[0] // SHARD_SLABS, 2 * m[0] // SHARD_SLABS
    atops, abots = slab_halos((*alpha, *s.u), lo, hi)
    rhs = (tuple(a[lo:hi] for a in alpha), tuple(w[lo:hi] for w in s.u), atops, abots, lo,
           pr.oty[lo:hi], s.rho, s.u_scale, sc)
    time_call("rhs_tiled_2d_shard", f"{hi - lo}x{m[1]} slab 1 of 2048^2",
              lambda: K.rhs_tiled_2d_shard(*rhs), (hi - lo, m[1]))
    del alpha, atops, abots, rhs
    del I, s, pr, b, parts, dual, tops, bots
    for name in TIMED_LARGE:
        I = tiled_inputs(name, device)
        pr, s, sc, m = I["problem"], I["s"], I["ops"].scales, I["m"]
        parts = (pr.oty, s.dta, s.u_scale, s.dtu)
        time_call("gram_residual_tiled_2d", f"{name.split()[0]} fused",
                  lambda: K.gram_residual_tiled_2d(None, s.theta, pr.counts, s.rho, sc,
                                                   rhs_parts=parts), m)
        time_call("gram_matvec_tiled_2d", name.split()[0],
                  lambda: K.gram_matvec_tiled_2d(s.theta, pr.counts, s.rho, sc), m)
        del I, s, pr, parts
    saved = admm.WHOLE_MAX_KNOTS
    admm.WHOLE_MAX_KNOTS = SHARD_HALF[1][0] * SHARD_HALF[1][1] // 2
    try:
        I = tiled_inputs("2048^2 n=2^22", device, workload=SHARD_HALF)
    finally:
        admm.WHOLE_MAX_KNOTS = saved
    s, m = I["s"], I["m"]
    (top,), (bot,) = slab_halos((s.theta,), 0, m[0])
    mv = (s.theta, top, bot, 0, m[0], I["problem"].counts, s.rho, I["ops"].scales)
    time_call("gram_matvec_tiled_2d_shard", "1024^2 one-rank slab",
              lambda: K.gram_matvec_tiled_2d_shard(*mv), m)
    del I, s, mv
    torch.cuda.empty_cache()
    for name in ("256^3 n=2^22", PATH3):
        I = cube_inputs(name, device)
        pr, s = I["problem"], I["s"]
        parts = (pr.oty, s.dta, s.u_scale, s.dtu)
        time_call("gram_residual_tiled_3d", name.split()[0],
                  lambda: K.gram_residual_tiled_3d(None, s.theta, pr.counts, s.rho,
                                                   I["ops"].scales, rhs_parts=parts), I["m"])
        del I, s, pr, parts
        torch.cuda.empty_cache()
    t1_launch_sizes(device)


# T1 at its launch sizes in phase 19: the default p = 1 mesh at n = 1e5, the
# fused lasso's mvtv (N = 1e5) and mvtv_one (N = 2^20).
T1_LAUNCH = (316, 100_000, 1 << 20)


def t1_launch_sizes(device):
    """T1 at T1_LAUNCH with time_call's four numbers, and the digest of its
    output on seeded inputs (the same from run to run of one tree)."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K
    for n in T1_LAUNCH:
        counts, b = tridiag_inputs(n, 7, device)
        rho = torch.tensor(0.5, dtype=torch.float32, device=device)
        log(f"  xupdate_tridiag n={n}: digest {digest(K.xupdate_tridiag(counts, b, rho, 1.0))}")
        time_call("xupdate_tridiag", f"n={n}", lambda: K.xupdate_tridiag(counts, b, rho, 1.0),
                  (n,), n=50)


# The LARGE lattices phase 10 times: the sizes of the tiled kernels' first
# fits on the path (B8, B9 at 2048^2; B10 at 192 x 8192).  4096^2 (PR 3's
# rows in PERF.md) is left out of the default run for time.
TIMED_LARGE = ("2048^2 n=2^22", "192x8192 n=2^21")


def phase_timing_large(device):
    """Phase 10: B8, B9 and B10 beside their plain versions and their bounds
    on each TIMED_LARGE lattice, the tiled route's time per iteration, and
    its profile.  Returns {kernel: (ms, plain_ms, m)} at 2048^2 (B8, B9) and
    192 x 8192 (B10)."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import admm, xupdate

    log(f"phase 10: the large-lattice route's timing on {GPU_LINE} (CUDA events)")
    times = {}
    for name in TIMED_LARGE:
        I = tiled_inputs(name, device)
        ops, pr, s, lam, cfg = I["ops"], I["problem"], I["s"], I["lam"], I["cfg"]
        sc, m = ops.scales, I["m"]
        kappa = lam / s.rho
        parts = (pr.oty, s.dta, s.u_scale, s.dtu)
        cases = {
            "dual_update_tiled_2d": (
                lambda: K.dual_update_tiled_2d(s.theta, s.u, kappa, sc, s.u_scale, None, True,
                                               False),
                lambda: K.dual_update_tiled_2d_reference(s.theta, s.u, kappa, sc, s.u_scale,
                                                         None, True, False)),
            "gram_residual_tiled_2d": (
                lambda: K.gram_residual_tiled_2d(None, s.theta, pr.counts, s.rho, sc,
                                                 rhs_parts=parts),
                lambda: K.gram_residual_tiled_2d_reference(None, s.theta, pr.counts, s.rho, sc,
                                                           rhs_parts=parts)),
            "gram_matvec_tiled_2d": (
                lambda: K.gram_matvec_tiled_2d(s.theta, pr.counts, s.rho, sc),
                lambda: K.gram_matvec_tiled_2d_reference(s.theta, pr.counts, s.rho, sc)),
        }
        if name.startswith("2048"):
            alpha = admm._refresh_alpha(ops, s, lam).alpha
            cases["rhs_tiled_2d"] = (
                lambda: K.rhs_tiled_2d(alpha, s.u, pr.oty, s.rho, s.u_scale, sc),
                lambda: K.rhs_2d_reference(alpha, s.u, pr.oty, s.rho, s.u_scale, sc))
        for k, (kern, plain) in cases.items():
            p1, k1, k2, p2 = (cuda_time_ms(plain, 5), cuda_time_ms(kern, 20),
                              cuda_time_ms(kern, 20), cuda_time_ms(plain, 5))
            b_ms, b_by = bound(k, m)
            log(f"  {k} {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}) [{GPU_LINE}]")
            first = "192x" in name if k == "gram_matvec_tiled_2d" else name.startswith("2048")
            if first:
                times[k] = (min(k1, k2), min(p1, p2), m)
        n_it = 20
        state0 = I["state0"]

        def run():
            return admm.admm_fixed_iterations(ops, pr, lam, state0, cfg, n_it)

        ms = cuda_time_ms(run, 2, warmup=1) / n_it
        log(f"  {name} ({xupdate.spectral_layout(ops)} layout, vectors "
            f"{xupdate.spectral_vec_dtype(ops, cfg) or torch.float32}): admm_fixed_iterations "
            f"{ms:.3f} ms per iteration = {1e3 / ms:.1f} iterations/s [{GPU_LINE}]")
        profile_iterations(name, run, n_it, ms)
        del I, s, state0, cases
        torch.cuda.empty_cache()
    return times


# ---------------------------------------------------------------------------
# The sharded path (parallel/): the row-slab kernels and mvtv_sharded
# ---------------------------------------------------------------------------

SHARD_SLABS = 4
SHARD_ELEMENT_TOL = 1e-6    # of max|x|: slabs together against the whole-lattice kernel
SHARD_STATS_TOL = 1e-5      # relative: the Boyd sums, summed in another order
SHARD = ("dual_update_tiled_2d_shard", "gram_residual_tiled_2d_shard",
         "gram_matvec_tiled_2d_shard")
# Phase 16's fits: (m, n) of bench.py's data for mvtv_sharded with folds = 1
# and 2 (SHARD_FIT3 below), and the repaired routes' mvtv_one fits (label,
# m, data).
SHARD_FIT1 = ((2048, 2048), 1 << 22)
SHARD_FIT2 = ((1024, 1024), 1 << 20)
# The 2048^2 fit's grid: 3 lambdas (5 until its x-update became the spectral
# CG across ranks, which took the 5-lambda fit from ~34 s to 69 s on an
# H100), to keep the default run inside its time.
SHARD_FIT1_LAMBDAS = 3
# 3 lambdas (the 5-lambda grid's indices 0, 2, 4), not 5, to keep the
# default run inside its time.  This fit keeps the exact arm
# (xla_packed=False), the shard route's x-update before its spectral arm
# came: under the spectral CG across ranks it took 156 s on an H100
# (PERF.md section 6), and the default arm is the 2048^2 fit's and
# shard_arms'.
SHARD_FIT2_LAMBDAS = 3
# The default arm's folds = 2 fit at p = 2: 512^2 on bench.py's data, 2
# lambdas, against the single card's tie set as the 1024^2 fit, every solve
# of both capped at SHARD_FIT3_CAP: its iteration is host-bound (~45 ms on
# an H100, as at 2048^2), and uncapped lambda_max takes 748 iterations (the
# fit 69 s; 59 s at a cap of 300, 26-32 s at 100).  Cap 50 keeps the
# default run well inside its time.
SHARD_FIT3 = ((512, 512), 1 << 20)
SHARD_FIT3_LAMBDAS = 2
SHARD_FIT3_CAP = 50
# The folds = 2 fit's lattice as a tiled_inputs workload for the slab check.
SHARD_HALF = (lambda: bench_data(1 << 20), (1024, 1024), 0.05)
# compare_shard's cuts, each a tuple of slab row counts from the top: on
# 2048^2 SHARD_SLABS even slabs, np.array_split's 3 uneven ones (683, 683,
# 682) and the one-rank slab; on 1024^2 the one-rank slab and 5-row slabs
# at row_off 1014 (both halos real) and 1019 (the global edge below).
SHARD_CUTS = ((tuple(len(a) for a in np.array_split(np.arange(2048), SHARD_SLABS)),
               tuple(len(a) for a in np.array_split(np.arange(2048), 3)), (2048,)),
              ((1024,), (1014, 5, 5)))
# The 2048^2 state's first SHARD_NARROW columns, a lattice of its own whose
# rows are not 16-byte aligned: the row march's 4-byte path, cut as the
# 3 uneven slabs.
SHARD_NARROW = 2046
REPAIRED = (("16384x256 n=2^22 (C1)", (16384, 256), lambda: bench_data(1 << 22)),
            ("16^4 n=2^18 (C2)", (16, 16, 16, 16), lambda: quad_data(1 << 18)))
# The shard route's x-update arms (phases 16 and 23): ARMS on the slab of a
# group of one, SHARD_ARM_ITERS iterations an arm from one warm state, and
# a SHARD_ARM_PROFILE-iteration run under the profiler for the idle share.
SHARD_ARM_ITERS = 30
SHARD_ARM_PROFILE = 3
# The one-rank spectral x-update against the single card's on the same
# warm state, of max|x - x0|: on a group of one no collective runs and the
# transforms take the single card's bf16 operands in its axis order, so the
# two are equal (bit for bit at 2048^2 and 256^3 on an H100); the 1e-2 of
# tests/test_torch_spectral.py holds only across ranks.
SHARD_XUPDATE_TOL = 1e-6
# Phase 16's C7 fits (lattices the shard route refused before): mvtv_sharded
# at 16^4 (p = 4, folds 1; the packed spectral CG on plain stages) beside the
# single-card fit of REPAIRED, at its lambda (0.05), against the exact
# route's cold solve there; and with the reduced block set at 2048^2 (folds
# 1; plain stages, the quartered spectral CG) against the single card's
# spectral2 route (the same algorithm) at the chosen lambda, both capped at
# SHARD_REDUCED_CAP.
SHARD_P4 = ((16, 16, 16, 16), 1 << 18, (0.05,))
SHARD_REDUCED_LAMBDAS = 3
SHARD_REDUCED_CAP = 40
# The 16^4 fit on the grid a user gets, SHARD_P4_GRID lambdas from
# lambda_max (shard_p4_grid), every solve capped at SHARD_P4_CAP, beside two
# witnesses on the same grid and cap: the single card's mvtv (its spectralN
# route, the same spectral CG) and the shard route's exact arm
# (xla_packed=False).  Near lambda_max every route runs to the cap (at the
# default 3,000 the exact arm too); at the last lambda the spectral CG, on
# one card as on the shard route, stops ~1.8e-3 above the exact route's
# cold solve (scripts/shard_grid_witness.py; PERF.md section 7), at a cap
# of 100 as at 3,000.  So at the chosen lambda the exact arm is held to the
# cold solve (one-sided, LARGE_GAP) and the default arm to the single
# card's, one-sided by SHARD_P4_STOP_GAP: two stops of one bf16 CG, which
# on an H100 fell +1.7e-5 apart (the CPU's -2.5e-5 at a cap of 3,000), so
# twice that; a stop of another algorithm lies ~1.8e-3 away.  The default
# arm's gap to the cold solve is printed.
SHARD_P4_GRID = 3
SHARD_P4_CAP = 100
SHARD_P4_STOP_GAP = 5e-5


def rel_max(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def slab_halos(xs, lo: int, hi: int, depth: int = 8):
    """(tops, bots): up to depth rows above and below the row slab lo .. hi
    - 1 of each lattice of xs, cut from the neighbouring rows, zeros at the
    global edges (the JAX package's 8-row halo arrays)."""
    import torch
    tops, bots = [], []
    for x in xs:
        z = torch.zeros((depth, x.shape[1]), dtype=x.dtype, device=x.device)
        tops.append(x[max(lo - depth, 0):lo].contiguous() if lo > 0 else z)
        bots.append(x[hi:hi + depth].contiguous() if hi < x.shape[0] else z)
    return tops, bots


def compare_shard(device, errs):
    """B8s (both compiled flag pairs, and with true_m = m - 1), B9s (fused
    and b given), its matvec mode and B11s on row slabs of the warm 2048^2
    state (bench.py's data, tiled_inputs) and of the warm 1024^2 state of
    the folds = 2 fit's data (SHARD_HALF), cut as SHARD_CUTS says, and on
    the 2048^2 state's first SHARD_NARROW columns, each slab with its halos
    cut from its neighbours.  The slabs together against B8,
    B9, B10 and B2's kernel on the same lattice (SHARD_ELEMENT_TOL of
    max|x|, the Boyd sums SHARD_STATS_TOL relative), each slab against its
    plain version (1e-5 x max(1, |ref|)), and on the one-rank slab (the
    main path's: the whole lattice, row_off 0, both halos zero) B8s against
    B8 bit for bit, the five sums included; records the largest absolute
    errors against the plain versions in errs."""
    import torch
    from multivartv_tpu_torch.solver import admm

    saved = admm.WHOLE_MAX_KNOTS
    for workload, cuts in zip((None, SHARD_HALF), SHARD_CUTS):
        if workload is not None:      # 1024^2: the whole-lattice gate lowered for the build
            admm.WHOLE_MAX_KNOTS = workload[1][0] * workload[1][1] // 2
        try:
            I = tiled_inputs("2048^2 n=2^22", device, workload=workload)
        finally:
            admm.WHOLE_MAX_KNOTS = saved
        ops, pr, s, lam, m = I["ops"], I["problem"], I["s"], I["lam"], I["m"]
        lat = dict(theta=s.theta, u=s.u, oty=pr.oty, dta=s.dta, dtu=s.dtu, counts=pr.counts,
                   alpha=admm._refresh_alpha(ops, s, lam).alpha)
        scal = (ops.scales, lam / s.rho, s.rho, s.u_scale)
        for rows in cuts:
            compare_slabs(f"{m[0]}x{m[1]} in row slabs {rows}", lat, scal, rows, errs)
        if workload is None:
            def narrow(x):
                return x[:, :SHARD_NARROW].contiguous()
            lat_n = {k: tuple(map(narrow, x)) if isinstance(x, tuple) else narrow(x)
                     for k, x in lat.items()}
            compare_slabs(f"{m[0]}x{SHARD_NARROW} in row slabs {cuts[1]}", lat_n, scal, cuts[1],
                          errs)
            del lat_n
        del I, s, lat
    torch.cuda.empty_cache()


def compare_slabs(tag, lat, scal, rows, errs):
    """compare_shard's checks on one lattice (lat: theta, u, oty, dta, dtu,
    counts, alpha; scal: scales, kappa, rho, u_scale) cut into row slabs of
    `rows` rows each, from the top."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K

    theta, u, oty, dta, dtu, counts, alpha = (lat[k] for k in (
        "theta", "u", "oty", "dta", "dtu", "counts", "alpha"))
    sc, kappa, rho, u_scale = scal
    m = tuple(theta.shape)
    assert sum(rows) == m[0]
    bounds = np.cumsum((0,) + tuple(rows)).tolist()
    slabs = list(zip(bounds[:-1], bounds[1:]))

    def cut(x, r):
        return x[slabs[r][0]:slabs[r][1]]

    def note(kernel, got, ref):
        e = max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref))
        errs[kernel] = max(errs.get(kernel, 0.0), e)
        return max(rel_err(g, r) for g, r in zip(got, ref))

    def against_whole(label, got_slabs, whole):
        e = max(rel_max(torch.cat(g), w) for g, w in zip(zip(*got_slabs), whole))
        check(e <= SHARD_ELEMENT_TOL, f"{label} {tag}: slabs together vs the whole-lattice "
              f"kernel, max err {e:.3e} <= {SHARD_ELEMENT_TOL:g} x max|x|")

    for tm, (want_adj, want_alpha) in ((None, (True, False)), (None, (False, True)),
                                       ((m[0] - 1, m[1] - 1), (True, False))):
        whole = K.dual_update_tiled_2d(theta, u, kappa, sc, u_scale, tm, want_adj, want_alpha)
        lat_w = (*(whole[0] or ()), *whole[1], *whole[3:])
        got, stats, worst = [], 0.0, 0.0
        for r, (lo, hi) in enumerate(slabs):
            tops, bots = slab_halos((theta, *u), lo, hi)
            args = (cut(theta, r), tuple(cut(w, r) for w in u), tops, bots, lo, m[0],
                    kappa, sc, u_scale, tm, want_adj, want_alpha)
            k_out = K.dual_update_tiled_2d_shard(*args)
            p_out = K.dual_update_tiled_2d_shard_reference(*args)
            torch.cuda.synchronize()
            lat_k = (*(k_out[0] or ()), *k_out[1], *k_out[3:])
            lat_p = (*(p_out[0] or ()), *p_out[1], *p_out[3:])
            worst = max(worst, note("dual_update_tiled_2d_shard", lat_k, lat_p))
            check(torch.allclose(k_out[2].double(), p_out[2].double(), rtol=1e-4, atol=0),
                  f"dual_update_tiled_2d_shard {tag} slab {r} true_m={tm}: stats vs plain "
                  "(rtol 1e-4)")
            got.append(lat_k)
            stats = stats + k_out[2].double()
        label = f"dual_update_tiled_2d_shard true_m={tm} want_adjoints={want_adj}"
        check(worst <= 1e-5, f"{label} {tag}: each slab vs its plain version, max err "
              f"{worst:.3e} <= 1e-5 x max(1, |ref|)")
        against_whole(label, got, lat_w)
        e = float(((stats - whole[2].double()).abs() / whole[2].double().abs()).max())
        check(e <= SHARD_STATS_TOL, f"{label} {tag}: the slabs' Boyd sums vs the whole "
              f"lattice's, rel {e:.3e} <= {SHARD_STATS_TOL:g}")
        if len(slabs) == 1:
            same = all(torch.equal(g, w) for g, w in zip(got[0], lat_w))
            check(same and torch.equal(k_out[2], whole[2]), f"{label} {tag}: the one-rank "
                  "slab equals B8 bit for bit (every array and the five sums)")

    parts = (oty, dta, u_scale, dtu)
    b = oty + rho * (dta + u_scale * dtu)
    for label, bb, rp in (("fused rhs", None, parts), ("b given", b, None)):
        whole = K.gram_residual_tiled_2d(bb, theta, counts, rho, sc, rhs_parts=rp)
        got, worst = [], 0.0
        for r, (lo, hi) in enumerate(slabs):
            (top,), (bot,) = slab_halos((theta,), lo, hi)
            rp_r = None if rp is None else (cut(oty, r), cut(dta, r), u_scale, cut(dtu, r))
            args = (None if bb is None else cut(bb, r), cut(theta, r), top, bot, lo, m[0],
                    cut(counts, r), rho, sc)
            k_out = K.gram_residual_tiled_2d_shard(*args, rhs_parts=rp_r)
            p_out = K.gram_residual_tiled_2d_shard_reference(*args, rhs_parts=rp_r)
            torch.cuda.synchronize()
            worst = max(worst, note("gram_residual_tiled_2d_shard", [k_out], [p_out]))
            got.append((k_out,))
        check(worst <= 1e-5, f"gram_residual_tiled_2d_shard ({label}) {tag}: each slab vs its "
              f"plain version, max err {worst:.3e} <= 1e-5 x max(1, |ref|)")
        against_whole(f"gram_residual_tiled_2d_shard ({label})", got, (whole,))

    whole = K.gram_matvec_tiled_2d(theta, counts, rho, sc)
    got, worst = [], 0.0
    for r, (lo, hi) in enumerate(slabs):
        (top,), (bot,) = slab_halos((theta,), lo, hi)
        args = (cut(theta, r), top, bot, lo, m[0], cut(counts, r), rho, sc)
        k_out = K.gram_matvec_tiled_2d_shard(*args)
        p_out = K.gram_matvec_tiled_2d_shard_reference(*args)
        torch.cuda.synchronize()
        worst = max(worst, note("gram_matvec_tiled_2d_shard", [k_out], [p_out]))
        got.append((k_out,))
    check(worst <= 1e-5, f"gram_matvec_tiled_2d_shard {tag}: each slab vs its plain version, "
          f"max err {worst:.3e} <= 1e-5 x max(1, |ref|)")
    against_whole("gram_matvec_tiled_2d_shard", got, (whole,))

    whole = K.rhs_tiled_2d(alpha, u, oty, rho, u_scale, sc)
    got, worst = [], 0.0
    for r, (lo, hi) in enumerate(slabs):
        tops, bots = slab_halos((*alpha, *u), lo, hi)
        args = (tuple(cut(a, r) for a in alpha), tuple(cut(w, r) for w in u), tops, bots,
                lo, cut(oty, r), rho, u_scale, sc)
        k_out = K.rhs_tiled_2d_shard(*args)
        p_out = K.rhs_tiled_2d_shard_reference(*args)
        torch.cuda.synchronize()
        worst = max(worst, note("rhs_tiled_2d_shard", [k_out], [p_out]))
        got.append((k_out,))
    check(worst <= 1e-5, f"rhs_tiled_2d_shard {tag}: each slab vs its plain version, max err "
          f"{worst:.3e} <= 1e-5 x max(1, |ref|)")
    against_whole("rhs_tiled_2d_shard", got, (whole,))


def probe_dual_struct(device, errs, timed, n: int = 4096):
    """B8's structure probe (csrc/probe.cu) at 4096^2: copies (4 lattices in,
    8 out) and the prox (4 in, 5 out, B8's own counts), each against its
    plain version; its GB/s (bytes read plus written over its time) beside
    stream_copy's on 64 MB lattices, the same call.  Records the prox
    variant in timed."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K

    gen = torch.Generator(device=device).manual_seed(5)
    ins = [torch.randn(n, n, device=device, generator=gen) for _ in range(4)]
    dst = torch.empty_like(ins[0])
    copy_ms = cuda_time_ms(lambda: K.stream_copy(ins[0], dst), 20, warmup=3)
    log(f"  stream_copy 4096^2 (64 MB): {copy_ms:.4f} ms = "
        f"{2 * n * n * 4 / copy_ms / 1e6:.1f} GB/s, bytes bound "
        f"{2 * n * n * 4 / roofline().PEAK_HBM_BYTES * 1e3:.4f} ms [{GPU_LINE}]")
    for prox, n_out in ((False, 8), (True, 5)):
        outs, st = K.dual_struct(ins, n_out, prox)
        ref, rst = K.dual_struct_reference(ins, n_out, prox)
        torch.cuda.synchronize()
        e = max(float((o - r).abs().max()) for o, r in zip(outs, ref))
        errs["dual_struct"] = max(errs.get("dual_struct", 0.0), e)
        check(e <= 1e-6, f"dual_struct prox={prox} 4096^2: outputs vs plain, max err {e:.3e}")
        if prox:
            check(abs(float(st) / float(rst) - 1) <= 1e-5,
                  f"dual_struct prox 4096^2: sum of d0^2 {float(st):.7g} vs {float(rst):.7g}")
        k1, p1 = (cuda_time_ms(lambda: K.dual_struct(ins, n_out, prox), 20, warmup=3),
                  cuda_time_ms(lambda: K.dual_struct_reference(ins, n_out, prox), 5))
        nbytes = (4 + n_out) * n * n * 4
        log(f"  dual_struct 4096^2, 4 in, {n_out} out, {'prox' if prox else 'copies'}: "
            f"{k1:.4f} ms = {nbytes / k1 / 1e6:.1f} GB/s (plain {p1:.4f} ms); stream_copy "
            f"{2 * n * n * 4 / copy_ms / 1e6:.1f} GB/s [{GPU_LINE}]")
        if prox:
            timed["dual_struct"] = (k1, p1, (n, n), {"n_in": 4, "n_out": n_out})
    del ins, dst
    torch.cuda.empty_cache()


def quad_data(n: int, seed: int = 0):
    """The 16^4 fit's data: x ~ U(-1, 1)^4, y = sin(2 x0) cos(x1) + x2 x3
    + N(0, 0.3^2)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 4))
    return x, np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + x[:, 2] * x[:, 3] + 0.3 * rng.randn(n)


def phase_sharded(device):
    """Phase 16, the sixth main path, under the launch counters: the sharded
    fit on one card, a row group of one rank over NCCL (a file:// rendezvous
    under a temporary directory; one card holds one NCCL rank):
    mvtv_sharded(folds=1, n_lambda=3) at 2048^2 (bench.py's data, n = 2^22),
    its objective at the chosen lambda no worse than the exact-f32 route's
    cold solve from the same start by LARGE_GAP; mvtv_sharded(folds=2,
    n_lambda=3) at 1024^2 (n = 2^20), its chosen index in the tie set of
    the single-card mvtv(folds=2, vmap_folds=False) on the same grid
    (the 2048^2 fit on the default x-update, the spectral CG across ranks,
    the 1024^2 one on the exact arm, xla_packed=False); the same at 512^2
    (folds=2, n_lambda=2) on the default arm; the
    C7 fits (shard_c7_fits: 16^4 and the reduced block set at 2048^2, the
    lattices the shard route refused before, on plain stages; shard_p4_grid:
    16^4 on the grid from lambda_max beside its two witnesses); and the
    shard route's three x-update arms at 2048^2 (shard_arms: ms, CG steps,
    launches, idle share), under the counters; then xla_packed=False
    against the exact route and the default arm against the exact arm
    (check_shard_arms) and the one-rank spectral x-update against the
    single card's (check_shard_xupdate).  Then the two repaired routes: the
    C1 fit mvtv_one at 16384 x 256 (no folded halves: B8 and the plain PCG
    with B10) and a 16^4 fit (p = 4, no kernel), each against the exact-f32
    route (one-sided LARGE_GAP).  Returns the launch counts."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist
    from multivartv_tpu_torch import CVConfig, SolverConfig, mvtv
    from multivartv_tpu_torch.api import _fresh_solve, _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.parallel import distributed
    from multivartv_tpu_torch.parallel import fit as pfit
    from multivartv_tpu_torch.parallel.sharding import make_device_mesh
    from multivartv_tpu_torch.solver import admm

    log("phase 16: the sharded path on one card (a row group of one NCCL rank), counters reset")
    (mA, nA), (mB, nB), (mC, nC) = SHARD_FIT1, SHARD_FIT2, SHARD_FIT3
    lA, lB, lC = (f"mvtv_sharded {m[0]}x{m[1]}" for m in (mA, mB, mC))
    x2, y2 = bench_data(nA)
    x1, y1 = bench_data(nB)
    x5, y5 = bench_data(nC)
    with tempfile.TemporaryDirectory() as tmp:
        distributed.init_distributed(f"file://{tmp}/store", world_size=1, rank=0, device=device)
        try:
            one = torch.ones(4, device=device)
            dist.all_reduce(one)
            torch.cuda.synchronize()
            check(bool(torch.all(one == 1)), f"NCCL process group up on the card: "
                  f"{distributed.process_summary()}, all_reduce over one rank")
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m2048 = pfit.mvtv_sharded(x2, y2, m=mA, folds=1, n_lambda=SHARD_FIT1_LAMBDAS,
                                      device=device)
            torch.cuda.synchronize()
            s2048 = time.perf_counter() - t0
            used = dict(K.launch_counts)
            t0 = time.perf_counter()
            m1024 = pfit.mvtv_sharded(x1, y1, m=mB, folds=2, n_lambda=SHARD_FIT2_LAMBDAS,
                                      solver_config=SolverConfig(xla_packed=False),
                                      device=device)
            torch.cuda.synchronize()
            s1024 = time.perf_counter() - t0
            t0 = time.perf_counter()
            m512 = pfit.mvtv_sharded(x5, y5, m=mC, folds=2, n_lambda=SHARD_FIT3_LAMBDAS,
                                     solver_config=SolverConfig(max_iters=SHARD_FIT3_CAP),
                                     device=device)
            torch.cuda.synchronize()
            s512 = time.perf_counter() - t0
            c7 = shard_c7_fits(x2, y2, mA, device)
            p4_grid = shard_p4_grid(device)
            group = make_device_mesh()
            arms, (ops_s, pr_s, scfg, spec_s, warm) = shard_arms(
                f"{lA} shard route", x2, y2, mA, 0.05, device, group, SHARD)
            launches = dict(K.launch_counts)
            check_shard_arms(lA, ops_s, pr_s, scfg, spec_s, warm, y2, 0.05, arms)
            # A group of one's slab is the lattice: its operators without
            # the slab are the single card's set-up, warm from the arms.
            check_shard_xupdate(f"{mA[0]}x{mA[1]}", dict(
                ops=dataclasses.replace(ops_s, slab=None), problem=pr_s, s=warm), group)
            del ops_s, pr_s, warm, arms
        finally:
            dist.destroy_process_group()
    shard_used = {k: launches[k] for k in K.KERNELS if launches[k]}
    log(f"  {lA} folds=1 n_lambda={SHARD_FIT1_LAMBDAS}: {s2048:.2f} s [{GPU_LINE}], chosen index "
        f"{m2048.lambda_minmse_ind}, iterations per lambda "
        f"{[mm['iters'] for mm in m2048.models]}, launches "
        f"{ {k: v for k, v in used.items() if v} }")
    log(f"  {lB} folds=2 n_lambda={SHARD_FIT2_LAMBDAS} (xla_packed=False): {s1024:.2f} s "
        f"[{GPU_LINE}], chosen index "
        f"{m1024.lambda_minmse_ind}, CV curve {[float(f'{v:.8g}') for v in m1024.cv_mses]}")
    log(f"  {lC} folds=2 n_lambda={SHARD_FIT3_LAMBDAS} (the default arm, cap {SHARD_FIT3_CAP}): "
        f"{s512:.2f} s [{GPU_LINE}], chosen index {m512.lambda_minmse_ind}, iterations per "
        f"lambda {[mm['iters'] for mm in m512.models]}, CV curve "
        f"{[float(f'{v:.8g}') for v in m512.cv_mses]}")
    log(f"  sharded-path launch counts: {shard_used}")
    for k in SHARD:
        check(launches[k] > 0, f"the sharded path launched {k} ({launches[k]} times)")
    check(launches["rhs_tiled_2d_shard"] == 0, "the sharded path rides the dta/dtu carries: "
          "rhs_tiled_2d_shard launched 0 times, as B11 on the tiled route")

    for label, model in ((lA, m2048), (lB, m1024), (lC, m512)):
        check(bool(np.all(np.isfinite(model.theta_lattice))), f"{label}: theta finite")
    check_lambda_max64(lA, float(m2048.lambdas[0]), x2, y2, m2048.mesh_spec)
    # The reference: the exact-f32 route's cold solve at the chosen lambda
    # from the same start (rho0 = lambda_0 / 5, mbs_fit_optimal), so that
    # Boyd's absolute test stops the two from one point.
    best = m2048.lambda_minmse_ind
    t0 = time.perf_counter()
    exact = SolverConfig(use_kernels=False)
    _, _, spec, _, _, ops, problem = _setup(x2, y2, mA, None, exact, DEFAULT_MESH, device)
    grid = torch.as_tensor(m2048.lambdas, device=device)
    theta, fitted = _fresh_solve(ops, problem, grid[best], grid[0] / 5.0, exact)
    ref_obj = objective64({"theta_lattice": theta.cpu().numpy(), "fitted": fitted.cpu().numpy(),
                           "y": y2, "mesh_spec": spec, "lambda": float(grid[best])})
    obj = model_objective(m2048)
    gap = (obj - ref_obj) / abs(ref_obj)
    log(f"  {lA} at the chosen lambda {float(m2048.lambdas[best]):.6g}: objective "
        f"{obj:.9e} vs the exact route's cold solve {ref_obj:.9e} "
        f"({time.perf_counter() - t0:.2f} s)")
    check(gap <= LARGE_GAP, f"{lA}: objective at the chosen lambda (shard - "
          f"exact) / |exact| {gap:+.3e} <= {LARGE_GAP:g}")
    check_c7_fits(c7, x2, y2, mA, device)
    check_p4_grid(p4_grid, device)

    for label, model, x, y, m, cap in ((lB, m1024, x1, y1, mB, None),
                                       (lC, m512, x5, y5, mC, SHARD_FIT3_CAP)):
        t0 = time.perf_counter()
        cfg = SolverConfig() if cap is None else SolverConfig(max_iters=cap)
        single = mvtv(x, y, m=m, lambdas=model.lambdas, folds=2, device=device,
                      solver_config=cfg, cv_config=CVConfig(folds=2, vmap_folds=False))
        torch.cuda.synchronize()
        cv = np.asarray(single.cv_mses, np.float64)
        ties = np.nonzero(cv <= cv.min() * (1 + MVTV_TIE))[0].tolist()
        log(f"  single-card mvtv {m[0]}x{m[1]} folds=2 (vmap_folds=False, cap {cfg.max_iters}), "
            f"same grid: {time.perf_counter() - t0:.2f} s, chosen index "
            f"{single.lambda_minmse_ind}, tie set {ties}, CV curve "
            f"{[float(f'{v:.8g}') for v in single.cv_mses]}")
        check(model.lambda_minmse_ind in ties, f"{label} folds=2: chosen index "
              f"{model.lambda_minmse_ind} in the single-card fit's tie set {ties} (CV MSE "
              f"within {MVTV_TIE:g} of its minimum)")

    log("phase 16: the repaired routes (C1: no folded halves above 8192 per axis; C2: p = 4)")
    for label, m, make in REPAIRED:
        x, y = make()
        before = dict(K.launch_counts)
        res = fit(x, y, m, 0.05, device)
        used = {k: K.launch_counts[k] - before[k] for k in K.KERNELS
                if K.launch_counts[k] != before[k]}
        ref = fit(x, y, m, 0.05, device, use_kernels=False)
        gap = (res["objective"] - ref["objective"]) / abs(ref["objective"])
        log(f"  {label}: route {admm.lattice_route(m)}, {route_split(res)}, converged "
            f"{res['diagnostics']['converged']}, {res['seconds']:.2f} s, launches {used}; exact "
            f"route {route_split(ref)}, {ref['seconds']:.2f} s; objective "
            f"{res['objective']:.9e} vs {ref['objective']:.9e} [{GPU_LINE}]")
        check(res["diagnostics"]["converged"], f"{label}: converged")
        check(gap <= LARGE_GAP, f"{label}: objective (kernel route - exact) / |exact| "
              f"{gap:+.3e} <= {LARGE_GAP:g}")
        if len(m) == 2:
            check(used.get("dual_update_tiled_2d", 0) > 0
                  and used.get("gram_matvec_tiled_2d", 0) > 0,
                  f"{label}: B8 and B10 (the plain PCG's matvec) launched")
    return launches


def shard_c7_fits(x2, y2, m2, device) -> dict:
    """Phase 16's C7 fits on the row group of one (see SHARD_P4): {label:
    (model, seconds, launches, x, y, m, config)}."""
    import torch
    from multivartv_tpu_torch import SolverConfig
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.parallel import fit as pfit

    m4, n4, lams4 = SHARD_P4
    x4, y4 = quad_data(n4)
    runs = (("16^4 n=2^18 (C7, p = 4)", x4, y4, m4, dict(lambdas=lams4), SolverConfig()),
            (f"{m2[0]}x{m2[1]} reduced block set (C7)", x2, y2, m2,
             dict(n_lambda=SHARD_REDUCED_LAMBDAS),
             SolverConfig(include_full_mixed=False, max_iters=SHARD_REDUCED_CAP)))
    out = {}
    for label, x, y, m, grid, cfg in runs:
        before = dict(K.launch_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = pfit.mvtv_sharded(x, y, m=m, folds=1, solver_config=cfg, device=device, **grid)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        used = {k: K.launch_counts[k] - before[k] for k in K.KERNELS
                if K.launch_counts[k] != before[k]}
        log(f"  mvtv_sharded {label} folds=1 lambdas {[float(f'{v:.6g}') for v in model.lambdas]} "
            f"(cap {cfg.max_iters}): {seconds:.2f} s [{GPU_LINE}], chosen index "
            f"{model.lambda_minmse_ind}, iterations per lambda "
            f"{[mm['iters'] for mm in model.models]}, launches {used}")
        out[label] = (model, seconds, used, x, y, m, cfg)
    return out


def shard_p4_grid(device) -> dict:
    """Phase 16's 16^4 fit on the grid from lambda_max (see SHARD_P4_GRID):
    {name: (model, seconds)} for the shard route's default arm ("shard"),
    the single card's mvtv ("single") and the shard route's exact arm
    ("exact"), each on the same grid and cap."""
    import torch
    from multivartv_tpu_torch import SolverConfig, mvtv
    from multivartv_tpu_torch.parallel import fit as pfit

    m4, n4, _ = SHARD_P4
    x4, y4 = quad_data(n4)
    cfg = SolverConfig(max_iters=SHARD_P4_CAP)
    fits = {"shard": lambda: pfit.mvtv_sharded(x4, y4, m=m4, folds=1, n_lambda=SHARD_P4_GRID,
                                               solver_config=cfg, device=device),
            "single": lambda: mvtv(x4, y4, m=m4, folds=1, n_lambda=SHARD_P4_GRID,
                                   solver_config=cfg, device=device),
            "exact": lambda: pfit.mvtv_sharded(
                x4, y4, m=m4, folds=1, n_lambda=SHARD_P4_GRID, device=device,
                solver_config=SolverConfig(max_iters=SHARD_P4_CAP, xla_packed=False))}
    out = {}
    for name, run in fits.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = run()
        torch.cuda.synchronize()
        out[name] = (model, time.perf_counter() - t0)
    return out


def check_p4_grid(grid, device):
    """shard_p4_grid's fits: one grid on all three; at the chosen lambda (the
    single card's too) the default arm's objective no worse than the single
    card's spectralN route's by SHARD_P4_STOP_GAP (near lambda_max both stop
    at the cap mid-way: printed), the exact arm's no worse than the exact
    route's cold solve there (rho0 = lambda_0 / 5, uncapped) by LARGE_GAP;
    the default arm's gap to the cold solve printed."""
    import torch
    from multivartv_tpu_torch import SolverConfig
    from multivartv_tpu_torch.api import _fresh_solve, _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH

    m4, n4, _ = SHARD_P4
    x4, y4 = quad_data(n4)
    label = f"16^4 n=2^18 (C7, p = 4) on the {SHARD_P4_GRID}-lambda grid from lambda_max"
    objs = {}
    for name, (model, seconds) in grid.items():
        objs[name] = [model_objective(model, i) for i in range(len(model.lambdas))]
        log(f"  {label}, {name} (cap {SHARD_P4_CAP}): lambdas "
            f"{[float(f'{v:.6g}') for v in model.lambdas]}, iterations per lambda "
            f"{[mm['iters'] for mm in model.models]}, chosen index {model.lambda_minmse_ind}, "
            f"objectives {[f'{v:.9e}' for v in objs[name]]}, {seconds:.2f} s [{GPU_LINE}]")
        check(bool(np.all(np.isfinite(model.theta_lattice))), f"{label}, {name}: theta finite")
    shard, exact = grid["shard"][0], grid["exact"][0]
    check(all(np.allclose(grid[k][0].lambdas, shard.lambdas, rtol=1e-6, atol=0)
              for k in grid), f"{label}: one grid on the three fits")
    gaps = [a / b - 1 for a, b in zip(objs["shard"], objs["single"])]
    best = shard.lambda_minmse_ind
    log(f"  {label}: the default arm's objective / the single card's - 1 per lambda "
        f"{[f'{g:+.2e}' for g in gaps]} (at the cap near lambda_max both stop mid-way)")
    check(best == grid["single"][0].lambda_minmse_ind and gaps[best] <= SHARD_P4_STOP_GAP,
          f"{label}: the shard route's default arm against the single card's spectralN route "
          f"at the chosen lambda (index {best} on both): {gaps[best]:+.3e} <= "
          f"{SHARD_P4_STOP_GAP:g}")
    cfg = SolverConfig(use_kernels=False)
    _, _, spec, _, _, ops, problem = _setup(x4, y4, m4, None, cfg, DEFAULT_MESH, device)
    lams = torch.as_tensor(exact.lambdas, device=device)
    best = exact.lambda_minmse_ind
    theta, fitted = _fresh_solve(ops, problem, lams[best], lams[0] / 5.0, cfg)
    ref = objective64({"theta_lattice": theta.cpu().numpy(), "fitted": fitted.cpu().numpy(),
                       "y": y4, "mesh_spec": spec, "lambda": float(lams[best])})
    gap = objs["exact"][best] / ref - 1
    log(f"  {label}: at the chosen lambda {float(lams[best]):.6g} the exact route's cold solve "
        f"{ref:.9e}; the default arm (shard - exact) / |exact| "
        f"{objs['shard'][best] / ref - 1:+.3e} and the single card's "
        f"{objs['single'][best] / ref - 1:+.3e}, printed: the spectral CG's stop (PERF.md "
        f"section 7)")
    check(gap <= LARGE_GAP, f"{label}: the shard route's exact arm at the chosen lambda (shard "
          f"- exact) / |exact| {gap:+.3e} <= {LARGE_GAP:g}")
    del ops, problem, theta, fitted


def check_c7_fits(c7, x2, y2, m2, device):
    """Phase 16's C7 fits against the single card: each model's objective at
    its chosen lambda no worse, by LARGE_GAP, than a single-card cold solve
    there from the same start (rho0 = lambda_0 / 5): the exact-f32 route's
    at 16^4, the spectral2 route's (the same algorithm, the same cap) for
    the reduced block set; no slab kernel launched (their plain stages)."""
    import torch
    from multivartv_tpu_torch import SolverConfig
    from multivartv_tpu_torch.api import _fresh_solve, _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH
    from multivartv_tpu_torch.solver import admm

    for label, (model, _, used, x, y, m, cfg) in c7.items():
        full = cfg.include_full_mixed
        ref_cfg = (SolverConfig(use_kernels=False) if full else cfg)
        _, _, spec, _, _, ops, problem = _setup(x, y, m, None, ref_cfg, DEFAULT_MESH, device)
        route = admm.solve_route(ops, ref_cfg)
        grid = torch.as_tensor(model.lambdas, device=device)
        best = model.lambda_minmse_ind
        theta, fitted = _fresh_solve(ops, problem, grid[best], grid[0] / 5.0, ref_cfg)
        lam = float(grid[best])
        ref = objective64({"theta_lattice": theta.cpu().numpy(), "fitted": fitted.cpu().numpy(),
                           "y": y, "mesh_spec": spec, "lambda": lam}, full)
        obj = objective64({"theta_lattice": model.theta_lattice, "fitted": model.fitted,
                           "y": model.y, "mesh_spec": model.mesh_spec, "lambda": lam}, full)
        gap = (obj - ref) / abs(ref)
        log(f"  mvtv_sharded {label} at the chosen lambda {lam:.6g}: objective {obj:.9e} vs the "
            f"single card's {route or 'exact'} route's cold solve {ref:.9e}")
        check(gap <= LARGE_GAP, f"mvtv_sharded {label}: objective at the chosen lambda (shard - "
              f"{route or 'exact'}) / |{route or 'exact'}| {gap:+.3e} <= {LARGE_GAP:g}")
        slab_kernels = [k for k in SHARD + SHARD3 if used.get(k)]
        check(not slab_kernels and bool(np.all(np.isfinite(model.theta_lattice))),
              f"mvtv_sharded {label}: finite, no slab kernel launched ({slab_kernels})")
        del ops, problem, theta, fitted


def check_shard_arms(label, ops, pr, scfg, spec, warm, y, lam_v, arms):
    """After shard_arms: xla_packed=False against the exact-f32 route after
    the same iterations from the same warm state (ARMS_FIXED_GAP, two-sided:
    the same algorithm, sums in other orders); then the default arm and
    xla_packed=False each solved from the warm state to Boyd's test or
    ARMS_CAP, the default's objective no worse than the exact arm's by
    LARGE_GAP (tests/test_pad_single.py:118, one-sided)."""
    import dataclasses

    import torch
    from multivartv_tpu_torch import SolverConfig
    from multivartv_tpu_torch.ops import interp
    from multivartv_tpu_torch.solver import admm

    lam = torch.tensor(lam_v, dtype=torch.float32, device=pr.oty.device)

    def objective(state):
        fitted = interp.gather_fitted(state.theta, pr.flat_idx)
        return objective64({"theta_lattice": state.theta.cpu().numpy(),
                            "fitted": fitted.cpu().numpy(), "y": y, "mesh_spec": spec,
                            "lambda": lam_v})

    # The exact route on the whole lattice: a group of one's slab is the
    # lattice, so its operators are the single card's set-up.
    exact = admm.admm_fixed_iterations(dataclasses.replace(ops, slab=None), pr, lam, warm,
                                       SolverConfig(use_kernels=False), SHARD_ARM_ITERS)
    gap = objective(arms["xla_packed=False"][2]) / objective(exact) - 1
    check(abs(gap) <= ARMS_FIXED_GAP, f"{label} shard route xla_packed=False against the "
          f"exact route after {SHARD_ARM_ITERS} iterations: {gap:+.3e}, |.| <= "
          f"{ARMS_FIXED_GAP:g}")
    del exact
    objs = {}
    for name in ("default", "xla_packed=False"):
        cfg = dataclasses.replace(scfg, max_iters=ARMS_CAP, **ARMS[name])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = admm.admm_solve(ops, pr, lam, warm, cfg)
        torch.cuda.synchronize()
        objs[name] = objective(out)
        log(f"  {label} shard route {name} solved from the warm state (cap {ARMS_CAP}): "
            f"{out.counter} iterations, {out.cg_iters - warm.cg_iters} CG steps, converged "
            f"{admm.solver_diagnostics(out)['converged']}, {time.perf_counter() - t0:.2f} s, "
            f"objective {objs[name]:.9e} [{GPU_LINE}]")
    gap = objs["default"] / objs["xla_packed=False"] - 1
    check(gap <= LARGE_GAP, f"{label} shard route: the default arm's objective against the exact "
          f"arm's (cap {ARMS_CAP}): {gap:+.3e} <= {LARGE_GAP:g}")


def phase_timing_shard(device):
    """Phase 17: B8s, B9s (b given, as the shard route calls it), the slab
    matvec and B11s beside their plain versions and their bounds, and
    beside the whole-lattice kernels (B8, B9, B10, B2's) on the same total
    lattice: the warm 2048^2 state, on the
    main path's slab (one rank: the whole lattice, zero halos) and on one
    of SHARD_SLABS slabs; and the slab matvec on the one-rank 1024^2 slab
    of SHARD_HALF (time_call).  Returns {kernel: (ms, plain_ms, m)} at the
    main path's slab."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import admm

    log(f"phase 17: the row-slab kernels' timing on {GPU_LINE} (CUDA events)")
    I = tiled_inputs("2048^2 n=2^22", device)
    ops, pr, s, lam, m = I["ops"], I["problem"], I["s"], I["lam"], I["m"]
    sc, kappa = ops.scales, lam / s.rho
    alpha = admm._refresh_alpha(ops, s, lam).alpha
    b = pr.oty + s.rho * (s.dta + s.u_scale * s.dtu)
    times = {}
    for slabs in (1, SHARD_SLABS):
        rows = m[0] // slabs
        r = 1 if slabs > 1 else 0

        def cut(x):
            return x[r * rows:(r + 1) * rows]

        lo, hi = r * rows, (r + 1) * rows
        tops, bots = slab_halos((s.theta, *s.u), lo, hi)
        (vt,), (vb,) = slab_halos((s.theta,), lo, hi)
        atops, abots = slab_halos((*alpha, *s.u), lo, hi)
        u_r, a_r = tuple(cut(w) for w in s.u), tuple(cut(a) for a in alpha)
        dual = (cut(s.theta), u_r, tops, bots, r * rows, m[0], kappa, sc, s.u_scale, None, True,
                False)
        gram = (cut(b), cut(s.theta), vt, vb, r * rows, m[0], cut(pr.counts), s.rho, sc)
        mv = (cut(s.theta), vt, vb, r * rows, m[0], cut(pr.counts), s.rho, sc)
        rhs = (a_r, u_r, atops, abots, r * rows, cut(pr.oty), s.rho, s.u_scale, sc)
        cases = {
            "dual_update_tiled_2d_shard": (
                lambda: K.dual_update_tiled_2d_shard(*dual),
                lambda: K.dual_update_tiled_2d_shard_reference(*dual),
                lambda: K.dual_update_tiled_2d(s.theta, s.u, kappa, sc, s.u_scale, None, True,
                                               False)),
            "gram_residual_tiled_2d_shard": (
                lambda: K.gram_residual_tiled_2d_shard(*gram),
                lambda: K.gram_residual_tiled_2d_shard_reference(*gram),
                lambda: K.gram_residual_tiled_2d(b, s.theta, pr.counts, s.rho, sc)),
            "gram_matvec_tiled_2d_shard": (
                lambda: K.gram_matvec_tiled_2d_shard(*mv),
                lambda: K.gram_matvec_tiled_2d_shard_reference(*mv),
                lambda: K.gram_matvec_tiled_2d(s.theta, pr.counts, s.rho, sc)),
            "rhs_tiled_2d_shard": (
                lambda: K.rhs_tiled_2d_shard(*rhs),
                lambda: K.rhs_tiled_2d_shard_reference(*rhs),
                lambda: K.rhs_tiled_2d(alpha, s.u, pr.oty, s.rho, s.u_scale, sc)),
        }
        shape = (rows, m[1])
        for k, (kern, plain, whole) in cases.items():
            p1, k1, w1, k2, p2 = (cuda_time_ms(plain, 5), cuda_time_ms(kern, 20),
                                  cuda_time_ms(whole, 20), cuda_time_ms(kern, 20),
                                  cuda_time_ms(plain, 5))
            b_ms, b_by = bound(k, shape)
            log(f"  {k} slab {shape[0]}x{shape[1]} of 2048^2: kernel {k1:.4f} / {k2:.4f} ms, "
                f"plain {p1:.4f} / {p2:.4f} ms, bound {b_ms:.4f} ms ({b_by}); the whole-lattice "
                f"kernel on 2048^2 {w1:.4f} ms [{GPU_LINE}]")
            if slabs == 1:
                times[k] = (min(k1, k2), min(p1, p2), shape)
    del I, s, alpha
    # The slab matvec on the folds = 2 fit's one-rank 1024^2 slab, where
    # most of its launches are (the sharded PCG's).
    saved = admm.WHOLE_MAX_KNOTS
    admm.WHOLE_MAX_KNOTS = SHARD_HALF[1][0] * SHARD_HALF[1][1] // 2
    try:
        I = tiled_inputs("2048^2 n=2^22", device, workload=SHARD_HALF)
    finally:
        admm.WHOLE_MAX_KNOTS = saved
    s, m = I["s"], I["m"]
    (vt,), (vb,) = slab_halos((s.theta,), 0, m[0])
    mv = (s.theta, vt, vb, 0, m[0], I["problem"].counts, s.rho, I["ops"].scales)
    time_call("gram_matvec_tiled_2d_shard", "1024^2 one-rank slab",
              lambda: K.gram_matvec_tiled_2d_shard(*mv), m)
    del I, s, mv
    torch.cuda.empty_cache()
    return times


# ---------------------------------------------------------------------------
# The p = 1 path: T1 (the exact tridiagonal x-update), the 1-D fused lasso
# (m = N, mesh = sorted x) and user meshes
# ---------------------------------------------------------------------------

def fused_lasso_data(n: int, seed: int = 0):
    """The 1-D fused lasso's data (the vignette's m = N, mesh = x case,
    MultivarTV-intro.Rmd:111-118): sorted x ~ U(0, 1), y a step plus a sine
    plus N(0, 0.3^2) noise."""
    rng = np.random.RandomState(seed)
    x = np.sort(rng.uniform(0, 1, n))
    return x, (x > 0.5).astype(float) + 0.5 * np.sin(4 * np.pi * x) + rng.randn(n) * 0.3


# T1 against the plain cyclic reduction on the card (phase 3): every size
# at g = (rho s) s = 0.7 * 1.3^2, and g from 1e-4 to 50 (the ill-conditioned
# end of the JAX package's docstring, tridiag.py:212-219) at the sizes of
# the paths (316: the default mesh at n = 1e5; 2^20 and 10^6 + 1: the fused
# lasso; 1e5: the fused lasso's mvtv; 4,194,305: above N_res, the
# multi-level route), a fifth of the knots empty.  The tolerance is the JAX
# package's own for its cyclic reduction (tests/test_tridiag.py:33-44), of
# max|x|.  At 2^20 (g = 0.7) the float64 solution's distance is held at
# T1_F64, the plain CR's there.
T1_SIZES = (1, 2, 3, 64, 316, 1000, 2048, 4096, 4097, 70_000, 1 << 15, 100_000, 1 << 20,
            1_000_001, 4_194_305)
T1_G_SIZES = (316, 4097, 100_000, 1 << 20, 1_000_001, 4_194_305)
T1_G = (1e-4, 1e-2, 1.0, 50.0)
T1_TOL = 5e-6
T1_F64 = 1.0e-6
T1_ABOVE = 4_194_305


def tridiag_inputs(n: int, seed: int, device):
    """Poisson(2) counts with a fifth of the knots emptied (at least one
    count), and b ~ N(0, 1), float32 on the device."""
    import torch
    rng = np.random.RandomState(seed)
    counts = rng.poisson(2, n).astype(np.float32)
    counts[rng.uniform(size=n) < 0.2] = 0.0
    counts[0] = max(counts[0], 1.0)
    return (torch.as_tensor(counts, device=device),
            torch.as_tensor(rng.randn(n).astype(np.float32), device=device))


def banded64(counts, b, g, open_lo: bool = False, open_hi: bool = False) -> np.ndarray:
    """The float64 solution of (diag(counts) + g T) x = b (scipy), T's
    diagonal kept at 2 at an open end (a segment inside a longer chain); b
    of shape (n,) or (k, n), x of the same shape."""
    import scipy.linalg
    c = counts.double().cpu().numpy()
    n = len(c)
    ab = np.zeros((3, n))
    ab[0, 1:] = ab[2, :-1] = -g
    ab[1] = c + g * (2.0 - (np.arange(n) == 0) * (not open_lo)
                     - (np.arange(n) == n - 1) * (not open_hi))
    return scipy.linalg.solve_banded((1, 1), ab, b.double().cpu().numpy().T).T


def t1_route(n: int) -> str:
    """T1's route at n rows on this card, from its scratch size: the
    segment solve takes 8 floats a segment (at most 512 segments,
    csrc/tridiag.cu kMaxGrid), the multi-level route five arrays a level."""
    from multivartv_tpu_torch.ops import kernels as K
    work = int(K._lib().mvtv_xupdate_tridiag_work(n))
    return f"segments {max(work // 8, 1)}" if work <= 8 * 512 else "multi-level"


def t1_n_res() -> int:
    """N_res: the largest n T1's segment solve takes on this card."""
    lo, hi = 4096, 1 << 24
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if t1_route(mid) != "multi-level" else (lo, mid)
    return lo


def compare_tridiag(device, errs):
    """T1 (csrc/tridiag.cu) against its plain version, the cyclic reduction
    of solver/tridiag.py, on the same card inputs: max|x - plain| <= T1_TOL
    max|plain|, and a second run bit for bit; the float64 solution's
    distance to each printed beside, held at T1_F64 at 2^20."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import tridiag

    n_res = t1_n_res()
    log(f"  T1: the segment solve up to N_res = {n_res:,} rows, the multi-level route above "
        f"[{GPU_LINE}]")
    check(n_res >= FUSED_ONE and t1_route(T1_ABOVE) == "multi-level",
          f"T1: 2^20 rows on the segment solve (N_res {n_res:,}), {T1_ABOVE:,} on the "
          f"multi-level route ({t1_route(T1_ABOVE)})")
    s = 1.3
    cases = [(n, 0.7 / (s * s)) for n in T1_SIZES] + [
        (n, g / (s * s)) for n in T1_G_SIZES for g in T1_G]
    worst = 0.0
    for i, (n, rho_v) in enumerate(cases):
        counts, b = tridiag_inputs(n, 100 + i, device)
        rho = torch.tensor(rho_v, dtype=torch.float32, device=device)
        x = K.xupdate_tridiag(counts, b, rho, s)
        x2 = K.xupdate_tridiag(counts, b, rho, s)
        ref = tridiag.xupdate_tridiag(counts, b, rho, s)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((x - ref).abs().max()) / scale
        worst = max(worst, err)
        g = float(np.float32(np.float32(rho_v) * np.float32(s)) * np.float32(s))
        x64 = banded64(counts, b, g)
        s64 = float(np.abs(x64).max())
        e_k = float(np.abs(x.double().cpu().numpy() - x64).max()) / s64
        e_p = float(np.abs(ref.double().cpu().numpy() - x64).max()) / s64
        check(err <= T1_TOL and bool(torch.isfinite(x).all()),
              f"xupdate_tridiag n={n} g={g:.3g} ({t1_route(n)}): max|x - plain| / max|plain| "
              f"{err:.3e} <= {T1_TOL:g} (float64 solution: kernel {e_k:.2e}, plain {e_p:.2e})")
        check(torch.equal(x, x2), f"xupdate_tridiag n={n} g={g:.3g}: second run bit for bit")
        if n == FUSED_ONE and i < len(T1_SIZES):
            check(e_k <= T1_F64, f"xupdate_tridiag n=2^20 g={g:.3g}: float64 solution's distance "
                  f"{e_k:.2e} <= {T1_F64:g} (plain {e_p:.2e})")
    errs["xupdate_tridiag"] = worst


def t1_fold_spy():
    """A context that records T1's launches in every admm_solve called from
    mvtv's cross-validation (one per fold and lambda; the folds run one
    after another on the "tridiag" route): a list of (launches, iterations)
    per fold solve."""
    import contextlib
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import admm, cv

    @contextlib.contextmanager
    def spy():
        solve, cross = admm.admm_solve, cv.cross_validate
        seen, inside = [], [False]

        def solve_spy(*a, **k):
            before = K.launch_counts["xupdate_tridiag"]
            out = solve(*a, **k)
            if inside[0]:
                seen.append((K.launch_counts["xupdate_tridiag"] - before, int(out.counter)))
            return out

        def cross_spy(*a, **k):
            inside[0] = True
            try:
                return cross(*a, **k)
            finally:
                inside[0] = False

        admm.admm_solve, cv.cross_validate = solve_spy, cross_spy
        try:
            yield seen
        finally:
            admm.admm_solve, cv.cross_validate = solve, cross
    return spy()


def check_t1_folds(label, seen, folds: int, n_lambda: int) -> None:
    """Every fold solve of a p = 1 cross-validation launched T1 once per
    iteration."""
    bad = [(k, it) for k, it in seen if k != it or k == 0]
    check(len(seen) == folds * n_lambda and not bad,
          f"{label}: T1 launched once per iteration in each of the {len(seen)} fold solves "
          f"({folds} folds x {n_lambda} lambdas; {sum(k for k, _ in seen)} launches; "
          f"mismatches {bad[:3]})")


# The fused lasso on the card (phase 20): mvtv_one at N = 2^20 at lambda =
# FUSED_FRAC lambda_max, against the exact route (the plain cyclic reduction
# on the card), one-sided at LARGE_GAP; mvtv(folds=5, n_lambda=20) at N = 1e5
# against the JAX package's fit of the same data (FUSED_JAX), every solve of
# both capped at FUSED_CAP iterations (at the default 3,000 the fit took
# 244-319 s of the run's 1,200; at 1,000, 120-168 s, 14 of 20 lambdas at
# the cap; at 500 18 of 20, about half the iterations again).
FUSED_ONE = 1 << 20
FUSED_FRAC = 1e-4
FUSED_CV = (100_000, 5, 20)
FUSED_CAP = 500
# The JAX package's mvtv on fused_lasso_data(100_000) with the port's fold
# labels, run on the CPU (its cyclic-reduction x-update) by:
#
#   import jax.numpy as jnp, numpy as np
#   from multivartv_tpu import api
#   from multivartv_tpu.config import SolverConfig
#   from multivartv_tpu.solver import cv
#   x, y = fused_lasso_data(100_000)
#   labels = np.random.RandomState(123).permutation(np.arange(100_000) % 5)
#   cv.kfold_indices = lambda n, k, seed: jnp.asarray(labels, jnp.int32)
#   model = api.mvtv(x, y, m=(100_000,), mesh=x[:, None], n_lambda=20, folds=5,
#                    solver_config=SolverConfig(max_iters=FUSED_CAP))
#   # lambdas = model.lambdas, best = model.lambda_minmse_ind, cv_mses, per
#   # lambda i the objective 0.5 ||y - fitted||^2 + lambda ||diff theta||_1 in
#   # float64 of model.models[i] (at p = 1 D is the unscaled difference), and
#   # its iterations; 341 s on the CPU.
# Its lambda_max is float32 (1.66e-3 above the float64 value, which the
# port computes: lam_max64 gives 124469.307), so the port's fit takes JAX's
# grid (lambdas=) and is compared with it lambda for lambda.
FUSED_JAX = dict(
    lambda_max=124676.25, best=19,
    lambdas=[124676.25, 76781.5859375, 47285.859375, 29120.888671875, 17934.033203125,
             11044.6552734375, 6801.83251953125, 4188.89306640625, 2579.722900390625,
             1588.718017578125, 978.4088745117188, 602.551513671875, 371.08013916015625,
             228.52908325195312, 140.7392578125, 86.67399597167969, 53.37803649902344,
             32.872764587402344, 20.244638442993164, 12.467623710632324],
    cv_mses=[0.09463705867528915, 0.09730749577283859, 0.0998820960521698, 0.10250020027160645,
             0.10519924014806747, 0.1079883724451065, 0.11086545139551163, 0.11382334679365158,
             0.11526129394769669, 0.10457298904657364, 0.10009779781103134, 0.09795631468296051,
             0.09596413373947144, 0.09403778612613678, 0.09268319606781006, 0.09179358929395676,
             0.09120748937129974, 0.09086522459983826, 0.09065286070108414, 0.09053508192300797],
    objectives=[593867.4529574986, 355398.10029229376, 214226.07748959918, 130170.04604679564,
                80009.39327720829, 50055.68349009582, 32177.432676378165, 21523.739454779374,
                19338.812475652914, 14844.98588808937, 12478.418426766704, 13069.591078896097,
                12925.79132066836, 10934.604060068737, 8750.29743622522, 7132.771805731358,
                6151.0443048903835, 5502.145879877965, 5095.89229031752, 4843.047257629148],
    iters=[500, 500, 500, 500, 500, 500, 500, 500, 489, 500, 417, 500, 500, 500, 500, 500, 500,
           500, 500, 500])
# The 316^2 point-cloud fit (phase 20): bivariate_exp(1e5) on the default
# mesh's lattice, every point moved by N(0, (0.1 h)^2), h the knot spacing,
# so the mesh is no lattice; lambda as WORKLOADS' 316^2.
CLOUD = (100_000, 316, 0.1, 10.0)


def pointcloud_ties(x, pts, a, b) -> np.ndarray:
    """Where two assignments a, b of the rows of x to rows of pts differ,
    whether they differ at a float32 tie: the float64 squared distances to
    the two rows within the float32 scan's error (|x|^2 - 2 x.p + |p|^2 in
    float32: a few ulps of |x|^2 + |p|^2)."""
    x64 = np.asarray(x, np.float32).astype(np.float64)
    p64 = np.asarray(pts, np.float32).astype(np.float64)
    da = ((x64 - p64[a]) ** 2).sum(1)
    db = ((x64 - p64[b]) ** 2).sum(1)
    scale = (x64 ** 2).sum(1) + np.maximum((p64[a] ** 2).sum(1), (p64[b] ** 2).sum(1))
    return np.abs(da - db) <= 8 * np.finfo(np.float32).eps * scale


def check_pointcloud(device) -> dict:
    """mvtv_one on a 316^2 point cloud (the jittered lattice of CLOUD) under
    the launch counters: the kd-tree's assignment on the host against the
    device brute force the fit used (equal, except at float32 ties, each
    checked to be one), fitted = theta at every sample's knot, and the fit
    against the exact route.  Returns its launches."""
    import torch
    from multivartv_tpu_torch import mesh as mesh_lib
    from multivartv_tpu_torch.ops import interp
    from multivartv_tpu_torch.ops import kernels as K

    n, side, jit, lam = CLOUD
    x, y = bivariate_exp(n)
    rng = np.random.RandomState(12)
    knots = [np.linspace(x[:, j].min() - 1e-4, x[:, j].max() + 1e-4, side) for j in range(2)]
    base = np.stack([np.tile(knots[0], side), np.repeat(knots[1], side)], 1)
    h = (knots[0][-1] - knots[0][0]) / (side - 1)
    cloud = base + rng.normal(0, jit * h, base.shape)
    before = dict(K.launch_counts)
    res = mvtv_one_mesh(x, y, (side, side), cloud, lam, device)
    used = {k: K.launch_counts[k] - before[k] for k in K.KERNELS
            if K.launch_counts[k] != before[k]}
    spec = res["mesh_spec"]
    log(f"  point cloud {side}^2 n={n} lam={lam:g}: {route_split(res)}, converged "
        f"{res['diagnostics']['converged']}, {res['seconds']:.2f} s [{GPU_LINE}], "
        f"launches {used}")
    check(isinstance(spec, mesh_lib.PointCloudMeshSpec), "point cloud: a PointCloudMeshSpec")
    t1 = time.perf_counter()
    host = interp.flat_knot_indices(spec, x).cpu().numpy()
    t_host = time.perf_counter() - t1
    t1 = time.perf_counter()
    dev = interp.flat_knot_indices(spec, torch.as_tensor(x, dtype=torch.float32,
                                                         device=device)).cpu().numpy()
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t1
    diff = np.nonzero(host != dev)[0]

    def ref_row(c):     # C-order flat index -> the cloud's row (axis 0 fastest)
        return c // side + side * (c % side)

    ties = pointcloud_ties(x[diff], cloud, ref_row(host[diff]), ref_row(dev[diff]))
    log(f"  point cloud {side}^2: kd-tree (host, float64) {t_host:.2f} s, brute force (card, "
        f"float32) {t_dev:.2f} s; {len(diff)} of {n} samples assigned differently, "
        f"{int(ties.sum())} of them at float32 ties")
    check(bool(ties.all()), f"point cloud {side}^2: the kd-tree's assignment equals the device "
          f"brute force's except at float32 ties ({len(diff)} samples of {n}, each a tie)")
    th = res["theta_lattice"].reshape(-1)
    check(np.array_equal(res["fitted"], th[dev]),
          f"point cloud {side}^2: fitted = theta at each sample's nearest point")
    check(res["diagnostics"]["converged"] and used.get("admm_iters_2d", 0) > 0,
          f"point cloud {side}^2: converged on the kernel route (admm_iters_2d "
          f"{used.get('admm_iters_2d', 0)})")
    ref = mvtv_one_mesh(x, y, (side, side), cloud, lam, device, use_kernels=False)
    gap = (res["objective"] - ref["objective"]) / abs(ref["objective"])
    check(gap <= 2e-5, f"point cloud {side}^2: objective (kernel - exact) / |exact| {gap:+.3e} "
          "<= 2e-5")
    return used


def mvtv_one_mesh(x, y, m, mesh, lam, device, **cfg):
    """fit() with a user's mesh=."""
    import torch
    from multivartv_tpu_torch import SolverConfig, mvtv_one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mvtv_one(x, y, m=m, mesh=mesh, lam=lam, solver_config=SolverConfig(**cfg),
                   device=device)
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    res["objective"] = objective64(res)
    return res


def phase_fused(device):
    """Phase 20, the p = 1 main path under the launch counters: mvtv_one on
    the fused lasso at N = 2^20 (mesh = sorted x: irregular float32 knots,
    some coinciding and left empty) and mvtv(folds=5, n_lambda=20) at N =
    1e5 on JAX's lambda grid (solves capped at FUSED_CAP), both through T1; and mvtv_one on a 316^2
    point cloud.  Then, launches not counted: the 2^20 fit against the
    exact route, both lambda_max against lam_max64, the 1e5 fit against
    FUSED_JAX."""
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH, PathConfig, SolverConfig
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import path

    log("phase 20: the 1-D fused lasso (m = N, mesh = x) and a point-cloud mesh, counters reset")
    n1 = FUSED_ONE
    x1, y1 = fused_lasso_data(n1)
    mesh1 = x1[:, None]
    _, _, spec1, _, _, ops1, pr1 = _setup(x1, y1, (n1,), mesh1, SolverConfig(), DEFAULT_MESH,
                                          device)
    lmax = float(path.lam_max(ops1, pr1, PathConfig()))
    empty = int((pr1.counts == 0).sum())
    k32 = x1.astype(np.float32)
    runs = int(np.count_nonzero(k32[1:] == k32[:-1]))
    check(not spec1.regular and empty == runs,
          f"fused lasso N=2^20: irregular mesh, {empty} empty knots = {runs} float32 knots "
          "equal to their left neighbour")
    del ops1, pr1
    lam1 = FUSED_FRAC * lmax
    K.reset_launch_counts()
    res = mvtv_one_mesh(x1, y1, (n1,), mesh1, lam1, device)
    used1 = dict(K.launch_counts)
    d = res["diagnostics"]
    log(f"  fused lasso N=2^20 lam={lam1:.6g} ({FUSED_FRAC:g} lambda_max): {route_split(res)}, "
        f"CG steps {d['cg_iterations']}, converged {d['converged']}, {res['seconds']:.2f} s "
        f"[{GPU_LINE}], launches {{'xupdate_tridiag': {used1['xupdate_tridiag']}}}")
    check(used1["xupdate_tridiag"] == d["iterations"] and d["cg_iterations"] == 0
          and d["exact_iterations"] == 0,
          f"fused lasso N=2^20: T1 launched once per iteration ({used1['xupdate_tridiag']} for "
          f"{d['iterations']}), 0 CG steps")

    n, folds, n_lambda = FUSED_CV
    x, y = fused_lasso_data(n)
    before = K.launch_counts["xupdate_tridiag"]
    with t1_fold_spy() as seen:
        model, cvres, fpath, seconds = mvtv_fit(x, y, (n,), device, n_lambda=n_lambda,
                                                folds=folds, mesh=x[:, None],
                                                lambdas=FUSED_JAX["lambdas"],
                                                max_iters=FUSED_CAP)
    used_cv = K.launch_counts["xupdate_tridiag"] - before
    describe_mvtv(f"fused lasso N={n}", model, cvres, fpath, seconds, max_iters=FUSED_CAP)
    check_t1_folds(f"mvtv fused lasso N={n}", seen, folds, n_lambda)
    its = int(cvres.fold_iters.sum()) + int(fpath.iters.sum())
    check(used_cv >= its, f"mvtv fused lasso N={n}: T1 launched {used_cv} times, once in each "
          f"of the {its} fold and path iterations (and the refit's, if any)")
    used_cloud = check_pointcloud(device)
    launches = dict(K.launch_counts)
    log(f"  phase 20 launch counts: {launches}")
    check(launches["xupdate_tridiag"] > 0,
          f"the p = 1 path launched xupdate_tridiag ({launches['xupdate_tridiag']} times)")

    log("phase 20: against the exact route (the plain cyclic reduction on the card), "
        "lam_max64 and the JAX package's fit")
    ref = mvtv_one_mesh(x1, y1, (n1,), mesh1, lam1, device, use_kernels=False)
    gap = (res["objective"] - ref["objective"]) / abs(ref["objective"])
    log(f"  fused lasso N=2^20: exact route {route_split(ref)}, {ref['seconds']:.2f} s; "
        f"objective {res['objective']:.9e} vs {ref['objective']:.9e}")
    check(gap <= LARGE_GAP, f"fused lasso N=2^20: objective (T1 - exact) / |exact| {gap:+.3e} "
          f"<= {LARGE_GAP:g}")
    check(bool(np.all(np.isfinite(res["theta_lattice"]))) and res["fitted"].shape == y1.shape,
          "fused lasso N=2^20: theta finite, shapes")
    check_lambda_max64("fused lasso N=2^20", lmax, x1, y1, spec1)
    _, _, spec, _, _, ops, pr = _setup(x, y, (n,), x[:, None], SolverConfig(), DEFAULT_MESH,
                                       device)
    lmax_cv = float(path.lam_max(ops, pr, PathConfig()))
    log(f"  fused lasso N={n}: lambda_max {lmax_cv:.9g}, the JAX package's (float32) "
        f"{FUSED_JAX['lambda_max']:.9g} ({FUSED_JAX['lambda_max'] / lmax_cv - 1:+.2e})")
    check_lambda_max64(f"fused lasso N={n}", lmax_cv, x, y, spec)
    check_fused_jax(model, y)
    return launches


def check_fused_jax(model, y) -> None:
    """The fused-lasso mvtv (on JAX's lambda grid) against FUSED_JAX: the
    chosen index in JAX's tie set (MVTV_TIE), the objective at it one-sided
    (MVTV_OBJECTIVE), the CV curve (MVTV_CURVE)."""
    jax_fit = FUSED_JAX
    n = len(y)
    check(np.array_equal(model.lambdas, np.asarray(jax_fit["lambdas"], np.float32)),
          f"mvtv fused lasso N={n}: JAX's lambda grid")
    jc = np.asarray(jax_fit["cv_mses"])
    best = model.lambda_minmse_ind
    ties = np.nonzero(jc <= jc.min() * (1 + MVTV_TIE))[0].tolist()
    check(best == jax_fit["best"] or best in ties,
          f"mvtv fused lasso N={n}: chosen index {best} == JAX's {jax_fit['best']} or in {ties}")
    rel = np.asarray(model.cv_mses, np.float64) / jc - 1
    log(f"    CV curve / JAX's - 1: {[f'{v:+.1e}' for v in rel]}")
    curve = float(np.max(np.abs(rel)))
    check(curve <= MVTV_CURVE, f"mvtv fused lasso N={n}: CV curve vs JAX max rel {curve:.3e} <= "
          f"{MVTV_CURVE:g}")
    obj, jobj = model_objective(model), jax_fit["objectives"][best]
    gap = obj / jobj - 1
    check(gap <= MVTV_OBJECTIVE, f"mvtv fused lasso N={n}: objective at the chosen lambda "
          f"{obj:.9e} vs JAX's {jobj:.9e} (rel {gap:+.3e} <= {MVTV_OBJECTIVE:g})")
    paths = [model_objective(model, i) / jax_fit["objectives"][i] - 1
             for i in range(len(jc))]
    log(f"    full-path objective / JAX's - 1 per lambda: {[f'{v:+.1e}' for v in paths]}")
    log(f"    iterations per lambda {[e['iters'] for e in model.models]} (JAX "
        f"{jax_fit['iters']})")


T1_TIMED = (316, 4096, 100_000, 1 << 20)


def phase_timing_fused(device):
    """Phase 21: T1 at the default p = 1 mesh of n = 1e5 (316 knots), at
    4,096 (its largest one-segment system), at 1e5 (the fused lasso's mvtv)
    and at 2^20 (the fused lasso's mvtv_one) beside
    its plain version and its bound (12 bytes a row), with its device time
    and kernels per call; then the fused-lasso ADMM iteration at N = 2^20
    (CUDA events, torch.profiler: ms per iteration, idle share).  Returns
    {"xupdate_tridiag": (ms, plain_ms, (2^20,))}."""
    import torch
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH, SolverConfig
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import admm, tridiag

    log(f"phase 21: T1 and the fused-lasso iteration on {GPU_LINE} (CUDA events)")
    times = {}
    for n in T1_TIMED:
        counts, b = tridiag_inputs(n, 7, device)
        rho = torch.tensor(0.5, dtype=torch.float32, device=device)

        def kern():
            return K.xupdate_tridiag(counts, b, rho, 1.0)

        def plain():
            return tridiag.xupdate_tridiag(counts, b, rho, 1.0)

        p1 = cuda_time_ms(plain, 5)
        k_ms = time_call("xupdate_tridiag", f"n={n}", kern, (n,), n=50)
        p2 = cuda_time_ms(plain, 5)
        log(f"  xupdate_tridiag n={n}: plain {p1:.4f} / {p2:.4f} ms [{GPU_LINE}]")
        times["xupdate_tridiag"] = (k_ms, min(p1, p2), (n,))
    n1 = FUSED_ONE
    x1, y1 = fused_lasso_data(n1)
    cfg = SolverConfig()
    _, _, _, _, _, ops, pr = _setup(x1, y1, (n1,), x1[:, None], cfg, DEFAULT_MESH, device)
    lam = torch.tensor(1.0, dtype=torch.float32, device=device)
    state0 = admm.initial_state(ops, pr, lam / 5)
    n_it = 50

    def run():
        return admm.admm_fixed_iterations(ops, pr, lam, state0, cfg, n_it)

    ms = cuda_time_ms(run, 2, warmup=1) / n_it
    log(f"  fused lasso N=2^20 (tridiag route): admm_fixed_iterations {ms:.3f} ms per "
        f"iteration = {1e3 / ms:.1f} iterations/s [{GPU_LINE}]")
    profile_iterations("fused lasso N=2^20", run, n_it, ms)
    return times


# ---------------------------------------------------------------------------
# Phase 22: the x-update arms of SolverConfig on the 2-D tiled route, a
# resumed lambda path, tv_penalty
# ---------------------------------------------------------------------------

# bench.py's 2048^2 cell (bench.py:479-484): n = 2^22, lambda = 0.05.  Each
# arm runs ARMS_ITERS admm_fixed_iterations from one warm state (ARMS_WARM
# default iterations from mvtv_one's initial state), then is timed over as
# many more (profiling.measure_iterations_per_s).
ARMS_DATA = (lambda: bench_data(1 << 22), None, 0.05)
ARMS = {"default": {}, "xla_packed=False": {"xla_packed": False},
        "spectral_cg=False": {"spectral_cg": False}}
ARMS_WARM = 8
ARMS_ITERS = 30
# xla_packed=False against the exact route after the same iterations,
# relative objective, two-sided: both are the exact float32 DCT-PCG with
# the same tolerance; they differ in B8 and B10 against their plain
# versions (sums in another order).
ARMS_FIXED_GAP = 1e-6
# spectral_cg=False (3 fixed bf16 CG steps per iteration) against the
# exact route, mvtv_one capped at ARMS_CAP iterations on both, one-sided
# at the repo's matched-objective gate (tests/test_pad_single.py:118).
ARMS_CAP = 600
# The resumed path: 316^2 (the default mesh at n = 1e5, bivariate_exp),
# CKPT_LAMBDAS lambdas in chunks of CKPT_EVERY, the manifest pointed back
# at lambda index CKPT_RESUME (inside the second chunk), the merged
# train_mse against one uninterrupted solve_path at CKPT_GAP (relative).
CKPT_LAMBDAS = 10
CKPT_EVERY = 4
CKPT_RESUME = 5
CKPT_GAP = 1e-4
TV_PENALTY_GAP = 1e-6


def arm_config(name: str, **extra):
    from multivartv_tpu_torch import SolverConfig
    return SolverConfig(**ARMS[name], **extra)


def phase_arms(device):
    """Phase 22: SolverConfig(xla_packed=False) and (spectral_cg=False)
    beside the default on the 2048^2 tiled route, under the launch
    counters: ms and CG steps per iteration, B8/B9/B10 launches and the
    roofline model's bound of each arm; xla_packed=False against the exact
    route after the same iterations, spectral_cg=False against it after a
    capped mvtv_one; then solve_path_checkpointed resumed from a mid-chunk
    manifest at 316^2, and tv_penalty against a float64 sum at 2048^2.
    Returns (launches, {kernel: (ms, plain_ms, m)}) with B10 timed at
    2048^2, where xla_packed=False launches it."""
    import torch
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH, SolverConfig
    from multivartv_tpu_torch.ops import diff, interp
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import admm, xupdate
    from multivartv_tpu_torch.utils import profiling

    log("phase 22: the x-update arms (xla_packed, spectral_cg) at 2048^2 n=2^22, the "
        "resumed lambda path, tv_penalty")
    make, m, lam_v = ARMS_DATA
    x, y = make()
    _, _, spec, _, _, ops, problem = _setup(x, y, m, None, SolverConfig(), DEFAULT_MESH,
                                            device)
    lam = torch.tensor(lam_v, dtype=torch.float32, device=device)
    check(admm.solve_route(ops, SolverConfig()) == "tiled",
          f"phase 22: {ops.m} runs the tiled route")
    layout = xupdate.spectral_layout(ops)

    def objective(state):
        fitted = interp.gather_fitted(state.theta, problem.flat_idx)
        return objective64({"theta_lattice": state.theta.cpu().numpy(),
                            "fitted": fitted.cpu().numpy(), "y": y, "mesh_spec": spec,
                            "lambda": lam_v})

    warm = admm.admm_fixed_iterations(ops, problem, lam, admm.initial_state(ops, problem, lam),
                                      SolverConfig(), ARMS_WARM)
    K.reset_launch_counts()
    objs = {}
    for name in ARMS:
        cfg = arm_config(name)
        before = dict(K.launch_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = admm.admm_fixed_iterations(ops, problem, lam, warm, cfg, ARMS_ITERS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        used = {k: K.launch_counts[k] - before[k]
                for k in ("dual_update_tiled_2d", "gram_residual_tiled_2d",
                          "gram_matvec_tiled_2d")}
        steps = (out.cg_iters - warm.cg_iters) / ARMS_ITERS
        rate = profiling.measure_iterations_per_s(
            lambda s, k: admm.admm_fixed_iterations(ops, problem, lam, s, cfg, k), warm,
            warmup=1, iters=ARMS_ITERS)
        x_update = {"default": "spectral", "xla_packed=False": "pcg",
                    "spectral_cg=False": "natural"}[name]
        rep = roofline().model_report(ops.m, n_steps=max(1, round(steps)), layout=layout,
                                      x_update=x_update, measured_iters_per_s=rate)
        objs[name] = objective(out)
        log(f"  {name}: {1e3 / rate:.3f} ms per iteration ({rate:.1f} iterations/s; first run "
            f"{seconds / ARMS_ITERS * 1e3:.3f} ms), {steps:.2f} CG steps per iteration, "
            f"launches {used} in {ARMS_ITERS} iterations; model bound "
            f"{1e3 / rep['model_bound_iters_per_s']:.3f} ms per iteration ({rep['x_update']}, "
            f"{rep['layout']}, {rep['model_gb_per_iter']} GB, "
            f"{rep['model_tflop_per_iter']} TFLOP), {rep['frac_of_model_bound']} of it "
            f"[{GPU_LINE}]")
        check(used["dual_update_tiled_2d"] == ARMS_ITERS,
              f"{name}: B8 launched once per iteration ({used['dual_update_tiled_2d']})")
        if name == "default":
            check(used["gram_residual_tiled_2d"] == ARMS_ITERS,
                  f"{name}: B9 launched once per iteration ({used['gram_residual_tiled_2d']})")
        else:
            check(used["gram_residual_tiled_2d"] == 0,
                  f"{name}: B9 not launched ({used['gram_residual_tiled_2d']})")
            check(used["gram_matvec_tiled_2d"] > ARMS_ITERS,
                  f"{name}: B10 launched more than once per iteration "
                  f"({used['gram_matvec_tiled_2d']} in {ARMS_ITERS})")
    launches = dict(K.launch_counts)

    exact = admm.admm_fixed_iterations(ops, problem, lam, warm,
                                       SolverConfig(use_kernels=False), ARMS_ITERS)
    exact_obj = objective(exact)
    for name, obj in objs.items():
        log(f"  {name}: objective after {ARMS_ITERS} iterations {obj:.9e}, exact route "
            f"{exact_obj:.9e}, {obj / exact_obj - 1:+.3e}")
    gap = objs["xla_packed=False"] / exact_obj - 1
    check(abs(gap) <= ARMS_FIXED_GAP, f"xla_packed=False against the exact route after "
          f"{ARMS_ITERS} iterations: {gap:+.3e}, |.| <= {ARMS_FIXED_GAP:g}")

    fits = {}
    for name, extra in (("spectral_cg=False", {}), ("exact", {"use_kernels": False})):
        cfg = dict(ARMS.get(name, {}), max_iters=ARMS_CAP, **extra)
        fits[name] = fit(x, y, m, lam_v, device, **cfg)
        log(f"  mvtv_one {name} (cap {ARMS_CAP}): {route_split(fits[name])}, converged "
            f"{fits[name]['diagnostics']['converged']}, {fits[name]['seconds']:.2f} s "
            f"[{GPU_LINE}]")
    gap = fits["spectral_cg=False"]["objective"] / fits["exact"]["objective"] - 1
    check(gap <= LARGE_GAP, f"mvtv_one spectral_cg=False against the exact route (cap "
          f"{ARMS_CAP}): objective {gap:+.3e} <= {LARGE_GAP:g}")

    th = warm.theta
    tv = float(diff.tv_penalty(th, ops.binaries, ops.scales))
    deltas = [float(v) for v in spec.deltas.cpu()]
    tv64 = sum(sc * np.abs(v).sum() for sc, v in block_diffs(th.double().cpu().numpy(),
                                                             deltas))
    check(abs(tv / tv64 - 1) <= TV_PENALTY_GAP, f"tv_penalty at {ops.m}: {tv:.9e} against "
          f"float64 {tv64:.9e}, {tv / tv64 - 1:+.3e}, |.| <= {TV_PENALTY_GAP:g}")

    v = warm.theta
    run = (lambda: K.gram_matvec_tiled_2d(v, problem.counts, warm.rho, ops.scales))
    plain = (lambda: K.gram_matvec_tiled_2d_reference(v, problem.counts, warm.rho, ops.scales))
    p1 = cuda_time_ms(plain, 5)
    k_ms = time_call("gram_matvec_tiled_2d", f"{ops.m} (xla_packed=False's CG matvec)", run,
                     ops.m)
    p2 = cuda_time_ms(plain, 5)
    times = {"gram_matvec_tiled_2d": (k_ms, min(p1, p2), ops.m)}
    del warm, exact, problem, ops
    torch.cuda.empty_cache()
    check_resumed_path(device)
    return launches, times


def check_resumed_path(device):
    """solve_path_checkpointed at 316^2 (n = 1e5): CKPT_LAMBDAS lambdas in
    chunks of CKPT_EVERY into a temporary directory; the carry after
    lambda CKPT_RESUME written as a checkpoint (a run stopped there) and the
    manifest pointed at it; the resumed path's merged train_mse against one
    uninterrupted solve_path."""
    import tempfile

    import torch
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH, PathConfig, SolverConfig
    from multivartv_tpu_torch.solver import path
    from multivartv_tpu_torch.utils import checkpoint

    x, y = bivariate_exp(MVTV_N)
    cfg, pcfg = SolverConfig(), PathConfig(n_lambda=CKPT_LAMBDAS, store="mse")
    _, _, _, _, _, ops, problem = _setup(x, y, None, None, cfg, DEFAULT_MESH, device)
    lambdas = path.create_lambdas(path.lam_max(ops, problem, pcfg), pcfg)
    t0 = time.perf_counter()
    full = path.solve_path(ops, problem, lambdas, cfg, pcfg)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        first = path.solve_path_checkpointed(ops, problem, lambdas, cfg, pcfg, tmp,
                                             checkpoint_every=CKPT_EVERY)
        head = path.solve_path(ops, problem, lambdas[:CKPT_RESUME + 1], cfg, pcfg)
        checkpoint.save_path_state(tmp, head.final_state, CKPT_RESUME)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = path.solve_path_checkpointed(ops, problem, lambdas, cfg, pcfg, tmp,
                                               checkpoint_every=CKPT_EVERY)
        torch.cuda.synchronize()
        t_res = time.perf_counter() - t0
    ref = full.train_mse.double()
    for label, res in (("checkpointed", first), ("resumed", resumed)):
        gap = float(((res.train_mse.double() - ref).abs() / ref.abs()).max())
        check(res.train_mse.shape == ref.shape and gap <= CKPT_GAP,
              f"solve_path_checkpointed 316^2 ({label}, {CKPT_LAMBDAS} lambdas, every "
              f"{CKPT_EVERY}, resumed after index {CKPT_RESUME}): train_mse within {gap:.2e} of "
              f"the uninterrupted path, <= {CKPT_GAP:g}")
    log(f"  316^2 path: uninterrupted {t_full:.2f} s, resumed (lambdas {CKPT_RESUME + 1}.."
        f"{CKPT_LAMBDAS - 1}) {t_res:.2f} s; iterations {full.iters.tolist()} / resumed "
        f"{resumed.iters.tolist()} [{GPU_LINE}]")


# ---------------------------------------------------------------------------
# Phase 23: the sharded fit at p = 3 (plane slabs: B12s, B13s) and p = 1
# (chain segments: T1), on a group of one NCCL rank; phase 3's checks of the
# slab modes and of the partition solve on emulated cuts
# ---------------------------------------------------------------------------

SHARD3 = ("dual_update_tiled_3d_shard", "gram_residual_tiled_3d_shard",
          "gram_matvec_tiled_3d_shard")
# Phase 23's fits: mvtv_sharded at 256^3 (folds 1) and 256 x 256 x 64
# (folds 2) on CUBES' data, SHARD3_LAMBDAS lambdas each; at p = 1 the fused
# lasso (m = N, mesh = sorted x) at N = 2^20 (folds 1) and N = 1e5 (folds
# 2), 5 lambdas each.  Every solve of a fit and of the fit it is compared
# with stops at the same cap (SHARD3_CAP, SHARD1_CAP): uncapped the 256^3
# path alone would take minutes.  At a cap of 1,000 the N = 1e5 fit and its
# comparison took 51 s of the default run on an H100 (4 of 5 solves at the
# cap); 500 halves that.
SHARD3_FIT1, SHARD3_FIT2 = "256^3 n=2^22", "256x256x64 n=2^22"
SHARD3_LAMBDAS = 3
SHARD3_CAP = 60
SHARD1_FITS = ((FUSED_ONE, 1), (100_000, 2))
SHARD1_LAMBDAS = 5
SHARD1_CAP = 500
# The plane cuts of phase 3's slab checks on PATH3 (256 x 256 x 64, axis 0
# cut): np.array_split's three, one-plane slabs inside and at both edges,
# and the one-rank slab (the main path's: halos zero, bit for bit against
# B12 and B13).
SHARD3_CUTS = (tuple(len(a) for a in np.array_split(np.arange(256), 3)), (127, 1, 128),
               (1, 254, 1), (256,))
# The slab matvec's (the Laplacian march's) extra lattices, random v and
# Poisson counts, with remainder tiles in x1 and x2 (its tile is 32 x 64):
# phase 3's 258 x 130 x 136 and 37 x 35 x 67, whose rows are not 16-byte
# multiples (the 4-byte copies); each with its plane cuts.
MATVEC3_RAGGED = (((258, 130, 136), ((86, 86, 86), (258,))),
                  ((37, 35, 67), ((18, 1, 18), (37,))))
# The partition solve's segments of a 2^20 chain, the second's counts all
# zero (a short stretch: hundreds of empty knots in a row leave float32 no
# digits of the solution, JAX's solve included, tests/test_torch_shard3d.py).
# The third's length is odd, so its solution rows 1 and 2 and the fourth's
# inputs lie off 16 bytes (T1's scalar loads and stores).
PARTITION_CUTS = (400_000, 32, 300_001, FUSED_ONE - 700_033)
PARTITION_TOL = 1e-5
# The finish kernel against its plain version: the banded and the dense
# float64 solves round differently, and a coupling may round to float32 one
# ulp apart.
FINISH_TOL = 1e-6
# admm_fixed_iterations per timed run of phase 23's iterations.
SHARD3_ITERS, SHARD1_ITERS = 3, 50


def plane_halos(xs, lo: int, hi: int):
    """(tops, bots): the plane below and above the plane slab lo .. hi - 1
    of each lattice of xs, zeros at the global edges."""
    import torch
    tops, bots = [], []
    for x in xs:
        z = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        tops.append(x[lo - 1:lo] if lo > 0 else z)
        bots.append(x[hi:hi + 1] if hi < x.shape[0] else z)
    return tops, bots


def compare_shard3(device, errs):
    """B12s (both compiled flag pairs, and with true_m one plane and row
    short), B13s (fused, b given) and the slab matvec on the plane cuts
    SHARD3_CUTS of PATH3's warm tiled3 state, each slab with its halo
    planes cut from its neighbours: each slab against its plain version
    (1e-5 x max(1, |ref|)), the slabs together against the whole-lattice
    B12 and B13 (SHARD_ELEMENT_TOL of max|x|, the matvec against -B13 with
    b = 0; the Boyd sums SHARD_STATS_TOL relative), and B12s's and B13s's
    one-rank slab against them bit for bit; the matvec also on
    MATVEC3_RAGGED's lattices; records the largest absolute errors against
    the plain versions in errs."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K

    I = cube_inputs(PATH3, device)
    ops, pr, s, m = I["ops"], I["problem"], I["s"], I["m"]
    sc, kappa, rho, us = ops.scales, I["lam"] / s.rho, s.rho, s.u_scale

    def note(kernel, got, ref):
        e = max(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref))
        errs[kernel] = max(errs.get(kernel, 0.0), e)
        return max(rel_err(g, r) for g, r in zip(got, ref))

    for cut in SHARD3_CUTS:
        tag = f"{PATH3} in plane slabs {cut}"
        bounds = np.cumsum((0,) + cut).tolist()
        slabs = list(zip(bounds[:-1], bounds[1:]))
        for tm, (want_adj, want_alpha) in ((None, (True, False)), (None, (False, True)),
                                           ((m[0] - 1, m[1] - 1, m[2]), (True, False))):
            whole = K.dual_update_tiled_3d(s.theta, s.u, kappa, sc, us, tm, want_adj, want_alpha)
            lat_w = (*(whole[0] or ()), *whole[1], *whole[3:])
            got, stats, worst = [], 0.0, 0.0
            for r, (lo, hi) in enumerate(slabs):
                tops, bots = plane_halos((s.theta, *s.u), lo, hi)
                args = (s.theta[lo:hi], tuple(w[lo:hi] for w in s.u), tops, bots, lo, m[0],
                        kappa, sc, us, tm, want_adj, want_alpha)
                k_out = K.dual_update_tiled_3d_shard(*args)
                p_out = K.dual_update_tiled_3d_shard_reference(*args)
                torch.cuda.synchronize()
                lat_k = (*(k_out[0] or ()), *k_out[1], *k_out[3:])
                lat_p = (*(p_out[0] or ()), *p_out[1], *p_out[3:])
                worst = max(worst, note("dual_update_tiled_3d_shard", lat_k, lat_p))
                check(torch.allclose(k_out[2].double(), p_out[2].double(), rtol=1e-4, atol=0),
                      f"dual_update_tiled_3d_shard {tag} slab {r} true_m={tm}: stats vs plain "
                      "(rtol 1e-4)")
                got.append(lat_k)
                stats = stats + k_out[2].double()
                del p_out, lat_p
            label = f"dual_update_tiled_3d_shard true_m={tm} want_adjoints={want_adj}"
            check(worst <= 1e-5, f"{label} {tag}: each slab vs its plain version, max err "
                  f"{worst:.3e} <= 1e-5 x max(1, |ref|)")
            e = max(rel_max(torch.cat(g), w) for g, w in zip(zip(*got), lat_w))
            same = all(torch.equal(torch.cat(g), w) for g, w in zip(zip(*got), lat_w))
            check(e <= SHARD_ELEMENT_TOL, f"{label} {tag}: slabs together vs B12, max err "
                  f"{e:.3e} <= {SHARD_ELEMENT_TOL:g} x max|x| (equal bit for bit: {same})")
            e = float(((stats - whole[2].double()).abs() / whole[2].double().abs()).max())
            check(e <= SHARD_STATS_TOL, f"{label} {tag}: the slabs' Boyd sums vs B12's, rel "
                  f"{e:.3e} <= {SHARD_STATS_TOL:g}")
            if len(slabs) == 1:
                check(same and torch.equal(k_out[2], whole[2]), f"{label} {tag}: the one-rank "
                      "slab equals B12 bit for bit (every array and the five sums)")
            del whole, lat_w, got, k_out

        b = pr.oty + rho * (s.dta + us * s.dtu)
        for label, bb, fused in (("fused rhs", None, True), ("b given", b, False)):
            parts = (pr.oty, s.dta, us, s.dtu) if fused else None
            whole = K.gram_residual_tiled_3d(bb, s.theta, pr.counts, rho, sc, rhs_parts=parts)
            got, worst = [], 0.0
            for r, (lo, hi) in enumerate(slabs):
                (top,), (bot,) = plane_halos((s.theta,), lo, hi)
                rp = (pr.oty[lo:hi], s.dta[lo:hi], us, s.dtu[lo:hi]) if fused else None
                args = (None if fused else bb[lo:hi], s.theta[lo:hi], top, bot, lo, m[0],
                        pr.counts[lo:hi], rho, sc)
                k_out = K.gram_residual_tiled_3d_shard(*args, rhs_parts=rp)
                p_out = K.gram_residual_tiled_3d_shard_reference(*args, rhs_parts=rp)
                torch.cuda.synchronize()
                worst = max(worst, note("gram_residual_tiled_3d_shard", [k_out], [p_out]))
                got.append(k_out)
            name = f"gram_residual_tiled_3d_shard ({label}) {tag}"
            check(worst <= 1e-5, f"{name}: each slab vs its plain version, max err "
                  f"{worst:.3e} <= 1e-5 x max(1, |ref|)")
            cat = torch.cat(got)
            e, same = rel_max(cat, whole), torch.equal(cat, whole)
            check(e <= SHARD_ELEMENT_TOL, f"{name}: slabs together vs B13, max err {e:.3e} <= "
                  f"{SHARD_ELEMENT_TOL:g} x max|x| (equal bit for bit: {same})")
            if len(slabs) == 1:
                check(same, f"{name}: the one-rank slab equals B13 bit for bit")
            del whole, got, cat
        del b
        check_matvec3(tag, s.theta, pr.counts, rho, sc, cut, errs)
    del I, s
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(46)
    rho, sc = torch.tensor(0.37, device=device), (0.6, 1.1, 0.8, 0.9, 1.3, 0.7, 0.5)
    for lat, cuts in MATVEC3_RAGGED:
        v = torch.randn(lat, generator=gen, device=device)
        counts = torch.poisson(torch.full(lat, 0.25, device=device), generator=gen)
        for cut in cuts:
            check_matvec3(f"{'x'.join(map(str, v.shape))} in plane slabs {cut}", v, counts, rho,
                          sc, cut, errs)
        del v, counts
        torch.cuda.empty_cache()


def check_matvec3(tag, v, counts, rho, sc, cut, errs):
    """The slab matvec (the Laplacian march) on the plane cut `cut` of the
    lattice v, each slab with its halo planes cut from its neighbours:
    each slab against its plain version (1e-5 x max(1, |ref|)), the slabs
    together against B13 with b = 0 (A v = -r0; SHARD_ELEMENT_TOL of
    max|x|); records its largest absolute error against the plain version
    in errs."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K

    name = "gram_matvec_tiled_3d_shard"
    bounds = np.cumsum((0,) + tuple(cut)).tolist()
    whole = -K.gram_residual_tiled_3d(torch.zeros_like(v), v, counts, rho, sc)
    got, worst, err = [], 0.0, 0.0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        (top,), (bot,) = plane_halos((v,), lo, hi)
        args = (v[lo:hi], top, bot, lo, v.shape[0], counts[lo:hi], rho, sc)
        k_out = K.gram_matvec_tiled_3d_shard(*args)
        p_out = K.gram_matvec_tiled_3d_shard_reference(*args)
        torch.cuda.synchronize()
        worst = max(worst, rel_err(k_out, p_out))
        err = max(err, float((k_out.double() - p_out.double()).abs().max()))
        got.append(k_out)
    errs[name] = max(errs.get(name, 0.0), err)
    check(worst <= 1e-5, f"{name} {tag}: each slab vs its plain version, max err {worst:.3e} "
          "<= 1e-5 x max(1, |ref|)")
    e = rel_max(torch.cat(got), whole)
    check(e <= SHARD_ELEMENT_TOL, f"{name} {tag}: slabs together vs B13 (b = 0), max err "
          f"{e:.3e} <= {SHARD_ELEMENT_TOL:g} x max|x|")


def compare_partition(device, errs):
    """The p = 1 partition solve emulated in one process on the segments
    PARTITION_CUTS of a 2^20 chain (the second's counts all zero) and on
    16 even ones: T1's segment mode on each against its plain version on
    the first cut, and against each segment's float64 solution on the
    second (T1_TOL of max|reference|: there the segment holding the empty
    stretch leaves the plain cyclic reduction 5.7e-6 from the float64
    solution, which is printed beside), the finish kernel on each rank
    against its plain version (FINISH_TOL of max|plain|; run with torch's
    sync check on: nothing goes to the host), and the whole against T1 on
    the whole chain (PARTITION_TOL of max|x|); the float64 solution's
    distance printed beside."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import tridiag

    n, sc = FUSED_ONE, 1.3
    counts, b = tridiag_inputs(n, 41, device)
    counts[PARTITION_CUTS[0]:PARTITION_CUTS[0] + PARTITION_CUTS[1]] = 0.0
    rho = torch.tensor(0.7 / (sc * sc), dtype=torch.float32, device=device)
    g = float(np.float32(np.float32(0.7 / (sc * sc)) * np.float32(sc)) * np.float32(sc))
    whole = K.xupdate_tridiag(counts, b, rho, sc)
    x64 = banded64(counts, b, g)
    s64 = float(np.abs(x64).max())
    e_w = float(np.abs(whole.double().cpu().numpy() - x64).max()) / s64
    even = tuple(len(a) for a in np.array_split(np.arange(n), 16))
    for cuts in (PARTITION_CUTS, even):
        lo, ends, ylrs, worst, plain64 = 0, [], [], 0.0, 0.0
        for r in cuts:
            hi = lo + r
            args = (counts[lo:hi].contiguous(), b[lo:hi].contiguous(), rho, sc, lo > 0, hi < n)
            ylr = K.xupdate_tridiag_segment(*args)
            ref = K.xupdate_tridiag_segment_reference(*args)
            torch.cuda.synchronize()
            for k in range(3):
                errs["xupdate_tridiag_segment"] = max(errs.get("xupdate_tridiag_segment", 0.0),
                                                      float((ylr[k] - ref[k]).abs().max()))
            if cuts is PARTITION_CUTS:
                want = ref.double().cpu().numpy()
            else:
                rhs = torch.zeros((3, r), dtype=torch.float64)
                rhs[0], rhs[1, 0], rhs[2, -1] = b[lo:hi].double().cpu(), 1.0, 1.0
                want = banded64(counts[lo:hi], rhs, g, lo > 0, hi < n)
                for k in range(3):
                    plain64 = max(plain64, float(np.abs(ref[k].double().cpu().numpy() - want[k])
                                                 .max() / np.abs(want[k]).max()))
            got_np = ylr.double().cpu().numpy()
            for k in range(3):
                worst = max(worst, float(np.abs(got_np[k] - want[k]).max()
                                         / np.abs(want[k]).max()))
            ylrs.append(ylr)
            ends.append(torch.cat([tridiag.segment_ends(ylr), rho.reshape(1)]))
            lo = hi
        w = len(cuts)
        vs = ("its plain version" if cuts is PARTITION_CUTS else
              f"the segment's float64 solution (the plain version's distance {plain64:.2e})")
        check(worst <= T1_TOL, f"xupdate_tridiag_segment on {w} segments of 2^20: each of "
              f"the three solves vs {vs}, max err {worst:.3e} <= {T1_TOL:g} x max|reference|")
        every = torch.stack(ends)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            parts = [K.partition_finish(every, k, sc, y) for k, y in enumerate(ylrs)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        worst = 0.0
        for k, (y, got_k) in enumerate(zip(ylrs, parts)):
            ref = K.partition_finish_reference(every, k, sc, y)
            d = float((got_k - ref).abs().max())
            worst = max(worst, d / float(ref.abs().max()))
            errs["partition_finish"] = max(errs.get("partition_finish", 0.0), d)
        check(worst <= FINISH_TOL, f"partition_finish on each of {w} ranks (no host sync) vs "
              f"its plain version (dense float64 solve): max err {worst:.3e} <= {FINISH_TOL:g} "
              "x max|plain|")
        got = torch.cat(parts)
        e = float((got - whole).abs().max() / whole.abs().max())
        e_p = float(np.abs(got.double().cpu().numpy() - x64).max()) / s64
        check(e <= PARTITION_TOL and bool(torch.isfinite(got).all()),
              f"the partition solve on {w} segments of 2^20"
              f"{' (one with no counts)' if cuts is PARTITION_CUTS else ''} vs T1 on the whole "
              f"chain: max err {e:.3e} <= {PARTITION_TOL:g} x max|x| (float64 solution: "
              f"partition {e_p:.2e}, T1 {e_w:.2e})")
        del ylrs, parts, got, every, ends
    del counts, b, whole


def shard_inputs(x, y, m, mesh, device, group, **cfg):
    """(operators, problem, config, mesh spec) of mvtv_sharded's solves on a
    row group: the shard route's slab of the whole set-up."""
    from multivartv_tpu_torch.api import _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH, SolverConfig
    from multivartv_tpu_torch.parallel import fit as pfit
    from multivartv_tpu_torch.parallel.sharding import RowSlab, shard_problem

    scfg = pfit._sharded_solver_config(SolverConfig(**cfg), group)
    setup = _setup(x, y, m, mesh, scfg, DEFAULT_MESH, device)
    slab = RowSlab(group, setup[2].m)
    ops = pfit.shard_operators(setup[5], slab)
    log(f"  {'x'.join(map(str, setup[2].m))}: the operators' fields that the cut drops hold "
        f"{dropped_bytes(setup[5], ops) / 2**20:.1f} MiB on the device")
    return ops, shard_problem(setup[6], slab), scfg, setup[2]


def shard_arms(label, x, y, m, lam_v, device, group, kernels):
    """The shard route's three x-update arms (ARMS: the spectral CG across
    ranks, xla_packed=False, spectral_cg=False) on a row group's slabs, each
    SHARD_ARM_ITERS admm_fixed_iterations from one warm state (ARMS_WARM
    default iterations from mvtv_sharded's start), under the caller's launch
    counters: ms per iteration (CUDA events), CG steps per iteration, the
    launches of kernels = (dual, residual, matvec) per run with their checks
    (the dual kernel once an iteration; the residual kernel once an
    iteration except under spectral_cg=False, which forms b and takes no
    r0 from it; the matvec only off the spectral CG), the roofline model's
    bound, and a SHARD_ARM_PROFILE-iteration run under the profiler (device
    time by kernel group, idle share).  Returns ({arm: (ms, steps, state)},
    (ops, problem, config, spec, warm))."""
    import dataclasses

    import torch
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import admm, xupdate

    ops, pr, scfg, spec = shard_inputs(x, y, m, None, device, group)
    lam = torch.tensor(lam_v, dtype=torch.float32, device=device)
    warm = admm.admm_fixed_iterations(ops, pr, lam, admm.initial_state(ops, pr, lam / 5), scfg,
                                      ARMS_WARM)
    layout = xupdate.spectral_layout(ops)
    dual, residual, matvec = kernels
    out = {}
    for name in ARMS:
        cfg = dataclasses.replace(scfg, **ARMS[name])
        held = {}

        def run(n=SHARD_ARM_ITERS):
            held["s"] = admm.admm_fixed_iterations(ops, pr, lam, warm, cfg, n)

        before = dict(K.launch_counts)
        ms = cuda_time_ms(run, 1, warmup=0) / SHARD_ARM_ITERS
        used = {k: K.launch_counts[k] - before[k] for k in kernels}
        state = held["s"]
        steps = (state.cg_iters - warm.cg_iters) / SHARD_ARM_ITERS
        x_update = {"default": "spectral", "xla_packed=False": "pcg",
                    "spectral_cg=False": "natural"}[name]
        rep = roofline().model_report(m, n_steps=max(1, round(steps)), layout=layout or "packed",
                                      x_update=x_update, ranks=group.size)
        log(f"  {label} {name}: {ms:.3f} ms per iteration (CUDA events, {SHARD_ARM_ITERS} "
            f"iterations from the warm state), {steps:.2f} CG steps per iteration, launches "
            f"{used}; model bound {1e3 / rep['model_bound_iters_per_s']:.3f} ms per iteration "
            f"({rep['x_update']}, {rep['layout']}), collectives per CG step "
            f"{rep['collectives_per_cg_step']} [{GPU_LINE}]")
        profile_iterations(f"{label} {name}", lambda: run(SHARD_ARM_PROFILE), SHARD_ARM_PROFILE,
                           ms)
        check(used[dual] == SHARD_ARM_ITERS, f"{label} {name}: {dual} launched once per "
              f"iteration ({used[dual]} in {SHARD_ARM_ITERS})")
        want_r0 = 0 if name == "spectral_cg=False" else SHARD_ARM_ITERS
        check(used[residual] == want_r0, f"{label} {name}: {residual} launched {want_r0} times "
              f"({used[residual]})")
        if name == "default":
            check(used[matvec] == 0, f"{label} {name}: {matvec} not launched ({used[matvec]})")
        else:
            check(used[matvec] > SHARD_ARM_ITERS, f"{label} {name}: {matvec} launched more than "
                  f"once per iteration ({used[matvec]} in {SHARD_ARM_ITERS})")
        check(bool(torch.all(torch.isfinite(state.theta))), f"{label} {name}: theta finite")
        out[name] = (ms, steps, state)
    return out, (ops, pr, scfg, spec, warm)


def check_shard_xupdate(label, I, group):
    """The one-rank spectral x-update (the shard route's, on the slab of a
    group of one) against the single card's tiled-route x-update on the
    same warm state I (ops, problem, state s: shard_arms's or
    cube_inputs's): within SHARD_XUPDATE_TOL of max|x - x0|, equal up to
    the float32 sums' order."""
    import torch
    from multivartv_tpu_torch import SolverConfig
    from multivartv_tpu_torch.parallel import fit as pfit
    from multivartv_tpu_torch.parallel.sharding import RowSlab
    from multivartv_tpu_torch.solver import xupdate

    ops, pr, s = I["ops"], I["problem"], I["s"]
    cfg = SolverConfig()
    scfg = pfit._sharded_solver_config(cfg, group)
    ops_s = pfit.shard_operators(ops, RowSlab(group, ops.m))
    counts = pr.counts
    cbar = torch.sum(counts) / ops.ntheta
    parts = (pr.oty, s.dta, s.u_scale, s.dtu)
    want, _ = xupdate._solve_tiled(ops, counts, cbar, None, s.rho, s.theta, cfg,
                                   xupdate.counts_to_layout(ops, counts, cfg), parts)
    got, steps = xupdate.solve_x(ops_s, counts, cbar, None, s.rho, s.theta, scfg, tiled=True,
                                 counts_blocked=xupdate.counts_to_layout(ops_s, counts, scfg),
                                 rhs_parts=parts)
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / (want - s.theta).abs().max())
    check(err <= SHARD_XUPDATE_TOL and steps == xupdate.n_fixed_steps(cfg),
          f"{label}: the one-rank shard route's spectral x-update ({xupdate.spectral_layout(ops)}"
          f", {steps} steps) against the single card's on the same warm state: max err "
          f"{err:.3e} of max|x - x0| <= {SHARD_XUPDATE_TOL:g}")
    del ops_s, got, want


def tensor_bytes(x) -> int:
    """Bytes of the tensors in x (a tensor, an Operators, nested tuples)."""
    import dataclasses

    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(tensor_bytes(v) for v in x)
    if dataclasses.is_dataclass(x):
        return sum(tensor_bytes(getattr(x, f.name)) for f in dataclasses.fields(x))
    return 0


def dropped_bytes(whole, cut) -> int:
    """Bytes of the whole Operators' fields that its cut (shard_operators)
    sets to None: what a sharded fit frees once it drops the whole set-up."""
    import dataclasses
    return sum(tensor_bytes(getattr(whole, f.name)) for f in dataclasses.fields(whole)
               if getattr(cut, f.name) is None and getattr(whole, f.name) is not None)


def time_iterations(label, ops, pr, lam, cfg, n_it):
    """ms per ADMM iteration of a route (admm_fixed_iterations from the
    initial state, CUDA events, the smaller of two runs) and its profile:
    device ms by kernel group, idle share."""
    import torch
    from multivartv_tpu_torch.solver import admm

    lam_t = torch.tensor(lam, dtype=torch.float32, device=pr.oty.device)
    state0 = admm.initial_state(ops, pr, lam_t / 5)

    def run():
        return admm.admm_fixed_iterations(ops, pr, lam_t, state0, cfg, n_it)

    ms = min(cuda_time_ms(run, 1, warmup=1), cuda_time_ms(run, 1, warmup=0)) / n_it
    log(f"  {label} ({admm.solve_route(ops, cfg)} route): {ms:.3f} ms per iteration "
        f"(admm_fixed_iterations, {n_it} iterations) [{GPU_LINE}]")
    profile_iterations(label, run, n_it, ms)
    return ms


def phase_sharded3(device, errs):
    """Phase 23, the seventh main path, under the launch counters: the
    sharded fit at p = 3 and p = 1 on one card, a row group of one NCCL
    rank (as phase 16's): mvtv_sharded(folds=1, SHARD3_LAMBDAS lambdas) at
    256^3 through B12s and B13s (the whole-lattice B12 and B13 not
    launched), its objective at the chosen lambda no worse than the
    tiled3 route's cold solve from the same start by LARGE_GAP;
    mvtv_sharded(folds=2) at 256 x 256 x 64, its chosen index in the tie set
    (MVTV_TIE3, C3's for this lattice and data) of the single-card
    mvtv(folds=2, vmap_folds=False) on the same grid; mvtv_sharded on the
    fused lasso at N = 2^20 (folds 1) against the "tridiag" route's cold
    solve at the chosen lambda (mvtv_one's solve, one-sided LARGE_GAP) and
    at N = 1e5 (folds 2) against the single-card mvtv's tie set (MVTV_TIE),
    both through T1; every solve on both sides capped (SHARD3_CAP,
    SHARD1_CAP); each fit's peak device memory (max_memory_allocated,
    reset before it) and, at p = 3, the live tensors of the lattice's
    shape and the eigenvalue sets' shares at its first ADMM solve (after
    the cut; a group of one's slab is the lattice); the shard route's three
    x-update arms at 256^3 (shard_arms).  The 256^3 fit runs the spectral
    CG across ranks: its objective is held against the single-card tiled3
    route's cold solve (the same algorithm; at the same cap it sits +2.8e-4
    from the exact route's on an H100, PERF.md section 6).  Then, launches
    not counted, ms per iteration of the
    shard route at 256^3 and 2^20 beside the single-card tiled3 and tridiag
    routes with the device's idle share (T1 once per iteration on the
    group of one), and B12s, B13s (fused, as the route calls it), the
    slab matvec and T1's segment mode beside their plain versions, B13s
    and the matvec first held against them at 256^3 (1e-5 x max(1, |ref|),
    their largest absolute errors recorded in errs), and the one-rank
    spectral x-update against the single card's on the same warm state
    (check_shard_xupdate).  Returns (launches, {kernel: (ms, plain_ms, m,
    bound kwargs)})."""
    import tempfile
    from contextlib import nullcontext

    import torch
    import torch.distributed as dist
    from multivartv_tpu_torch import CVConfig, SolverConfig, mvtv
    from multivartv_tpu_torch.api import _fresh_solve, _setup
    from multivartv_tpu_torch.config import DEFAULT_MESH
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.parallel import distributed
    from multivartv_tpu_torch.parallel import fit as pfit
    from multivartv_tpu_torch.parallel.sharding import make_device_mesh
    from multivartv_tpu_torch.utils.profiling import solve_census

    log("phase 23: the sharded fit at p = 3 (plane slabs) and p = 1 (chain segments) on one "
        "card (a row group of one NCCL rank), counters reset")
    t_phase = time.perf_counter()
    cap3, cap1 = SolverConfig(max_iters=SHARD3_CAP), SolverConfig(max_iters=SHARD1_CAP)
    fits3 = {name: (CUBES[name][0](), CUBES[name][1]) for name in (SHARD3_FIT1, SHARD3_FIT2)}
    fits1 = {n: fused_lasso_data(n) for n, _ in SHARD1_FITS}
    models, seconds, used = {}, {}, {}
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        distributed.init_distributed(f"file://{tmp}/store", world_size=1, rank=0, device=device)
        try:
            group = make_device_mesh()
            K.reset_launch_counts()
            runs = [(SHARD3_FIT1, fits3[SHARD3_FIT1], 1, SHARD3_LAMBDAS, None, cap3),
                    (SHARD3_FIT2, fits3[SHARD3_FIT2], 2, SHARD3_LAMBDAS, None, cap3)]
            runs += [(f"fused lasso N={n}", (fits1[n], (n,)), folds, SHARD1_LAMBDAS,
                      fits1[n][0][:, None], cap1) for n, folds in SHARD1_FITS]
            for label, ((x, y), m), folds, n_lambda, mesh, cfg in runs:
                before = dict(K.launch_counts)
                # At the fit's first solve, after the cut (at p = 1 the
                # samples' arrays have the chain's shape: no census).
                census = solve_census(m, first_only=True) if len(m) == 3 else nullcontext(
                    ([], [0.0]))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with census as (seen, t_census):
                    models[label] = pfit.mvtv_sharded(x, y, m=m, mesh=mesh, folds=folds,
                                                      n_lambda=n_lambda, solver_config=cfg,
                                                      device=device)
                torch.cuda.synchronize()
                seconds[label] = time.perf_counter() - t0 - t_census[0]
                peak = torch.cuda.max_memory_allocated() / 2**30
                log(f"  mvtv_sharded {label}: peak device memory {peak:.3f} GiB "
                    f"(max_memory_allocated, reset before the fit) [{GPU_LINE}]")
                if seen:
                    (n_t, nbytes, shares), = seen
                    log(f"  mvtv_sharded {label}: {n_t} live tensors of the lattice's shape at "
                        f"its first ADMM solve, after the cut ({nbytes / 2**30:.3f} GiB in "
                        f"distinct storages; one rank's slab is the whole lattice; census "
                        f"{t_census[0]:.2f} s, not in the fit's time); the solve's eigenvalue "
                        f"sets as shares of the whole lattice's {shares}")
                used[label] = {k: K.launch_counts[k] - before[k] for k in K.KERNELS
                               if K.launch_counts[k] != before[k]}
                mdl = models[label]
                log(f"  mvtv_sharded {label} folds={folds} n_lambda={n_lambda} (cap "
                    f"{cfg.max_iters}): {seconds[label]:.2f} s [{GPU_LINE}], chosen index "
                    f"{mdl.lambda_minmse_ind}, iterations per lambda "
                    f"{[mm['iters'] for mm in mdl.models]}, CV curve "
                    f"{[float(f'{v:.8g}') for v in mdl.cv_mses]}, launches {used[label]}")
            log("phase 23: the shard route's x-update arms at 256^3")
            (x, y), m = fits3[SHARD3_FIT1]
            arms, (ops, pr, scfg, spec, warm) = shard_arms(
                f"{SHARD3_FIT1} shard route", x, y, m, 0.05, device, group, SHARD3)
            launches = dict(K.launch_counts)
            del ops, pr, warm, arms

            log("phase 23: ms per iteration, the shard route beside the single-card routes")
            (x, y), m = fits3[SHARD3_FIT1]
            ops, pr, scfg, _ = shard_inputs(x, y, m, None, device, group)
            times["iter shard 256^3"] = time_iterations(f"{SHARD3_FIT1} sharded (one rank)", ops,
                                                        pr, 0.05, scfg, SHARD3_ITERS)
            del ops, pr
            _, _, _, _, _, ops, pr = _setup(x, y, m, None, SolverConfig(), DEFAULT_MESH, device)
            times["iter tiled3 256^3"] = time_iterations(f"{SHARD3_FIT1} single card", ops, pr,
                                                         0.05, SolverConfig(), SHARD3_ITERS)
            del ops, pr
            n1 = FUSED_ONE
            (x, y) = fits1[n1]
            ops, pr, scfg, _ = shard_inputs(x, y, (n1,), x[:, None], device, group)
            before = dict(K.launch_counts)
            times["iter shard 2^20"] = time_iterations("fused lasso N=2^20 sharded (one rank)",
                                                       ops, pr, 1.0, scfg, SHARD1_ITERS)
            t1_calls = K.launch_counts["xupdate_tridiag"] - before["xupdate_tridiag"]
            seg_calls = (K.launch_counts["xupdate_tridiag_segment"]
                         - before["xupdate_tridiag_segment"])
            runs_made = t1_calls // SHARD1_ITERS
            check(t1_calls == runs_made * SHARD1_ITERS and runs_made >= 2 and seg_calls == 0,
                  f"fused lasso N=2^20 on the shard route (one rank): T1 launched once per "
                  f"iteration ({t1_calls} in {runs_made} runs of {SHARD1_ITERS}), its segment "
                  f"mode never ({seg_calls})")
            del ops, pr
            _, _, _, _, _, ops, pr = _setup(x, y, (n1,), x[:, None], SolverConfig(),
                                            DEFAULT_MESH, device)
            times["iter tridiag 2^20"] = time_iterations("fused lasso N=2^20 single card", ops,
                                                         pr, 1.0, SolverConfig(), SHARD1_ITERS)
            del ops, pr
        finally:
            dist.destroy_process_group()
    log(f"  shard route / single-card route per iteration: 256^3 "
        f"{times['iter shard 256^3'] / times['iter tiled3 256^3']:.2f}x, N=2^20 "
        f"{times['iter shard 2^20'] / times['iter tridiag 2^20']:.2f}x [{GPU_LINE}]")

    log("phase 23: the fits against their single-card comparisons (the same caps)")
    l3a, l3b = SHARD3_FIT1, SHARD3_FIT2
    ua = used[l3a]
    for k in SHARD3:
        check(launches[k] > 0, f"phase 23 launched {k} ({launches[k]} times)")
    for k in SHARD3[:2]:
        check(ua.get(k, 0) > 0, f"mvtv_sharded {l3a}: {k} launched ({ua.get(k, 0)} times)")
    check(not ua.get("dual_update_tiled_3d") and not ua.get("gram_residual_tiled_3d"),
          f"mvtv_sharded {l3a}: the whole-lattice B12 and B13 not launched "
          f"({ua.get('dual_update_tiled_3d', 0)}, {ua.get('gram_residual_tiled_3d', 0)})")
    for label, mdl in models.items():
        check(bool(np.all(np.isfinite(mdl.theta_lattice)))
              and bool(np.all(np.isfinite(mdl.cv_mses))), f"mvtv_sharded {label}: finite")

    def cold(label, mesh, cfg):
        """objective64 of a single-card cold solve at the fit's chosen
        lambda from its start (rho0 = lambda_0 / 5), and the fit's own."""
        mdl = models[label]
        (x, y), m = (fits3[label] if label in fits3
                     else (fits1[int(label.split("=")[1])], mdl.mesh_spec.m))
        best = mdl.lambda_minmse_ind
        _, _, spec, _, _, ops, problem = _setup(x, y, m, mesh, cfg, DEFAULT_MESH, device)
        grid = torch.as_tensor(mdl.lambdas, device=device)
        theta, fitted = _fresh_solve(ops, problem, grid[best], grid[0] / 5.0, cfg)
        ref = objective64({"theta_lattice": theta.cpu().numpy(),
                           "fitted": fitted.cpu().numpy(), "y": y, "mesh_spec": spec,
                           "lambda": float(grid[best])})
        return model_objective(mdl), ref

    t0 = time.perf_counter()
    obj, ref = cold(l3a, None, SolverConfig(max_iters=SHARD3_CAP))
    gap = (obj - ref) / abs(ref)
    log(f"  mvtv_sharded {l3a} at the chosen lambda: objective {obj:.9e} vs the tiled3 route's "
        f"cold solve {ref:.9e} ({time.perf_counter() - t0:.2f} s)")
    check(gap <= LARGE_GAP, f"mvtv_sharded {l3a}: objective at the chosen lambda (shard - "
          f"tiled3: the spectral CG on both) / |tiled3| {gap:+.3e} <= {LARGE_GAP:g}")

    def ties_of(label, cfg, tie, mesh=None):
        mdl = models[label]
        (x, y), m = (fits3[label] if label in fits3
                     else (fits1[int(label.split("=")[1])], mdl.mesh_spec.m))
        t0 = time.perf_counter()
        single = mvtv(x, y, m=m, mesh=mesh, lambdas=mdl.lambdas, folds=2, device=device,
                      solver_config=cfg, cv_config=CVConfig(folds=2, vmap_folds=False))
        torch.cuda.synchronize()
        cvm = np.asarray(single.cv_mses, np.float64)
        ties = np.nonzero(cvm <= cvm.min() * (1 + tie))[0].tolist()
        log(f"  single-card mvtv {label} folds=2 (vmap_folds=False, cap {cfg.max_iters}), same "
            f"grid: {time.perf_counter() - t0:.2f} s, chosen index {single.lambda_minmse_ind}, "
            f"tie set {ties}, CV curve {[float(f'{v:.8g}') for v in single.cv_mses]}")
        check(mdl.lambda_minmse_ind in ties, f"mvtv_sharded {label} folds=2: chosen index "
              f"{mdl.lambda_minmse_ind} in the single-card fit's tie set {ties} (CV MSE within "
              f"{tie:g} of its minimum)")

    ties_of(l3b, cap3, MVTV_TIE3)
    (n_a, _), (n_b, _) = SHARD1_FITS
    la, lb = f"fused lasso N={n_a}", f"fused lasso N={n_b}"
    for label in (la, lb):
        check(used[label].get("xupdate_tridiag", 0) > 0
              and not used[label].get("xupdate_tridiag_segment")
              and not used[label].get("partition_finish"),
              f"mvtv_sharded {label}: T1 launched ({used[label].get('xupdate_tridiag', 0)} "
              "times), on the whole chain of the group of one")
    obj, ref = cold(la, fits1[n_a][0][:, None], cap1)
    gap = (obj - ref) / abs(ref)
    log(f"  mvtv_sharded {la} at the chosen lambda: objective {obj:.9e} vs the tridiag route's "
        f"cold solve {ref:.9e}")
    check(gap <= LARGE_GAP, f"mvtv_sharded {la}: objective at the chosen lambda (shard - "
          f"tridiag) / |tridiag| {gap:+.3e} <= {LARGE_GAP:g}")
    ties_of(lb, cap1, MVTV_TIE, mesh=fits1[n_b][0][:, None])

    log("phase 23: B12s, B13s and T1's segment mode beside their plain versions")
    I = cube_inputs(SHARD3_FIT1, device)
    check_shard_xupdate("256^3", I, group)
    ops, pr, s, m = I["ops"], I["problem"], I["s"], I["m"]
    sc, kappa = ops.scales, I["lam"] / s.rho
    tops, bots = plane_halos((s.theta, *s.u), 0, m[0])
    dual = (s.theta, s.u, tops, bots, 0, m[0], kappa, sc, s.u_scale, None, True, False)
    parts = (pr.oty, s.dta, s.u_scale, s.dtu)
    gram = (None, s.theta, tops[0], bots[0], 0, m[0], pr.counts, s.rho, sc)
    mv = (s.theta, tops[0], bots[0], 0, m[0], pr.counts, s.rho, sc)
    cases = {
        "dual_update_tiled_3d_shard": (lambda: K.dual_update_tiled_3d_shard(*dual),
                                       lambda: K.dual_update_tiled_3d_shard_reference(*dual),
                                       {}),
        "gram_residual_tiled_3d_shard": (
            lambda: K.gram_residual_tiled_3d_shard(*gram, rhs_parts=parts),
            lambda: K.gram_residual_tiled_3d_shard_reference(*gram, rhs_parts=parts),
            {"fused": True}),
        "gram_matvec_tiled_3d_shard": (lambda: K.gram_matvec_tiled_3d_shard(*mv),
                                       lambda: K.gram_matvec_tiled_3d_shard_reference(*mv), {}),
    }
    for k in ("gram_residual_tiled_3d_shard", "gram_matvec_tiled_3d_shard"):
        got, ref = cases[k][0](), cases[k][1]()
        torch.cuda.synchronize()
        e = rel_err(got, ref)
        errs[k] = max(errs.get(k, 0.0), float((got.double() - ref.double()).abs().max()))
        check(e <= 1e-5, f"{k} {'x'.join(map(str, m))} one-rank slab (the fit's launch shape, "
              f"its warm state): vs its plain version, max err {e:.3e} <= 1e-5 x max(1, |ref|)")
        del got, ref
    for k, (kern, plain, kw) in cases.items():
        p1 = cuda_time_ms(plain, 3)
        k_ms = time_call(k, f"{'x'.join(map(str, m))} one-rank slab", kern, m, **kw)
        p2 = cuda_time_ms(plain, 3)
        times[k] = (k_ms, min(p1, p2), m, kw)
        log(f"  {k}: plain {p1:.4f} / {p2:.4f} ms [{GPU_LINE}]")
    del I, s, dual, gram, mv, parts, tops, bots
    torch.cuda.empty_cache()
    n_seg = FUSED_ONE // 4
    counts, b = tridiag_inputs(n_seg, 43, device)
    rho = torch.tensor(0.5, dtype=torch.float32, device=device)
    seg = (counts, b, rho, 1.0, True, True)
    p1 = cuda_time_ms(lambda: K.xupdate_tridiag_segment_reference(*seg), 3)
    k_ms = time_call("xupdate_tridiag_segment", f"n={n_seg} (one of 4 segments of 2^20)",
                     lambda: K.xupdate_tridiag_segment(*seg), (n_seg,), n=50)
    p2 = cuda_time_ms(lambda: K.xupdate_tridiag_segment_reference(*seg), 3)
    times["xupdate_tridiag_segment"] = (k_ms, min(p1, p2), (n_seg,), {})
    log(f"  xupdate_tridiag_segment: plain {p1:.4f} / {p2:.4f} ms; T1 on the whole 2^20 chain "
        f"for scale in phase 21 [{GPU_LINE}]")
    ylr = K.xupdate_tridiag_segment(*seg)
    every = torch.cat([torch.randn(4, 6, generator=torch.Generator().manual_seed(44)) * 0.1,
                       torch.full((4, 1), 0.5)], 1).to(device)
    fin = (every, 1, 1.0, ylr)
    p1 = cuda_time_ms(lambda: K.partition_finish_reference(*fin), 3)
    k_ms = time_call("partition_finish", f"n={n_seg}, rank 1 of 4",
                     lambda: K.partition_finish(*fin), (n_seg,), n=50)
    p2 = cuda_time_ms(lambda: K.partition_finish_reference(*fin), 3)
    times["partition_finish"] = (k_ms, min(p1, p2), (n_seg,), {})
    log(f"  partition_finish: plain (dense float64 solve_ex, back-substitution) {p1:.4f} / "
        f"{p2:.4f} ms [{GPU_LINE}]")
    log(f"phase 23: {time.perf_counter() - t_phase:.1f} s")
    return launches, {k: v for k, v in times.items() if not k.startswith("iter ")}


# ---------------------------------------------------------------------------
# Phase 24: the sharded fit across four cards
# ---------------------------------------------------------------------------

# Phase 24 (run only when listed, on a machine with SHARD4_WORLD cards):
# SHARD4_WORLD worker processes, one card and one NCCL rank each, run the
# fits of SHARD4_FITS through mvtv_sharded, and the parent first runs each
# fit's witness on card 0 as a group of one with the same data, grid and
# caps.  label -> (data (kind, n), m, the mesh is the samples' x (p = 1),
# folds, n_lambda, SolverConfig overrides, the workers' mesh shape, the
# witness's label (None: its own)):
#   (a) 2048^2 on bench.py's data at n = 2^20, the default arm: B8s, B9s
#       with halos from other cards, the spectral CG's all_to_alls;
#   (b) 256^3 (plane slabs of 64), the default arm and xla_packed=False: B12s,
#       B13s and the slab matvec (the exact PCG's) with halo planes;
#   (c) the fused lasso at N = 2^20 (m = N, mesh = x): T1's segment mode, the
#       all_gather of the segments' end values and partition_finish; its
#       witness runs T1 on the whole chain;
#   (d) 1024^2, 4 folds over dp = 4 (sx = 1: one fold a card, no lattice
#       collective), and (e) the same fit on dp = 2 x sx = 2, held against (d);
#       both on the exact arm (xla_packed=False), whose sums across ranks
#       differ from one card's in order only: under the default arm's bf16
#       spectral CG, slabs on two ranks moved a fold's held-out MSEs 4.0e-4
#       from one rank's (a CPU rehearsal at 64^2, 100 iterations a solve),
#       the rounding of the spectral CG across ranks, not the fold axis;
#       and on one card that arm's CV curve at 1024^2 holds its two lowest
#       points 3.3e-4 apart, inside that rounding, so its chosen index is no
#       stable gate there.
# The caps keep the phase near 600 s: near lambda_max every route runs to its
# cap, and the 2-D sharded iteration is host-bound (~45 ms on one card).
SHARD4_WORLD = 4
SHARD4_FITS = {
    "(a) 2048^2": (("bench", 1 << 20), (2048, 2048), False, 1, 3, {"max_iters": 200},
                   (1, 4, 1), None),
    "(b) 256^3": (("cube", 1 << 22), (256, 256, 256), False, 1, 2, {"max_iters": 60},
                  (1, 4, 1), None),
    "(b) 256^3 xla_packed=False": (("cube", 1 << 22), (256, 256, 256), False, 1, 2,
                                   {"max_iters": 60, "xla_packed": False}, (1, 4, 1), None),
    "(c) fused lasso N=2^20": (("fused", FUSED_ONE), (FUSED_ONE,), True, 1, 3,
                               {"max_iters": FUSED_CAP}, (1, 4), None),
    "(d) 1024^2 dp=4": (("bench", 1 << 20), (1024, 1024), False, 4, 3,
                        {"max_iters": 100, "xla_packed": False}, (4, 1, 1), None),
    "(e) 1024^2 dp=2 sx=2": (("bench", 1 << 20), (1024, 1024), False, 4, 3,
                             {"max_iters": 100, "xla_packed": False}, (2, 2, 1),
                             "(d) 1024^2 dp=4"),
}
# The ms per iteration of (a)-(c) on 4 ranks and on 1: SHARD_ARM_ITERS
# admm_fixed_iterations from one warm state (ARMS_WARM iterations from the
# start) at lambda, the fit's arm (the exact one for the slab matvec, which
# only it launches), and SHARD_ARM_PROFILE under the profiler.  label ->
# (fit of SHARD4_FITS, lambda).
SHARD4_TIMED = {"p = 2 2048^2": ("(a) 2048^2", 0.05), "p = 3 256^3": ("(b) 256^3", 0.05),
                "p = 3 256^3 xla_packed=False": ("(b) 256^3 xla_packed=False", 0.05),
                "p = 1 N=2^20": ("(c) fused lasso N=2^20", 1.0)}
# The gates: (a) and (b) against their witnesses as tests/test_torch_shard_c7.py
# holds two ranks against one device (the lambda grid 1e-5, the per-lambda
# MSEs 1e-4, the chosen index) with the objective at every lambda within
# SHARD4_OBJ relative; (c) the objective at the chosen lambda (the CPU tests'
# gate: the partition solve against T1 on the whole chain); (d) each fold's
# held-out MSEs within SHARD4_FOLD relative of the witness's fold solves (the
# same code on identical cards, a row group of one each) and the same chosen
# index; (e) each fold's within SHARD4_FOLD_E of (d)'s (its folds run on
# slabs of two cards) and its chosen index in (d)'s tie set (MVTV_TIE).
SHARD4_OBJ = 1e-5
SHARD4_FOLD = 1e-6
SHARD4_FOLD_E = 1e-4
SHARD4_TIMEOUT = 1200.0    # seconds for the workers in all, then killed


def shard4_data(kind: str, n: int):
    return {"bench": bench_data, "cube": cube_data, "fused": fused_lasso_data}[kind](n)


def shard4_fit(label, spec, device, mesh_shape=None):
    """One fit of SHARD4_FITS: mvtv_sharded on the row group of
    make_device_mesh(mesh_shape) (None: the default group, here a group of
    one), under the launch counters and a spy on the fold solves' held-out
    MSEs and on the pencil transposes (the spectral CG's all_to_alls).
    Returns host numbers: seconds, lambdas, per-lambda MSEs, the chosen
    index, iterations per lambda, the objective at every lambda (objective64,
    float64), the folds this rank solved and their MSEs, the launches, the
    transposes made and a digest of the model's arrays."""
    import torch
    from multivartv_tpu_torch import SolverConfig
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.parallel import fit as pfit
    from multivartv_tpu_torch.parallel import halo
    from multivartv_tpu_torch.parallel.sharding import make_device_mesh
    from multivartv_tpu_torch.solver import cv

    (kind, n), m, mesh_is_x, folds, n_lambda, cfg, _, _ = spec
    x, y = shard4_data(kind, n)
    mesh = x[:, None] if mesh_is_x else None
    group = None
    if mesh_shape is not None:
        names = ("dp", "sx") if len(m) == 1 else ("dp", "sx", "sy")
        group = make_device_mesh(mesh_shape, names)
    seen, moves = [], {"to_pencils": 0, "to_slabs": 0}
    orig = (cv.cross_validate, halo.to_pencils, halo.to_slabs)

    def cross_validate(*a, **kw):
        res = orig[0](*a, **kw)
        seen.append(res.fold_test_mse.double().cpu().numpy())
        return res

    def counted(name, fn):
        def run(*a, **kw):
            moves[name] += 1
            return fn(*a, **kw)
        return run

    cv.cross_validate = cross_validate
    halo.to_pencils = counted("to_pencils", orig[1])
    halo.to_slabs = counted("to_slabs", orig[2])
    before = dict(K.launch_counts)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = pfit.mvtv_sharded(x, y, m=m, mesh=mesh, folds=folds, n_lambda=n_lambda,
                                  device_mesh=group, solver_config=SolverConfig(**cfg),
                                  device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        cv.cross_validate, halo.to_pencils, halo.to_slabs = orig
    per = folds // (1 if group is None or group.fold is None else group.fold.size)
    first = 0 if group is None or group.fold is None else group.fold.rank * per
    oty = None
    if group is not None and group.fold is not None:
        # Each row group bins the whole problem on its own card: O'y's digest.
        from multivartv_tpu_torch.api import _setup
        from multivartv_tpu_torch.config import DEFAULT_MESH
        oty = digest(_setup(x, y, m, mesh, SolverConfig(**cfg), DEFAULT_MESH, device)[6].oty)
    h = hashlib.sha256()
    for a in (model.lambdas, model.cv_mses, model.theta_lattice, model.fitted):
        h.update(np.ascontiguousarray(a).tobytes())
    return {"seconds": seconds, "lambdas": np.asarray(model.lambdas, np.float64),
            "cv_mses": np.asarray(model.cv_mses, np.float64),
            "best": int(model.lambda_minmse_ind),
            "iters": [int(mm["iters"]) for mm in model.models],
            "objective": [model_objective(model, i) if i == model.lambda_minmse_ind
                          or "theta_hat" in model.models[i] else float("nan")
                          for i in range(len(model.models))],
            "folds": list(range(first, first + per)) if folds > 1 else [],
            "fold_mse": seen[0] if seen else None,
            "launches": {k: K.launch_counts[k] - before[k] for k in K.KERNELS
                         if K.launch_counts[k] != before[k]},
            "moves": dict(moves), "digest": h.hexdigest()[:16], "oty": oty,
            "finite": bool(np.all(np.isfinite(model.theta_lattice))
                           and np.all(np.isfinite(model.cv_mses)))}


def device_spans(run) -> tuple:
    """torch.profiler over run() (one recorded step after a dropped warm-up
    step): (the union of every CUDA kernel's [start, end] interval, the
    union of the NCCL kernels', the union of the others', their span from
    the first start to the last end, the summed time by kernel group), in
    ms.  Kernels on several streams overlap (NCCL's run on their own, and
    spin while they wait for the other ranks), so the union, not the sum,
    is the time the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _step in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    spans, groups = [], {}
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA") or e.name.startswith(
                "ProfilerStep"):
            continue
        a, b = e.time_range.start, e.time_range.end
        if b > a:
            spans.append((a, b, "nccl" in e.name.lower()))
            g = _profile_group(e.name)
            groups[g] = groups.get(g, 0.0) + (b - a) / 1e3

    def union(items) -> float:
        total, end = 0.0, None
        for a, b in sorted(items):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e3

    if not spans:
        return 0.0, 0.0, 0.0, 0.0, {}
    return (union((a, b) for a, b, _ in spans), union((a, b) for a, b, n in spans if n),
            union((a, b) for a, b, n in spans if not n),
            (max(b for _, b, _ in spans) - min(a for a, _, _ in spans)) / 1e3, groups)


def shard4_iterations(label, spec, lam, device, group):
    """SHARD_ARM_ITERS admm_fixed_iterations of the shard route on this rank's
    slab from one warm state (ARMS_WARM iterations from the start), on the
    fit's x-update arm: ms per iteration (CUDA events; every rank's run is one run,
    the collectives keeping them in step), the launches per iteration, and a
    SHARD_ARM_PROFILE-iteration profile (device_spans), per iteration: the
    union of every kernel's intervals, the NCCL kernels' union (transfers,
    and spin-waits while the other ranks' hosts enqueue), the other
    kernels' union (the compute) and the idle share, 1 - compute / the
    CUDA-event time, and the summed kernel time by group."""
    import torch
    from multivartv_tpu_torch.ops import kernels as K
    from multivartv_tpu_torch.solver import admm

    (kind, n), m, mesh_is_x, _, _, cfg, *_ = spec
    x, y = shard4_data(kind, n)
    arm = {k: v for k, v in cfg.items() if k != "max_iters"}
    ops, pr, scfg, _ = shard_inputs(x, y, m, x[:, None] if mesh_is_x else None, device, group,
                                    **arm)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=device)
    warm = admm.admm_fixed_iterations(ops, pr, lam_t, admm.initial_state(ops, pr, lam_t / 5),
                                      scfg, ARMS_WARM)

    def run(n_it=SHARD_ARM_ITERS):
        admm.admm_fixed_iterations(ops, pr, lam_t, warm, scfg, n_it)

    run(2)
    before = dict(K.launch_counts)
    ms = cuda_time_ms(run, 1, warmup=0) / SHARD_ARM_ITERS
    launches = {k: (K.launch_counts[k] - before[k]) / SHARD_ARM_ITERS for k in K.KERNELS
                if K.launch_counts[k] != before[k]}
    busy, nccl, compute, span, groups = (v / SHARD_ARM_PROFILE if isinstance(v, float)
                                         else {k: t / SHARD_ARM_PROFILE for k, t in v.items()}
                                         for v in device_spans(lambda: run(SHARD_ARM_PROFILE)))
    return {"ms": ms, "launches": launches, "groups": groups, "busy": busy, "nccl": nccl,
            "compute": compute, "span": span,
            "idle": max(0.0, 1 - compute / ms) if busy else float("nan")}


def shard4_collectives(device, world: int) -> dict:
    """Each collective of the sharded fit once on small tensors, on the row
    and fold groups of a (2, world / 2, 1) mesh and on the world: the halo
    rows (batch_isend_irecv), the pencil transposes with uneven splits
    (all_to_all_single), the padded gather of the slabs and the partition
    solve's all_gather (all_gather), a group sum, the gather of the fold
    axis and the broadcast of the lambda grid.  Every rank builds the same
    9 x 7 lattice, offset by its dp index, so each result is known: the
    largest absolute error of each."""
    import torch
    from multivartv_tpu_torch.parallel import halo
    from multivartv_tpu_torch.parallel.fit import _broadcast
    from multivartv_tpu_torch.parallel.sharding import RowSlab, make_device_mesh

    mesh = make_device_mesh((2, world // 2, 1), ("dp", "sx", "sy"))
    slab = RowSlab(mesh, (9, 7))
    full = (torch.arange(63, dtype=torch.float32, device=device).reshape(9, 7)
            + 100.0 * mesh.fold.rank)
    mine = slab.rows(full)
    lo, hi = slab.row_off, slab.row_off + slab.shape[0]
    zero = torch.zeros(1, 7, device=device)
    top, bot = halo.halo_pair(mine, mesh)
    err = {"halo": max(float((top - (full[lo - 1:lo] if lo > 0 else zero)).abs().max()),
                       float((bot - (full[hi:hi + 1] if hi < 9 else zero)).abs().max())),
           "to_pencils": float((halo.rows_to_cols(mine, slab) - slab.cols(full)).abs().max()),
           "to_slabs": float((halo.cols_to_rows(slab.cols(full), slab) - mine).abs().max()),
           "gather_rows": float((halo.gather_rows(mine, slab) - full).abs().max()),
           "psum": float((halo.psum(mine.sum().reshape(1), mesh) - full.sum()).abs().max())}
    blocks = halo.gather_folds(torch.full((1, 3), float(mesh.fold.rank), device=device),
                               mesh.fold)
    err["gather_folds"] = float((blocks[:, 0] - torch.arange(2, device=device)).abs().max())
    grid = _broadcast(torch.full((3,), float(mesh.world.rank + 1), device=device), mesh.world)
    err["broadcast"] = float((grid - 1.0).abs().max())
    return err


def shard4_latency(device, world: int) -> dict:
    """ms per call of the sharded fit's collectives at the sizes an
    iteration gives them, on the row layout of the whole world and on the
    row group of a (2, world / 2, 1) mesh: {name: (CUDA-event ms per call,
    host us per call)}, each over 100 calls after 10 (the host's: the
    enqueue of 100 calls, then one synchronize)."""
    import torch
    from multivartv_tpu_torch.parallel import halo
    from multivartv_tpu_torch.parallel.sharding import RowSlab, make_device_mesh

    row = make_device_mesh((1, world, 1), ("dp", "sx", "sy"))
    sub = make_device_mesh((2, world // 2, 1), ("dp", "sx", "sy"))
    slab = RowSlab(row, (2048, 2048))
    v = torch.ones(slab.shape, device=device)
    sums = torch.ones(5, device=device)
    ends = torch.ones(7, device=device)
    cases = {
        "all_reduce of 5 floats, world": lambda: halo.psum(sums, row),
        "all_reduce of 5 floats, row group of 2": lambda: halo.psum(sums, sub),
        "halo rows, 3 x 2048 floats a side, world": lambda: halo.halo_rows(row, [v, v, v]),
        "halo knot, 1 float a side, world": lambda: halo.halo_rows(row, [sums]),
        "to_pencils of a 512 x 2048 slab, world": lambda: halo.to_pencils(
            [v], row, slab.row_counts, slab.col_counts),
        "all_gather of 7 floats, world": lambda: halo.gather_folds(ends[None], row),
    }
    out = {}
    for name, fn in cases.items():
        ms = cuda_time_ms(fn, 100, warmup=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host_us = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
        out[name] = (ms, host_us)
    return out


def shard4_rank(rank: int, world: int, store: str, queue, fits: dict, timed: dict,
                rehearse: bool = False) -> None:
    """A worker of phase 24: card `rank` (the CPU and gloo when rehearse),
    an NCCL rank of a world of `world`; every fit of `fits` on its mesh
    (counters reset before the first), then the iterations of `timed` on
    the row layout of the whole world.  Puts ("ok", rank, results) or
    ("error", rank, traceback) on the queue."""
    import traceback

    global QUIET, GPU_LINE
    QUIET = rank != 0
    if not fits and rank == 0:
        import os
        os.environ.setdefault("NCCL_DEBUG", "INFO")     # the probe: NCCL's transports
    import torch
    import torch.distributed as dist
    if rehearse:
        rehearse_on_cpu()
        device = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        torch.backends.cuda.matmul.allow_tf32 = False     # as phase_device sets them
        torch.backends.cudnn.allow_tf32 = False
        lines = all_gpu_lines()
        GPU_LINE = lines[rank] if rank < len(lines) else lines[0]
    try:
        from multivartv_tpu_torch.ops import kernels as K
        from multivartv_tpu_torch.parallel import distributed
        from multivartv_tpu_torch.parallel.fit import default_lattice_mesh

        distributed.init_distributed(f"file://{store}", world_size=world, rank=rank,
                                     device=device)
        one = torch.ones(4, device=device)
        dist.all_reduce(one)
        out = {"backend": dist.get_backend(), "all_reduce": float(one[0]),
               "device": str(device), "fits": {}, "timed": {},
               "collectives": shard4_collectives(device, world),
               "latency": shard4_latency(device, world) if not fits else {}}
        K.reset_launch_counts()
        for label, spec in fits.items():
            log(f"  [rank 0 of {world}] {label} on the mesh {spec[6]}")
            out["fits"][label] = shard4_fit(label, spec, device, spec[6])
            torch.cuda.empty_cache()
        out["launches"] = dict(K.launch_counts)
        for label, (name, lam) in timed.items():
            spec = fits[name]
            group, _ = default_lattice_mesh(len(spec[1]))
            out["timed"][label] = shard4_iterations(label, spec, lam, device, group)
            torch.cuda.empty_cache()
        queue.put(("ok", rank, out))
    except Exception:
        queue.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def rehearse_on_cpu() -> None:
    """The CPU rehearsal's stand-ins for the card's timing calls (a worker
    of phase 24 run with rehearse=True): synchronize does nothing and
    cuda_time_ms takes the wall clock."""
    import torch

    def wall_ms(fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    torch.cuda.synchronize = lambda *a, **kw: None
    globals()["cuda_time_ms"] = wall_ms


def shard4_workers(fits: dict, timed: dict, world: int = SHARD4_WORLD,
                   rehearse: bool = False) -> dict:
    """Spawn `world` workers (shard4_rank), wait for each one's results up to
    SHARD4_TIMEOUT in all, and stop every one of them: {rank: results}.  A
    worker that fails, or the time running out, ends the wait at once; its
    traceback is logged and the phase's check fails."""
    import queue as queue_lib
    import tempfile

    import torch
    ctx = torch.multiprocessing.get_context("spawn")
    results, errors = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        q = ctx.Queue()
        procs = [ctx.Process(target=shard4_rank,
                             args=(r, world, f"{tmp}/store", q, fits, timed, rehearse))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + SHARD4_TIMEOUT
        try:
            while len(results) < world and not errors:
                try:
                    status, rank, out = q.get(timeout=max(1.0, deadline - time.perf_counter()))
                except queue_lib.Empty:
                    errors.append(f"no result from ranks {sorted(set(range(world)) - set(results))}"
                                  f" within {SHARD4_TIMEOUT:g} s")
                    break
                if status == "ok":
                    results[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 5)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            q.close()
    for e in errors:
        log(f"  phase 24 worker failure: {e}")
    check(not errors and len(results) == world, f"phase 24: all {world} workers returned "
          f"their results ({len(results)} did; exit codes {[p.exitcode for p in procs]})")
    return results


def all_gpu_lines() -> list:
    """nvidia-smi's name and power limit of every card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return [f"nvidia-smi unavailable ({exc})"]


def phase_sharded4(device, fits: dict = None, timed: dict = None, world: int = SHARD4_WORLD,
                   rehearse: bool = False) -> dict:
    """Phase 24 (run only when listed): the sharded fit across SHARD4_WORLD
    cards, one NCCL rank a card, every collective between cards (halo rows
    and planes, the spectral CG's all_to_alls, the group sums, the
    partition solve's all_gather, the fold axis's sub-groups and its
    all_gather).  With fewer cards its first check fails (never skipped).
    The witnesses first, on card 0 as a group of one NCCL rank (the same
    data, grid and caps): each fit of SHARD4_FITS with its own witness, and
    SHARD4_TIMED's iterations on one rank; then the workers (shard4_workers)
    run every fit and SHARD4_TIMED on 4 ranks.  Checks (SHARD4_OBJ, ...):
    each fit against its witness, every rank's model the same (a digest of
    its arrays), B8s and B9s launched in (a), B12s and B13s in (b) and the
    slab matvec under xla_packed=False, T1's segment mode and
    partition_finish in (c) and T1 on the whole chain not, the pencil
    transposes in (a) and (b)'s default arm, the backend NCCL.  Prints
    every fit's wall time beside its witness's, and for (a)-(c) ms per
    iteration, idle share (the non-NCCL kernels against the CUDA-event
    time), NCCL ms per iteration and launches per kernel and iteration on
    4 ranks against 1.  Returns the workers' launches on
    the fits, summed over the ranks."""
    import tempfile

    import torch
    import torch.distributed as dist
    from multivartv_tpu_torch.parallel import distributed
    from multivartv_tpu_torch.parallel.sharding import make_device_mesh

    fits = SHARD4_FITS if fits is None else fits
    timed = SHARD4_TIMED if timed is None else timed
    log(f"phase 24: the sharded fit across {world} cards (one NCCL rank a card)")
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count() if not rehearse else world
    lines = all_gpu_lines()
    for i, line in enumerate(lines):
        log(f"  card {i}: {line}")
    if not check(cards >= world, f"phase 24 needs {world} cards: this machine has {cards}"):
        return {}
    log(f"phase 24: the collectives on {world} ranks (a first spawn, before the witnesses)")
    probe = shard4_workers({}, {}, world, rehearse)
    if len(probe) != world:
        return {}
    for r in sorted(probe):
        errs = probe[r]["collectives"]
        check(probe[r]["backend"] == ("gloo" if rehearse else "nccl")
              and all(v == 0.0 for v in errs.values()),
              f"phase 24 rank {r} on {probe[r]['device']} ({probe[r]['backend']}): each "
              f"collective of the sharded fit exact on the row and fold groups of a (2, "
              f"{world // 2}, 1) mesh {errs}")
    for name, (ms, host_us) in probe[0]["latency"].items():
        log(f"  {name}: {ms:.4f} ms per call (CUDA events, rank 0), host {host_us:.1f} us per "
            f"call [{GPU_LINE}]")
    log("phase 24: the witnesses on card 0, a group of one NCCL rank")
    wit, wit_timed = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        distributed.init_distributed(f"file://{tmp}/store", world_size=1, rank=0, device=device)
        try:
            for label, spec in fits.items():
                if spec[7] is None:
                    wit[label] = shard4_fit(label, spec, device)
                    w = wit[label]
                    log(f"  witness {label}: {w['seconds']:.2f} s [{GPU_LINE}], chosen index "
                        f"{w['best']}, iterations per lambda {w['iters']}, MSEs "
                        f"{[float(f'{v:.8g}') for v in w['cv_mses']]}")
                torch.cuda.empty_cache()
            group = make_device_mesh()
            for label, (name, lam) in timed.items():
                wit_timed[label] = shard4_iterations(label, fits[name], lam, device, group)
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"phase 24: {world} workers, one card each (spawned) [{time.perf_counter() - t_phase:.1f}"
        f" s into the phase]")
    res = shard4_workers(fits, timed, world, rehearse)
    if len(res) != world:
        return {}
    r0 = res[0]
    check(all(r["backend"] == ("gloo" if rehearse else "nccl") and r["all_reduce"] == world
              for r in res.values()),
          f"phase 24: every rank on its own device ({[r['device'] for r in res.values()]}) in "
          f"one {r0['backend']} world of {world} (an all_reduce of ones gave {r0['all_reduce']})")

    log("phase 24: the fits on 4 ranks against their witnesses on one")
    for label, spec in fits.items():
        got = r0["fits"][label]
        digests = {r["fits"][label]["digest"] for r in res.values()}
        check(len(digests) == 1 and all(r["fits"][label]["finite"] for r in res.values()),
              f"{label}: every rank returned the same model, finite ({len(digests)} digests)")
        if got["oty"] is not None:
            n_oty = len({r["fits"][label]["oty"] for r in res.values()})
            log(f"  {label}: O'y as each rank bins it, {n_oty} distinct digests over the "
                f"{world} ranks")
        ref_label = spec[7] or label
        ref = wit.get(ref_label) if spec[7] is None else r0["fits"][ref_label]
        log(f"  {label} on {spec[6]}: {got['seconds']:.2f} s against the witness's "
            f"{wit[ref_label]['seconds']:.2f} s [{', '.join(sorted(set(lines)))}]; chosen index "
            f"{got['best']}, iterations per lambda {got['iters']}, launches {got['launches']}, "
            f"pencil transposes {got['moves']}")
        if spec[3] > 1:
            continue
        lam_err = float(np.max(np.abs(got["lambdas"] - ref["lambdas"]) / ref["lambdas"]))
        mse_err = float(np.max(np.abs(got["cv_mses"] - ref["cv_mses"]) / ref["cv_mses"]))
        obj = [(a - b) / abs(b) for a, b in zip(got["objective"], ref["objective"])]
        log(f"  {label}: lambdas {lam_err:.3e}, MSEs {mse_err:.3e} relative; objective (4 ranks "
            f"- 1) / |1| per lambda {[f'{v:+.3e}' for v in obj]}")
        check(lam_err <= 1e-5 and mse_err <= 1e-4 and got["best"] == ref["best"],
              f"{label}: the lambda grid within 1e-5 ({lam_err:.3e}), the MSEs within 1e-4 "
              f"({mse_err:.3e}) and the chosen index ({got['best']} vs {ref['best']}) of the "
              "group of one")
        at = obj if not label.startswith("(c)") else [obj[ref["best"]]]
        check(all(abs(v) <= SHARD4_OBJ for v in at),
              f"{label}: objective {'at every lambda' if len(at) > 1 else 'at the chosen lambda'}"
              f" within {SHARD4_OBJ:g} relative of the group of one "
              f"({max(abs(v) for v in at):.3e})")

    def used(label, k):
        return sum(r["fits"][label]["launches"].get(k, 0) for r in res.values())

    a, b, bx, c = list(fits)[:4]
    for k in ("dual_update_tiled_2d_shard", "gram_residual_tiled_2d_shard"):
        check(used(a, k) > 0, f"{a}: {k} launched on 4 cards with halos from their neighbours "
              f"({used(a, k)} in all)")
    for k in ("dual_update_tiled_3d_shard", "gram_residual_tiled_3d_shard"):
        check(used(b, k) > 0 and used(bx, k) > 0, f"{b}: {k} launched on plane slabs of "
              f"{fits[b][1][0] // world} ({used(b, k)} default arm, {used(bx, k)} "
              "xla_packed=False)")
    check(used(bx, "gram_matvec_tiled_3d_shard") > 0, f"{bx}: the slab matvec launched "
          f"({used(bx, 'gram_matvec_tiled_3d_shard')})")
    for label in (a, b):
        n_moves = sum(r["fits"][label]["moves"]["to_pencils"] for r in res.values())
        check(n_moves > 0, f"{label}: the spectral CG's pencil transposes ran across the ranks "
              f"({n_moves} to_pencils calls, each an all_to_all on {r0['backend']})")
    seg, fin, whole = (used(c, k) for k in ("xupdate_tridiag_segment", "partition_finish",
                                            "xupdate_tridiag"))
    check(seg > 0 and fin > 0 and whole == 0,
          f"{c}: T1's segment mode ({seg}) and partition_finish ({fin}) launched on 4 cards, "
          f"T1 on the whole chain not ({whole})")

    d, e = list(fits)[4:6]
    wd = wit[d]
    per_d = {f: mse for r in res.values() for f, mse in zip(r["fits"][d]["folds"],
                                                             r["fits"][d]["fold_mse"])}
    per_e = {f: mse for r in res.values() for f, mse in zip(r["fits"][e]["folds"],
                                                             r["fits"][e]["fold_mse"])}
    folds = fits[d][3]
    if check(sorted(per_d) == list(range(folds)) and sorted(per_e) == list(range(folds)),
             f"{d}, {e}: every fold solved on one row group (folds {sorted(per_d)}, "
             f"{sorted(per_e)})"):
        dd = max(float(np.max(np.abs(per_d[f] - wd["fold_mse"][f]) / wd["fold_mse"][f]))
                 for f in range(folds))
        de = max(float(np.max(np.abs(per_e[f] - per_d[f]) / per_d[f])) for f in range(folds))
        lam = float(np.max(np.abs(r0["fits"][d]["lambdas"] - wd["lambdas"]) / wd["lambdas"]))
        log(f"  {d}: per-fold held-out MSEs against the group of one's fold solves: max "
            f"relative difference {dd:.3e} (lambda grids {lam:.3e} apart); {e} against {d}: "
            f"{de:.3e}")
        check(dd <= SHARD4_FOLD and r0["fits"][d]["best"] == wd["best"],
              f"{d}: each fold's MSEs within {SHARD4_FOLD:g} of the group of one's ({dd:.3e}), "
              f"the chosen index {r0['fits'][d]['best']} its {wd['best']}")
        cvd = r0["fits"][d]["cv_mses"]
        ties = np.nonzero(cvd <= cvd.min() * (1 + MVTV_TIE))[0].tolist()
        check(de <= SHARD4_FOLD_E and r0["fits"][e]["best"] in ties,
              f"{e}: each fold's MSEs within {SHARD4_FOLD_E:g} of {d}'s ({de:.3e}), the chosen "
              f"index {r0['fits'][e]['best']} in its tie set {ties}")

    log(f"phase 24: ms per iteration on {world} ranks against 1 ({SHARD_ARM_ITERS} "
        "admm_fixed_iterations from one warm state)")
    for label in timed:
        one, four = wit_timed[label], r0["timed"][label]
        every = [f"{res[r]['timed'][label]['ms']:.3f}" for r in sorted(res)]
        log(f"  {label}: {four['ms']:.3f} ms per iteration on {world} ranks (each rank "
            f"{every}) against {one['ms']:.3f} on 1 (speed-up {one['ms'] / four['ms']:.2f}x); "
            f"per iteration (torch.profiler, rank 0; unions of kernel intervals): the compute "
            f"(every kernel but NCCL's) {four['compute']:.3f} against {one['compute']:.3f} ms, "
            f"idle share (1 - compute / ms) {four['idle']:.3f} against {one['idle']:.3f}; NCCL "
            f"kernels (transfers and spin-waits) {four['nccl']:.3f} ms, all kernels "
            f"{four['busy']:.3f} against {one['busy']:.3f} ms [{', '.join(sorted(set(lines)))}]")
        log(f"  {label} launches per iteration, 4 ranks (rank 0): "
            f"{ {k: round(v, 2) for k, v in four['launches'].items()} }; 1 rank: "
            f"{ {k: round(v, 2) for k, v in one['launches'].items()} }")
        log(f"  {label} summed kernel ms per iteration by group, 4 ranks (rank 0): "
            f"{ {k: round(v, 4) for k, v in four['groups'].items()} }; 1 rank: "
            f"{ {k: round(v, 4) for k, v in one['groups'].items()} }")
    log(f"phase 24: {time.perf_counter() - t_phase:.1f} s")
    total = {}
    for r in res.values():
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


SOURCES = {
    "dual_update_2d": ("multivartv_tpu_torch/csrc/dual.cu",
                       "multivartv_tpu/ops/pallas_kernels.py:262"),
    "rhs_2d": ("multivartv_tpu_torch/csrc/rhs.cu", "multivartv_tpu/ops/pallas_kernels.py:577"),
    "xupdate_pcg_2d_packed": ("multivartv_tpu_torch/csrc/xupdate.cu",
                              "multivartv_tpu/ops/pallas_kernels.py:465"),
    "admm_iters_2d": ("multivartv_tpu_torch/csrc/chain.cu",
                      "multivartv_tpu/ops/pallas_kernels.py:808"),
    "admm_iters_2d_batched": ("multivartv_tpu_torch/csrc/chain.cu",
                              "multivartv_tpu/ops/pallas_kernels.py:969"),
    "dual_update_tiled_2d": ("multivartv_tpu_torch/csrc/tiled.cu",
                             "multivartv_tpu/ops/pallas_kernels.py:1382"),
    "gram_residual_tiled_2d": ("multivartv_tpu_torch/csrc/tiled.cu",
                               "multivartv_tpu/ops/pallas_kernels.py:1721"),
    "gram_matvec_tiled_2d": ("multivartv_tpu_torch/csrc/tiled.cu",
                             "multivartv_tpu/ops/pallas_kernels.py:1820"),
    "xupdate_pcg_2d": ("multivartv_tpu_torch/csrc/xupdate.cu",
                       "multivartv_tpu/ops/pallas_kernels.py:505"),
    "gram_matvec_2d": ("multivartv_tpu_torch/csrc/tiled.cu",
                       "multivartv_tpu/ops/pallas_kernels.py:143"),
    "rhs_tiled_2d": ("multivartv_tpu_torch/csrc/rhs.cu",
                     "multivartv_tpu/ops/pallas_kernels.py:1545"),
    "dual_update_tiled_3d": ("multivartv_tpu_torch/csrc/tiled3.cu",
                             "multivartv_tpu/ops/pallas_kernels.py:2100"),
    "gram_residual_tiled_3d": ("multivartv_tpu_torch/csrc/tiled3.cu",
                               "multivartv_tpu/ops/pallas_kernels.py:2268"),
    "rhs_tiled_3d": ("multivartv_tpu_torch/csrc/tiled3.cu",
                     "multivartv_tpu/ops/pallas_kernels.py:2197"),
    "dual_update_tiled_2d_shard": ("multivartv_tpu_torch/csrc/dual.cu",
                                   "multivartv_tpu/ops/pallas_kernels.py:1437"),
    "gram_residual_tiled_2d_shard": ("multivartv_tpu_torch/csrc/tiled.cu",
                                     "multivartv_tpu/ops/pallas_kernels.py:1769"),
    # B9s's kernel in its matvec mode: B10's function on a slab.
    "gram_matvec_tiled_2d_shard": ("multivartv_tpu_torch/csrc/tiled.cu",
                                   "multivartv_tpu/ops/pallas_kernels.py:1820"),
    "rhs_tiled_2d_shard": ("multivartv_tpu_torch/csrc/rhs.cu",
                           "multivartv_tpu/ops/pallas_kernels.py:1581"),
    "dual_struct": ("multivartv_tpu_torch/csrc/probe.cu", "scripts/probe_r5_dualstruct.py:79"),
    # T1 replaces no Pallas kernel: the JAX package's solve is XLA.
    "xupdate_tridiag": ("multivartv_tpu_torch/csrc/tridiag.cu",
                        "multivartv_tpu/solver/tridiag.py:208 (XLA, no Pallas kernel)"),
    # The sharded p = 3 and p = 1 stages: XLA under SPMD in the JAX package.
    "dual_update_tiled_3d_shard": ("multivartv_tpu_torch/csrc/tiled3.cu",
                                   "none: XLA under SPMD in JAX (multivartv_tpu/parallel/fit.py"
                                   ":256, the p = 3 dual stage)"),
    "gram_residual_tiled_3d_shard": ("multivartv_tpu_torch/csrc/tiled3.cu",
                                     "none: XLA under SPMD in JAX (multivartv_tpu/parallel/"
                                     "fit.py:256, the p = 3 PCG's r0)"),
    # The sharded p = 3 PCG's matvec: the Laplacian march.
    "gram_matvec_tiled_3d_shard": ("multivartv_tpu_torch/csrc/tiled3.cu",
                                   "none: XLA under SPMD in JAX (multivartv_tpu/parallel/fit.py"
                                   ":256, the p = 3 PCG's matvec)"),
    # T1's segment mode, the partition solve across ranks (a group of more
    # than one rank; none on one card).
    "xupdate_tridiag_segment": ("multivartv_tpu_torch/csrc/tridiag.cu",
                                "multivartv_tpu/solver/tridiag.py:208 under SPMD (XLA, no "
                                "Pallas kernel)"),
    # The partition solve's finish: the interface solve and back-substitution.
    "partition_finish": ("multivartv_tpu_torch/csrc/tridiag.cu",
                         "multivartv_tpu/solver/tridiag.py:208 under SPMD (XLA, no Pallas "
                         "kernel)"),
}
# The lattices (and batch) at which phase 7 times the whole-lattice kernels;
# B1's row is its 1023^2 time (phase_timing_slice), where its launches are.
TIMED_AT = {"dual_update_2d": ((512, 512), {}), "rhs_2d": ((512, 512), {}),
            "xupdate_pcg_2d_packed": ((512, 512), {}), "admm_iters_2d": ((512, 512), {}),
            "admm_iters_2d_batched": ((316, 316), {"batch": 5})}


def phase_mvtv_default(device):
    """Phase 8: the default call, mvtv(x, y) with n_lambda = 100, timed once."""
    log("phase 8: mvtv (folds=5, n_lambda=100) at 316^2 n=1e5, wall time")
    x, y = bivariate_exp(MVTV_N)
    model, cvres, fpath, seconds = mvtv_fit(x, y, None, device, n_lambda=100)
    describe_mvtv("316^2 n=1e5 n_lambda=100 kernel route", model, cvres, fpath, seconds)
    log(f"  mvtv n_lambda=100: {seconds:.2f} s [{GPU_LINE}]")
    check(bool(np.all(np.isfinite(model.theta_lattice))), "mvtv n_lambda=100: theta finite")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,12,13,15,16,17,20,21,22,23",
                    help="comma-separated phases to run (default: 1-10, 12, 13, 15-17, 20-23; "
                    "11, 14, 18, 19 and 24 only when listed; 24 needs four cards)")
    phases = {int(v) for v in ap.parse_args(argv).phases.split(",")}
    phase_device()
    import torch
    device = torch.device("cuda", 0)
    phase_build()
    timed = {}
    errs = phase_kernels(device, timed) if 3 in phases else {}
    launches, fits = phase_main_path(device) if phases & {4, 5} else ({}, [])
    launches_cv, model = phase_mvtv(device) if phases & {4, 5} else ({}, None)
    if launches_cv:
        log(f"  launches on the two main paths (mvtv_one, mvtv): "
            f"{ {k: (launches[k], launches_cv[k]) for k in TIMED_AT} }")
        for k in TIMED_AT:
            check(launches[k] + launches_cv[k] > 0,
                  f"the main paths launched {k} ({launches[k]} + {launches_cv[k]} times)")
        launches = {k: launches[k] + launches_cv[k] for k in launches}
    if 9 in phases:
        launches_large = phase_large(device)
        launches = {k: launches.get(k, 0) + launches_large[k] for k in launches_large}
    if 12 in phases:
        launches_cubes = phase_cubes(device)
        launches = {k: launches.get(k, 0) + launches_cubes[k] for k in launches_cubes}
    if 15 in phases:
        launches_slice = phase_slice(device)
        launches = {k: launches.get(k, 0) + launches_slice[k] for k in launches_slice}
    if 16 in phases:
        launches_shard = phase_sharded(device)
        launches = {k: launches.get(k, 0) + launches_shard[k] for k in launches_shard}
    if 20 in phases:
        launches_fused = phase_fused(device)
        launches = {k: launches.get(k, 0) + launches_fused[k] for k in launches_fused}
    if 6 in phases:
        phase_predict(fits, model)
    if phases & {7, 10, 13}:
        log("phase 7/10: the device-memory rate the card reaches (the copy probe)")
        copy_ceiling(device)
    times, _ = phase_timing(device) if 7 in phases else ({}, {})
    timed.update({k: (*times[k], *TIMED_AT[k]) for k in times})
    if 7 in phases:
        timed.update({k: (ms, plain, m, {})
                      for k, (ms, plain, m) in phase_timing_slice(device).items()})
    if 10 in phases:
        timed.update({k: (ms, plain, m, {})
                      for k, (ms, plain, m) in phase_timing_large(device).items()})
    if 13 in phases:
        timed.update({k: (ms, plain, m, {})
                      for k, (ms, plain, m) in phase_timing_cubes(device).items()})
    if 17 in phases:
        timed.update({k: (ms, plain, m, {})
                      for k, (ms, plain, m) in phase_timing_shard(device).items()})
    if 21 in phases:
        timed.update({k: (ms, plain, m, {})
                      for k, (ms, plain, m) in phase_timing_fused(device).items()})
    if 22 in phases:
        launches_arms, times_arms = phase_arms(device)
        launches = {k: launches.get(k, 0) + launches_arms[k] for k in launches_arms}
        timed.update({k: (ms, plain, m, {}) for k, (ms, plain, m) in times_arms.items()})
    if 23 in phases:
        launches_s3, times_s3 = phase_sharded3(device, errs)
        launches = {k: launches.get(k, 0) + launches_s3[k] for k in launches_s3}
        timed.update(times_s3)
    if 24 in phases:
        launches_s4 = phase_sharded4(device)
        launches = {k: launches.get(k, 0) + launches_s4.get(k, 0)
                    for k in set(launches) | set(launches_s4)}
    if 8 in phases:
        phase_mvtv_default(device)
    if 11 in phases:
        phase_path_gap(device)
    if 14 in phases:
        phase_cubes_exact(device)
    if 18 in phases:
        phase_c3_tight(device)
    if 19 in phases:
        phase_launch_sizes(device)
    if FAILURES:
        log(f"chip_smoke: {len(FAILURES)} check(s) failed:")
        for f in FAILURES:
            log(f"  {f}")
        return 1
    kernels = []
    for k, (src, replaces) in SOURCES.items():
        ms, plain, m, kw = timed.get(k, (None, None, None, {}))
        b_ms, b_by = bound(k, m, **kw) if m is not None else (None, None)
        kernels.append({"name": k, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches.get(k), "max_abs_err": errs.get(k), "ms": ms,
                        "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})
    log(f"gpu: {GPU_LINE}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
