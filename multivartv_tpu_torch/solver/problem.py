"""Operator and problem containers for the ADMM solver.

Counterpart of ``multivartv_tpu/solver/problem.py``.  Matrix-free on a
lattice, the data-dependent cached objects are counts = diag(O'O) and
oty = O'y; the rest depends only on (m, deltas): the Gram eigenvalues (and
diag(D'D) for jacobi_pcg), the dense DCT matrices of the exact route (with
bf16 copies for the dense x-updates) and the folded half matrices (with
their bf16 copies) of the kernel route, and above 2^20 knots the blocked
and quartered operand sets of the spectral-correction CG (JAX
solver/problem.py:50-71).  The operator set of the even-axis
padded lattice (solver/pad.py, p = 2 and 3, under its blow-up gate) is
built once here, so a solve never rebuilds spectral operands.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from multivartv_tpu_torch.config import SolverConfig
from multivartv_tpu_torch.mesh import MeshSpec
from multivartv_tpu_torch.ops import dct as dct_ops
from multivartv_tpu_torch.ops import diff as diff_ops
from multivartv_tpu_torch.ops import interp as interp_ops


@dataclasses.dataclass(frozen=True)
class Operators:
    """D and the spectral objects of the x-update system for a lattice of
    dims m with TV cell sizes deltas.  Tensors live on one device; the
    block scales are Python floats (float32 values)."""

    binaries: Tuple[Tuple[int, ...], ...]
    m: Tuple[int, ...]
    scales: Tuple[float, ...]
    deltas: torch.Tensor
    gram_eigs: torch.Tensor                     # shape m, natural order
    gram_diagonal: Optional[torch.Tensor] = None    # diag(D'D), for jacobi_pcg
    dct_mats: Optional[Tuple[torch.Tensor, ...]] = None
    # bf16 copies of the dense matrices: the operands of the one-kernel
    # dense x-update (xupdate_pcg_2d) and of the bf16 dense preconditioner.
    dct_mats_lp: Optional[Tuple[torch.Tensor, ...]] = None
    dct_halves: Optional[Tuple[Tuple[torch.Tensor, torch.Tensor], ...]] = None
    dct_halves_lp: Optional[Tuple[Tuple[torch.Tensor, torch.Tensor], ...]] = None
    gram_eigs_packed: Optional[torch.Tensor] = None
    # The spectral-correction CG's layouts (ops/dct.py): the Gram
    # eigenvalues as blocked (2^p) and quartered (4^p) blocks with their
    # bf16 copies (the bf16-vector regime's elementwise operands), and the
    # depth-2 fast DCT's per-axis operands, matrices in bf16.
    gram_eigs_blocked: Optional[Tuple[torch.Tensor, ...]] = None
    gram_eigs_blocked_lp: Optional[Tuple[torch.Tensor, ...]] = None
    dct_quarters_lp: Optional[Tuple[tuple, ...]] = None
    gram_eigs_quartered: Optional[Tuple[torch.Tensor, ...]] = None
    gram_eigs_quartered_lp: Optional[Tuple[torch.Tensor, ...]] = None
    padded: Optional["Operators"] = None
    # A sharded fit's operators (parallel/fit.py::shard_operators): this
    # rank's RowSlab of the lattice m.  Lattices are then the rank's row
    # slabs, D and D' exchange halo rows, lattice sums run over the row
    # group, gram_eigs is the rank's column slab (the DCT preconditioner's
    # pencil layout) and gram_diagonal its row slab.
    slab: Optional[object] = None

    @property
    def ntheta(self) -> int:
        return int(np.prod(self.m))

    @property
    def rows_d(self) -> int:
        return diff_ops.num_rows(self.m, self.binaries)

    @property
    def local_m(self) -> Tuple[int, ...]:
        """The shape of the lattices a solve holds: m, or the row slab's."""
        return self.m if self.slab is None else self.slab.shape

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of a lattice quantity, over the row group when sharded."""
        s = torch.sum(x)
        if self.slab is None:
            return s
        from multivartv_tpu_torch.parallel.halo import psum
        return psum(s, self.slab.group)

    def apply_D(self, theta):
        if self.slab is not None:
            from multivartv_tpu_torch.parallel.halo import slab_apply_D
            return slab_apply_D(theta, self.slab, self.scales, self.binaries)
        return diff_ops.apply_D(theta, self.binaries, self.scales)

    def apply_Dt(self, blocks):
        if self.slab is not None:
            from multivartv_tpu_torch.parallel.halo import slab_apply_Dt
            return slab_apply_Dt(blocks, self.slab, self.scales, self.binaries)
        return diff_ops.apply_Dt(blocks, self.binaries, self.scales)

    def apply_gram(self, theta):
        if self.slab is not None:
            return self.apply_Dt(self.apply_D(theta))
        return diff_ops.apply_gram(theta, self.binaries, self.scales)


@dataclasses.dataclass(frozen=True)
class Problem:
    """One denoising problem (or one CV fold of one) ready for the solver.
    A batch of B problems (CV folds) carries a leading axis B on every
    field; a lambda sweep shares one problem across its batch."""

    counts: torch.Tensor    # (m) diag(O'O)
    oty: torch.Tensor       # (m) O'y
    ybar: torch.Tensor      # 0-d mean of the training y: the theta initial value
    flat_idx: torch.Tensor  # (n,) C-order nearest-knot index, int64
    y: torch.Tensor         # (n,)
    train_mask: Optional[torch.Tensor] = None  # (n,) 0/1; None = every sample trains


# Smallest axis that gets the quartered operand set (JAX
# solver/problem.py:117-124: quarter-width products of at least 128).
# Tests lower it to reach the quartered layout on tiny lattices.
QUARTER_MIN_AXIS = 512


def _lp_quarters(v: int):
    c2q, v4q, c2qf, c1, s1, alt, w = dct_ops.dct_quarter_mats(v)
    return (c2q.to(torch.bfloat16), v4q.to(torch.bfloat16), c2qf.to(torch.bfloat16), c1, s1,
            alt, w)


def _to(x, device):
    """x (a tensor, None, or nested tuples of them) on device."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_to(v, device) for v in x)
    return x.to(device)


def build_operators(m: Sequence[int], deltas, cfg: SolverConfig,
                    device=None, with_padded: bool = True) -> Operators:
    """Operators built on the host in float32, then moved to ``device``,
    so every device runs the same operand values."""
    from multivartv_tpu_torch.solver import pad as pad_lib

    m = tuple(int(v) for v in m)
    deltas = torch.as_tensor(deltas, dtype=torch.float32).cpu()
    binaries = diff_ops.fd_binaries(len(m), cfg.include_full_mixed)
    gram_eigs = dct_ops.gram_eigenvalues(m, deltas, cfg.include_full_mixed)
    scales = diff_ops.delta_scales(binaries, deltas)
    gram_diagonal = (diff_ops.gram_diag(m, binaries, scales) if cfg.x_solver == "jacobi_pcg"
                     else None)
    dct_mats = dct_ops.dct_matrices(m) if max(m) <= 2048 else None
    dct_mats_lp = (None if dct_mats is None or len(m) != 2
                   else tuple(t.to(torch.bfloat16) for t in dct_mats))
    dct_halves = dct_halves_lp = eigs_packed = None
    eigs_blocked = quarters_lp = eigs_quartered = None
    if len(m) >= 2 and max(m) <= 8192 and all(v % 2 == 0 for v in m):
        dct_halves = tuple(dct_ops.dct_packed_halves(v) for v in m)
        dct_halves_lp = tuple((te.to(torch.bfloat16), to.to(torch.bfloat16))
                              for te, to in dct_halves)
        eigs_packed = dct_ops.pack_spectrum(gram_eigs)
        eigs_blocked = dct_ops.blocked_spectrum(gram_eigs)
        if all(v % 4 == 0 and v >= QUARTER_MIN_AXIS for v in m):
            quarters_lp = tuple(_lp_quarters(v) for v in m)
            eigs_quartered = dct_ops.quartered_spectrum(gram_eigs)
    padded = None
    if with_padded and pad_lib.pad_applies(m):
        padded = build_operators(pad_lib.pad_target_m(m), deltas, cfg, device,
                                 with_padded=False)

    def dev(x):
        return _to(x, device)

    def lp(blocks):
        return None if blocks is None else tuple(e.to(torch.bfloat16) for e in blocks)

    return Operators(
        binaries=binaries,
        m=m,
        scales=scales,
        deltas=dev(deltas),
        gram_eigs=dev(gram_eigs),
        gram_diagonal=dev(gram_diagonal),
        dct_mats=dev(dct_mats),
        dct_mats_lp=dev(dct_mats_lp),
        dct_halves=dev(dct_halves),
        dct_halves_lp=dev(dct_halves_lp),
        gram_eigs_packed=dev(eigs_packed),
        gram_eigs_blocked=dev(eigs_blocked),
        gram_eigs_blocked_lp=dev(lp(eigs_blocked)),
        dct_quarters_lp=dev(quarters_lp),
        gram_eigs_quartered=dev(eigs_quartered),
        gram_eigs_quartered_lp=dev(lp(eigs_quartered)),
        padded=padded,
    )


def build_problem(spec: MeshSpec, data: torch.Tensor, y: torch.Tensor,
                  train_mask: Optional[torch.Tensor] = None) -> Problem:
    """Bin the samples to the lattice and form counts and O'y; with a 0/1
    train_mask, over the training samples only (ybar = their mean)."""
    y = y.reshape(-1)
    flat_idx = interp_ops.flat_knot_indices(spec, data)
    if train_mask is None:
        wy, ybar = y, torch.mean(y)
    else:
        train_mask = train_mask.to(y.dtype).reshape(-1)
        wy = y * train_mask
        ybar = torch.sum(wy) / torch.clamp_min(torch.sum(train_mask), 1.0)
    return Problem(
        counts=interp_ops.knot_counts(flat_idx, spec.m, weights=train_mask, dtype=y.dtype),
        oty=interp_ops.scatter_to_lattice(wy, flat_idx, spec.m),
        ybar=ybar,
        flat_idx=flat_idx,
        y=y,
        train_mask=train_mask,
    )


def stack_problems(problems: Sequence[Problem]) -> Problem:
    """One batched Problem from B problems of the same lattice and samples."""
    def stack(name):
        vals = [getattr(pr, name) for pr in problems]
        return None if vals[0] is None else torch.stack(vals)

    return Problem(**{f.name: stack(f.name) for f in dataclasses.fields(Problem)})


def problem_at(problem: Problem, b: int, p: int) -> Problem:
    """Element b of a batched Problem on a p-dim lattice (a shared problem,
    counts of rank p, is every element)."""
    if problem.counts.ndim == p:
        return problem
    return Problem(**{f.name: (None if getattr(problem, f.name) is None
                               else getattr(problem, f.name)[b])
                      for f in dataclasses.fields(Problem)})
