"""Build the port's objects from the JAX package's, given as numpy arrays.

The JAX package's ``Operators``, ``Problem`` and ``ADMMState`` are
dataclasses of arrays; a caller that has them passes their leaves as numpy
arrays (``np.asarray(field)``) and gets the port's counterparts on a chosen
device.  A batched Problem or state (a leading axis on every leaf, as
``jax.vmap`` builds them for CV folds) crosses the same way.  The port
never imports jax: only the numpy values cross.  The device defaults to
"cuda", as the API's does, and raises without CUDA; pass ``device="cpu"``
for the CPU.

``slab_from_numpy`` cuts the three into one rank's slab of a sharded
fit (parallel/sharding.py), so that a test hands both packages the same
inputs.

The JAX package's padded operator set (``Operators.padded``) is built for
the TPU's (8, 128) or (2, 8, 128) alignment; the port pads odd axes of a
2-D or 3-D lattice to even instead, so ``operators_from_numpy`` builds the
port's own padded set from the deltas.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from multivartv_tpu_torch.api import resolve_device
from multivartv_tpu_torch.config import SolverConfig
from multivartv_tpu_torch.solver import pad as pad_lib
from multivartv_tpu_torch.solver.admm import ADMMState
from multivartv_tpu_torch.solver.problem import Operators, Problem, build_operators


def _t(x, device, dtype=torch.float32):
    return None if x is None else torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _same_type(x, device):
    """A float32 or bfloat16 array (or nested tuples of them) as a tensor
    of the same type: numpy holds bf16 as ml_dtypes' bfloat16, whose
    values cross exactly through float32."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(_same_type(v, device) for v in x)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return _t(a, device)


def operators_from_numpy(*, binaries, m, scales, deltas, gram_eigs, gram_diagonal=None,
                         dct_mats=None, dct_halves=None, gram_eigs_packed=None,
                         gram_eigs_blocked=None, gram_eigs_blocked_lp=None,
                         dct_quarters_lp=None, gram_eigs_quartered=None,
                         gram_eigs_quartered_lp=None, device="cuda") -> Operators:
    """Operators from the JAX fields of the same names; the bf16 halves and
    dense matrices are the float32 ones rounded to bf16, as the JAX package
    casts them.  The blocked and quartered operand sets keep their types
    (bf16 matrices and eigenvalue copies, float32 diagonals and weights)."""
    m = tuple(int(v) for v in m)
    device = resolve_device(device)
    halves = (None if dct_halves is None
              else tuple((_t(te, device), _t(to, device)) for te, to in dct_halves))
    mats = None if dct_mats is None else tuple(_t(t, device) for t in dct_mats)
    padded = None
    if pad_lib.pad_applies(m):
        cfg = SolverConfig(include_full_mixed=len(binaries) == 2 ** len(m) - 1)
        padded = build_operators(pad_lib.pad_target_m(m), np.asarray(deltas), cfg, device,
                                 with_padded=False)
    return Operators(
        binaries=tuple(tuple(int(v) for v in b) for b in binaries),
        m=m,
        scales=tuple(float(np.float32(s)) for s in scales),
        deltas=_t(deltas, device),
        gram_eigs=_t(gram_eigs, device),
        gram_diagonal=_t(gram_diagonal, device),
        dct_mats=mats,
        dct_mats_lp=(None if mats is None or len(m) != 2
                     else tuple(t.to(torch.bfloat16) for t in mats)),
        dct_halves=halves,
        dct_halves_lp=(None if halves is None
                       else tuple((te.to(torch.bfloat16), to.to(torch.bfloat16))
                                  for te, to in halves)),
        gram_eigs_packed=_t(gram_eigs_packed, device),
        gram_eigs_blocked=_same_type(gram_eigs_blocked, device),
        gram_eigs_blocked_lp=_same_type(gram_eigs_blocked_lp, device),
        dct_quarters_lp=_same_type(dct_quarters_lp, device),
        gram_eigs_quartered=_same_type(gram_eigs_quartered, device),
        gram_eigs_quartered_lp=_same_type(gram_eigs_quartered_lp, device),
        padded=padded,
    )


def problem_from_numpy(*, counts, oty, ybar, flat_idx, y, train_mask=None,
                       device="cuda") -> Problem:
    device = resolve_device(device)
    return Problem(counts=_t(counts, device), oty=_t(oty, device), ybar=_t(ybar, device),
                   flat_idx=_t(flat_idx, device, torch.int64), y=_t(y, device),
                   train_mask=_t(train_mask, device))


def state_from_numpy(*, theta, alpha: Sequence, u: Sequence, rho, counter=0,
                     primal_norm=1.0, dual_norm=1.0, eps_primal=0.0, eps_dual=0.0,
                     cg_iters=0, u_scale=1.0, device="cuda") -> ADMMState:
    """A single state (scalar counter, host counts) or, for a (B,) counter,
    a batched one (counts as (B,) int64 tensors, ADMMState)."""
    device = resolve_device(device)
    batch = np.shape(counter)

    def s(x):
        return torch.broadcast_to(_t(x, device), batch).contiguous()

    def count(x, dtype=torch.int64):
        if not batch:
            return bool(x) if dtype == torch.bool else int(x)
        return torch.broadcast_to(_t(x, device, dtype), batch).contiguous()

    return ADMMState(
        theta=_t(theta, device), alpha=tuple(_t(a, device) for a in alpha),
        u=tuple(_t(w, device) for w in u), rho=s(rho), counter=count(counter),
        primal_norm=s(primal_norm), dual_norm=s(dual_norm), eps_primal=s(eps_primal),
        eps_dual=s(eps_dual), cg_iters=count(cg_iters), u_scale=s(u_scale),
        chunked_iters=count(0), exact_iters=count(0), escaped=count(False, torch.bool))


def slab_from_numpy(slab, operators: dict, problem: dict, state: Optional[dict] = None,
                    device="cuda"):
    """(operators, problem, state) of one rank's slab (a RowSlab of a
    lattice of p = 1, 2 or 3) from the JAX fields as numpy arrays, given as
    the keyword arguments of operators_from_numpy, problem_from_numpy and
    state_from_numpy: lattice arrays cut to the slab along axis 0
    (gram_eigs to its pencil at p >= 2, as parallel.fit.shard_operators
    cuts it), per-axis and per-sample arrays and scalars whole; state None
    gives None."""
    from multivartv_tpu_torch.parallel.fit import shard_operators
    from multivartv_tpu_torch.parallel.sharding import shard_problem, shard_state

    ops = shard_operators(operators_from_numpy(**operators, device=device), slab)
    pr = shard_problem(problem_from_numpy(**problem, device=device), slab)
    st = None if state is None else shard_state(state_from_numpy(**state, device=device), slab)
    return ops, pr, st
