"""Matrix-free difference operator D, its adjoint and its Gram.

Counterpart of ``multivartv_tpu/ops/diff.py``.  Block b of D (one per
nonzero binary b in {0,1}^p, create_D, utils.cpp:218-232) chains forward
differences along every axis with b_j = 1 and is scaled by
prod_j deltas_j^(1-b_j).  Blocks are stored padded to the full lattice
shape with zero trailing edges: the forward difference is a circular shift
minus the identity, then an edge mask; the adjoint is the opposite
circular shift minus the identity, exact because the edges are zero.  The
block order is the reference C++ stack order (``fd_binaries``), which for
p = 2 is ((1,1), (0,1), (1,0)); the kernels and the ADMM state rely on it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

Binary = Tuple[int, ...]
Blocks = Tuple[torch.Tensor, ...]


def fd_binaries(p: int, include_full_mixed: bool = True) -> Tuple[Binary, ...]:
    """Nonzero binaries: the all-ones binary first, then 1..2^p-2 in
    big-endian order (create_D, utils.cpp:225-230).  Without the full
    mixed block the all-ones binary is dropped (code/utils.py:145),
    except for p = 1, where it is the only penalty."""
    ordered = [tuple((n >> (p - 1 - j)) & 1 for j in range(p))
               for n in range(1, (1 << p) - 1)]
    ones = tuple([1] * p)
    if include_full_mixed or p == 1:
        return (ones,) + tuple(ordered)
    return tuple(ordered)


def delta_scales(binaries: Sequence[Binary], deltas: torch.Tensor) -> Tuple[float, ...]:
    """Per-block scale prod_j deltas_j^(1-b_j), computed in float32 and
    returned as Python floats (the kernels take them by value)."""
    d = torch.as_tensor(deltas, dtype=torch.float32).cpu()
    out = []
    for b in binaries:
        mask = torch.as_tensor(np.array(b) == 0)
        out.append(float(torch.prod(torch.where(mask, d, torch.ones_like(d)))))
    return tuple(out)


def block_shape(m: Sequence[int], b: Binary) -> Tuple[int, ...]:
    return tuple(int(mj) - bj for mj, bj in zip(m, b))


def num_rows(m: Sequence[int], binaries: Sequence[Binary]) -> int:
    """Mathematical row count of the stacked D (Boyd thresholds)."""
    return int(sum(np.prod(block_shape(m, b)) for b in binaries))


def edge_mask(shape: Sequence[int], b: Binary, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """1 on block b's valid region, 0 on the trailing edge of every
    differenced axis."""
    shape = tuple(int(v) for v in shape)
    out = torch.ones(shape, dtype=dtype, device=device)
    for j, bj in enumerate(b):
        if bj:
            idx = [slice(None)] * len(shape)
            idx[j] = shape[j] - 1
            out[tuple(idx)] = 0.0
    return out


def true_region_mask(shape: Sequence[int], b: Binary, true_m: Sequence[int],
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """1 on block b's rows of the TRUE (unpadded) problem: along axis j the
    valid indices are 0 .. true_m[j] - b_j - 1 (solver/pad.py)."""
    shape = tuple(int(v) for v in shape)
    out = torch.ones(shape, dtype=dtype, device=device)
    for j, bj in enumerate(b):
        bound = int(true_m[j]) - bj
        if bound < shape[j]:
            idx = [slice(None)] * len(shape)
            idx[j] = slice(bound, None)
            out[tuple(idx)] = 0.0
    return out


def apply_block(theta: torch.Tensor, b: Binary) -> torch.Tensor:
    """Padded forward difference: chained (shift - id), then the edge mask
    (wrapped values only land on rows the mask zeroes)."""
    out = theta
    for j, bj in enumerate(b):
        if bj:
            out = torch.roll(out, -1, j) - out
    if not any(b):
        return out
    return out * edge_mask(theta.shape, b, theta.dtype, theta.device)


def adjoint_block(a: torch.Tensor, b: Binary) -> torch.Tensor:
    """Adjoint of the padded forward difference: chained (shift_up - id)."""
    out = a
    for j, bj in enumerate(b):
        if bj:
            out = torch.roll(out, 1, j) - out
    return out


def apply_D(theta: torch.Tensor, binaries: Sequence[Binary],
            scales: Sequence[float]) -> Blocks:
    return tuple(s * apply_block(theta, b) for b, s in zip(binaries, scales))


def apply_Dt(blocks: Blocks, binaries: Sequence[Binary],
             scales: Sequence[float]) -> torch.Tensor:
    out = None
    for a, b, s in zip(blocks, binaries, scales):
        term = s * adjoint_block(a, b)
        out = term if out is None else out + term
    return out


def apply_gram(theta: torch.Tensor, binaries: Sequence[Binary],
               scales: Sequence[float]) -> torch.Tensor:
    """D'D theta."""
    out = None
    for b, s in zip(binaries, scales):
        term = (s * s) * adjoint_block(apply_block(theta, b), b)
        out = term if out is None else out + term
    return out


def gram_diag(m: Sequence[int], binaries: Sequence[Binary], scales: Sequence[float],
              dtype=torch.float32, device=None) -> torch.Tensor:
    """diag(D'D) in closed form (the Jacobi preconditioner): block b's Gram
    is a Kronecker product of L_j = Delta' Delta (diagonal [1, 2, ..., 2,
    1]) on the differenced axes and I on the others."""
    m = tuple(int(v) for v in m)
    out = torch.zeros(m, dtype=dtype, device=device)
    for b, s in zip(binaries, scales):
        term = torch.ones((), dtype=dtype, device=device)
        for j, bj in enumerate(b):
            dj = torch.ones(m[j], dtype=dtype, device=device)
            if bj:
                dj = torch.full((m[j],), 2.0, dtype=dtype, device=device)
                dj[0] = 1.0
                dj[-1] = 1.0
            shape = [1] * len(m)
            shape[j] = m[j]
            term = term * dj.reshape(shape)
        out = out + (s * s) * term
    return out


def blocks_norm_sq(blocks: Blocks) -> torch.Tensor:
    return sum(torch.sum(torch.square(a)) for a in blocks)


def blocks_abs_sum(blocks: Blocks) -> torch.Tensor:
    return sum(torch.sum(torch.abs(a)) for a in blocks)


def blocks_abs_max(blocks: Blocks) -> torch.Tensor:
    return torch.max(torch.stack([torch.max(torch.abs(a)) for a in blocks]))


def zeros_like_blocks(m: Sequence[int], binaries: Sequence[Binary],
                      dtype=torch.float32, device=None) -> Blocks:
    m = tuple(int(v) for v in m)
    return tuple(torch.zeros(m, dtype=dtype, device=device) for _ in binaries)


def tv_penalty(theta: torch.Tensor, binaries: Sequence[Binary],
               scales: Sequence[float]) -> torch.Tensor:
    """||D theta||_1, the TV penalty's value (JAX ops/diff.py:246-249)."""
    return blocks_abs_sum(apply_D(theta, binaries, scales))
