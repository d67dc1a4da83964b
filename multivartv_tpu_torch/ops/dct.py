"""DCT diagonalization of the difference Gram D'D.

Counterpart of ``multivartv_tpu/ops/dct.py`` (the main-path part).  Every
block of D is a Kronecker product of 1-D Neumann differences, so the
orthonormal p-dim DCT-II diagonalizes the whole stacked Gram D'D with
eigenvalues ``gram_eigenvalues``.  That gives the exact pseudo-inverse for
lambda_max and the preconditioner of the x-update's CG.

The folded ("packed") 2-D transform ``dct2_packed`` splits each axis into
its even and odd frequencies with two half-size products, and emits the
spectrum in packed order (``pack_spectrum``).  Its flip is an index
reversal: the JAX package's exchange-matrix product is a Mosaic
workaround and would round the flipped half to bf16.  With
``mat_dtype=torch.bfloat16`` the operands are rounded to bf16 at exactly
the JAX package's points and multiplied in float32, which is what the CUDA
kernels compute (bf16 products are exact in float32).  ``dctn_packed`` is
its p-dim form through the same bf16-operand products as the layouts
below, with the JAX package's rounding points (the packed layout of the
spectral-correction CG, e.g. 128^3).

Above 2^20 knots the x-update runs its spectral-correction CG on the
blocked (2^p half-size blocks) or the quartered (depth-2 fast DCT, 4^p
blocks) layout, ported from the JAX package with the same rounding points:
every product takes bf16 operands and returns the dtype of the
transform's input blocks (``preferred_element_type`` in JAX), so float32
in the float32-vector regime and bf16 in the bf16-vector one.  The
products are plain matrix products left to ``torch.matmul`` (XLA's in the
JAX package): the bf16 operands are widened to float32 and multiplied
with TF32 allowed inside that product alone.  A bf16 value has 7 mantissa
bits and TF32 keeps 10, so the card multiplies them exactly and sums in
float32; the CPU multiplies in float32.  Above 2048 per axis there are no
dense DCT matrices, and the exact transforms (lambda_max, the exact-f32
x-update) are the orthonormal FFT ``dctn``/``idctn``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def _allow_tf32(allow: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def exact_f32_matmul():
    """Run float32 products on the card in full float32 (TF32 off), as the
    exact routes (lambda_max, the exact-f32 x-update) require."""
    return _allow_tf32(False)


def bf16_value_products():
    """TF32 for float32 products on the card: exact for operands that hold
    bf16 values (see module doc), float32 sums."""
    return _allow_tf32(True)


def _dct_np(n: int) -> np.ndarray:
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    t = np.cos(np.pi * k * (2.0 * i + 1.0) / (2.0 * n))
    t[0] *= np.sqrt(1.0 / n)
    t[1:] *= np.sqrt(2.0 / n)
    return t


def dct_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Orthonormal DCT-II matrix T (T @ x == dct(x))."""
    return torch.as_tensor(_dct_np(n), dtype=dtype, device=device)


def dct_matrices(m: Sequence[int], dtype=torch.float32, device=None):
    return tuple(dct_matrix(int(n), dtype, device) for n in m)


def _cyclic_transform(x: torch.Tensor, mats, contract_dim: int) -> torch.Tensor:
    """Contract the first axis of x against each matrix in turn; the
    transformed axis is appended last, so after p steps the axes are back
    in order (the JAX package's _cyclic_transform)."""
    for t in mats:
        x = torch.tensordot(x, t, dims=([0], [contract_dim]))
    return x


def dctn_mat(x: torch.Tensor, mats) -> torch.Tensor:
    """Orthonormal DCT-II over all axes via per-axis products."""
    return _cyclic_transform(x, mats, 1)


def idctn_mat(x: torch.Tensor, mats) -> torch.Tensor:
    """Inverse (DCT-III) via the transposed matrices."""
    return _cyclic_transform(x, mats, 0)


def dct_packed_halves(n: int, dtype=torch.float32, device=None):
    """(Te, To): rows = even/odd DCT-II frequencies, columns = the first n/2
    spatial points.  Requires even n."""
    if n % 2:
        raise ValueError(f"dct_packed_halves needs an even size, got {n}")
    t = _dct_np(n)
    h = n // 2
    return (torch.as_tensor(t[0::2, :h], dtype=dtype, device=device),
            torch.as_tensor(t[1::2, :h], dtype=dtype, device=device))


def packed_order(n: int) -> np.ndarray:
    """Permutation taking natural frequency order to packed (even, odd)."""
    return np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)])


def pack_spectrum(x: torch.Tensor) -> torch.Tensor:
    """Permute every axis of a spectral array into packed order."""
    for ax in range(x.ndim):
        idx = torch.as_tensor(packed_order(x.shape[ax]), device=x.device)
        x = torch.index_select(x, ax, idx)
    return x


def _round(x: torch.Tensor, mat_dtype) -> torch.Tensor:
    """Round to the product operand type, kept in float32."""
    if mat_dtype is None or mat_dtype == x.dtype:
        return x
    return x.to(mat_dtype).to(x.dtype)


def dct2_packed(v: torch.Tensor, halves0, halves1, mat_dtype=None) -> torch.Tensor:
    """2-D DCT-II with packed-order output via folded half-size products.
    halves{0,1} = dct_packed_halves(m{0,1}) (their values are rounded to
    mat_dtype too).  Rounding points: the axis-0 folds, the axis-1 folds
    of the first-axis result."""
    te0, to0 = (_round(h.to(v.dtype), mat_dtype) for h in halves0)
    te1, to1 = (_round(h.to(v.dtype), mat_dtype) for h in halves1)
    h0 = v.shape[0] // 2
    h1 = v.shape[1] // 2
    top, bot = v[:h0], torch.flip(v[h0:], (0,))
    tmp = torch.cat([te0 @ _round(top + bot, mat_dtype),
                     to0 @ _round(top - bot, mat_dtype)], dim=0)
    left, right = tmp[:, :h1], torch.flip(tmp[:, h1:], (1,))
    return torch.cat([_round(left + right, mat_dtype) @ te1.T,
                      _round(left - right, mat_dtype) @ to1.T], dim=1)


def idct2_packed(y: torch.Tensor, halves0, halves1, mat_dtype=None) -> torch.Tensor:
    """Inverse of dct2_packed (packed input, natural output).  Rounding
    points: the even/odd halves of the input, then of the first-axis
    result."""
    te0, to0 = (_round(h.to(y.dtype), mat_dtype) for h in halves0)
    te1, to1 = (_round(h.to(y.dtype), mat_dtype) for h in halves1)
    h0 = y.shape[0] // 2
    h1 = y.shape[1] // 2
    a = te0.T @ _round(y[:h0], mat_dtype)
    b = to0.T @ _round(y[h0:], mat_dtype)
    x = torch.cat([a + b, torch.flip(a - b, (0,))], dim=0)
    aa = _round(x[:, :h1], mat_dtype) @ te1
    bb = _round(x[:, h1:], mat_dtype) @ to1
    return torch.cat([aa + bb, torch.flip(aa - bb, (1,))], dim=1)


def dctn_packed(x: torch.Tensor, halves) -> torch.Tensor:
    """p-dim DCT-II through folded half-size products (any p), packed
    (even, odd) frequency order along every axis: the JAX package's
    dctn_packed with mat_dtype = bf16 (dct.py:230-263).  Each axis is folded
    (top +- flip(bottom), rounded to the halves' type) and contracted
    against the halves; the transformed axis is appended last, so after p
    axes the layout is restored.  The output keeps x's dtype."""
    dtype = x.dtype
    for te, to in halves:
        h = x.shape[0] // 2
        if 2 * h != x.shape[0]:
            raise ValueError(f"dctn_packed needs even axes, got {x.shape[0]}")
        top, bot = x[:h], torch.flip(x[h:], (0,))
        e = _lp_dot((top + bot).to(te.dtype), te, 1, dtype)
        o = _lp_dot((top - bot).to(te.dtype), to, 1, dtype)
        x = torch.cat([e, o], dim=-1)
    return x


def idctn_packed(y: torch.Tensor, halves) -> torch.Tensor:
    """Inverse of dctn_packed: packed-order input, natural-order output
    (JAX dct.py:266-284)."""
    dtype = y.dtype
    for te, to in halves:
        h = y.shape[0] // 2
        if 2 * h != y.shape[0]:
            raise ValueError(f"idctn_packed needs even axes, got {y.shape[0]}")
        a = _lp_dot(y[:h].to(te.dtype), te, 0, dtype)
        b = _lp_dot(y[h:].to(te.dtype), to, 0, dtype)
        y = torch.cat([a + b, torch.flip(a - b, (-1,))], dim=-1)
    return y


def neumann_eigenvalues(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Eigenvalues 4 sin^2(pi k / 2n) of the 1-D Neumann Laplacian."""
    k = torch.arange(n, dtype=dtype, device=device)
    return 4.0 * torch.square(torch.sin(np.pi * k / (2.0 * n)))


def gram_eigenvalues(m: Sequence[int], deltas: torch.Tensor,
                     include_full_mixed: bool = True,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Eigenvalues of the stacked Gram D'D on the DCT-II basis, shape m,
    built by the JAX package's cancellation-free additive recurrence over
    axes (the closed form prod(d^2 + mu) - prod(d^2) cancels in float32
    near k = 0 and corrupts the pseudo-inverse).  Lambda(0) = 0 exactly."""
    m = tuple(int(v) for v in m)
    p = len(m)
    deltas = torch.as_tensor(deltas, dtype=dtype, device=device)

    def axis_mu(j):
        shape = [1] * p
        shape[j] = m[j]
        return neumann_eigenvalues(m[j], dtype, device).reshape(shape)

    d2s = [torch.square(deltas[j]) for j in range(p)]
    if include_full_mixed or p == 1:
        s = torch.zeros((1,) * p, dtype=dtype, device=device)
        z = torch.ones((), dtype=dtype, device=device)
        for j in range(p):
            mu = axis_mu(j)
            s = s * (d2s[j] + mu) + z * mu
            z = z * d2s[j]
        return s
    # Proper subsets (nonempty, not all-ones): the reference-Python set.
    s = torch.zeros((1,) * p, dtype=dtype, device=device)
    z = d2s[0] * torch.ones((1,) * p, dtype=dtype, device=device)
    o = axis_mu(0)
    for j in range(1, p):
        mu = axis_mu(j)
        s = s * (d2s[j] + mu) + z * mu + o * d2s[j]
        z = z * d2s[j]
        o = o * mu
    return s


def _dct_last(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II along the last axis through one complex FFT of
    the even/odd reordered sequence (Makhoul's algorithm)."""
    n = x.shape[-1]
    v = torch.cat([x[..., 0::2], torch.flip(x[..., 1::2], (-1,))], dim=-1)
    z = torch.fft.fft(v, dim=-1)
    ang = (-math.pi / (2 * n)) * torch.arange(n, dtype=x.dtype, device=x.device)
    y = z.real * torch.cos(ang) - z.imag * torch.sin(ang)
    return y * _ortho_weights(n, x.dtype, x.device)


def _idct_last(y: torch.Tensor) -> torch.Tensor:
    """Inverse of _dct_last (orthonormal DCT-III) along the last axis."""
    n = y.shape[-1]
    c = y / _ortho_weights(n, y.dtype, y.device)
    # z_k = exp(i pi k / 2n) (c_k - i c_{n-k}), c_n = 0; v = ifft(z)
    c_rev = torch.cat([torch.zeros_like(c[..., :1]), torch.flip(c[..., 1:], (-1,))], dim=-1)
    ang = (math.pi / (2 * n)) * torch.arange(n, dtype=y.dtype, device=y.device)
    cos, sin = torch.cos(ang), torch.sin(ang)
    z = torch.complex(c * cos + c_rev * sin, c * sin - c_rev * cos)
    v = torch.fft.ifft(z, dim=-1).real
    x = torch.empty_like(v)
    x[..., 0::2] = v[..., :(n + 1) // 2]
    x[..., 1::2] = torch.flip(v, (-1,))[..., :n // 2]
    return x


def _ortho_weights(n: int, dtype, device) -> torch.Tensor:
    w = torch.full((n,), math.sqrt(2.0 / n), dtype=dtype, device=device)
    w[0] = math.sqrt(1.0 / n)
    return w


def dct_along(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Orthonormal DCT-II along one axis through the FFT."""
    return _dct_last(x.movedim(axis, -1)).movedim(-1, axis)


def idct_along(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Orthonormal DCT-III along one axis, the inverse of dct_along."""
    return _idct_last(x.movedim(axis, -1)).movedim(-1, axis)


def _over_axes(x: torch.Tensor, fn) -> torch.Tensor:
    for ax in range(x.ndim):
        x = fn(x.movedim(ax, -1)).movedim(-1, ax)
    return x


def dctn(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II over all axes through the FFT (the JAX package's
    jax.scipy.fft.dctn(x, type=2, norm="ortho"))."""
    return _over_axes(x, _dct_last)


def idctn(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-III over all axes, the inverse of dctn."""
    return _over_axes(x, _idct_last)


def shifted_solve(b: torch.Tensor, c, rho, gram_eigs: torch.Tensor, mats=None) -> torch.Tensor:
    """Exact solve of (c I + rho D'D) x = b (c a scalar > 0) through the
    DCT: dense products with TF32 off, or the FFT transforms when mats is
    None."""
    with exact_f32_matmul():
        if mats is not None:
            return idctn_mat(dctn_mat(b, mats) / (c + rho * gram_eigs), mats)
        return idctn(dctn(b) / (c + rho * gram_eigs))


def dctn_mat_lp(x: torch.Tensor, mats_lp) -> torch.Tensor:
    """dctn_mat with bf16 operands and a bf16 result after every axis (the
    JAX package's dctn_mat on bf16 input and matrices,
    preferred_element_type = bf16)."""
    for t in mats_lp:
        x = _lp_dot(x, t, 1, torch.bfloat16)
    return x


def idctn_mat_lp(x: torch.Tensor, mats_lp) -> torch.Tensor:
    """Inverse of dctn_mat_lp, rounded the same way."""
    for t in mats_lp:
        x = _lp_dot(x, t, 0, torch.bfloat16)
    return x


def dct2_dense(v: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor) -> torch.Tensor:
    """T0 v T1' with bf16 operands and float32 sums: v and the first
    product rounded to bf16, as the one-kernel dense x-update takes its
    transforms (pallas_kernels.py:354-361)."""
    return _lp_dot(_lp_dot(v.to(torch.bfloat16), t0, 1, v.dtype).to(torch.bfloat16), t1, 1,
                   v.dtype)


def idct2_dense(v: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor) -> torch.Tensor:
    """T0' v T1, rounded as dct2_dense (pallas_kernels.py:363-370)."""
    return _lp_dot(_lp_dot(v.to(torch.bfloat16), t0, 0, v.dtype).to(torch.bfloat16), t1, 0,
                   v.dtype)


def gram_pinv_apply(b: torch.Tensor, gram_eigs: torch.Tensor, mats=None) -> torch.Tensor:
    """Exact (D'D)^+ b: invert the nonzero eigenvalues, drop the constant
    mode.  Dense products with TF32 off, or the FFT transforms when mats
    is None (lambda_max in float64, solver/path.py)."""
    with exact_f32_matmul():
        coeffs = dctn_mat(b, mats) if mats is not None else dctn(b)
        safe = torch.where(gram_eigs > 0, gram_eigs, torch.ones_like(gram_eigs))
        inv = torch.where(gram_eigs > 0, coeffs / safe, torch.zeros_like(coeffs))
        return idctn_mat(inv, mats) if mats is not None else idctn(inv)


# -- The large-lattice layouts of the spectral-correction CG (JAX
# ops/dct.py:287-418 blocked, :495-737 quartered).  Blocks are p-dim
# tensors; a product contracts a block's first axis and appends the
# transformed axis last (the JAX package's cyclic no-transpose order), so
# after p axes the block's axes are back in order.

def _lp_dot(a: torch.Tensor, t: torch.Tensor, t_dim: int, out_dtype) -> torch.Tensor:
    """dot_general(a, t, contract a's axis 0 with t's axis t_dim) with
    preferred_element_type = out_dtype.  bf16 operands are multiplied in
    float32 (TF32 on the card, exact for them) and the float32 sum is
    rounded to out_dtype once."""
    if a.dtype == t.dtype == torch.bfloat16:
        with bf16_value_products():
            out = torch.tensordot(a.float(), t.float(), dims=([0], [t_dim]))
        return out.to(out_dtype)
    return torch.tensordot(a, t.to(a.dtype), dims=([0], [t_dim])).to(out_dtype)


def _bit(bits: int, j: int, p: int) -> int:
    return (bits >> (p - 1 - j)) & 1


def to_blocks(x: torch.Tensor, p: int) -> Tuple[torch.Tensor, ...]:
    """Natural p-axis array -> 2^p natural-layout blocks: per axis, bit 0
    is the first half and bit 1 the second half flipped."""
    blocks = [x]
    for ax in range(p):
        new = []
        for a in blocks:
            h = a.shape[ax] // 2
            if 2 * h != a.shape[ax]:
                raise ValueError(f"to_blocks needs even axes, got {a.shape[ax]}")
            new.append(a.narrow(ax, 0, h))
            new.append(torch.flip(a.narrow(ax, h, h), (ax,)))
        blocks = new
    return tuple(blocks)


def from_blocks(blocks, p: int) -> torch.Tensor:
    """Inverse of to_blocks."""
    blocks = list(blocks)
    for ax in reversed(range(p)):
        blocks = [torch.cat([blocks[i], torch.flip(blocks[i + 1], (ax,))], dim=ax)
                  for i in range(0, len(blocks), 2)]
    return blocks[0]


def blocked_spectrum(eigs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Natural-frequency-order spectral array -> blocked layout: per axis,
    bit 0 keeps the even frequencies and bit 1 the odd ones."""
    blocks = [eigs]
    for j in range(eigs.ndim):
        new = []
        for a in blocks:
            sel = [slice(None)] * a.ndim
            for start in (0, 1):
                sel[j] = slice(start, None, 2)
                new.append(a[tuple(sel)].contiguous())
        blocks = new
    return tuple(blocks)


def dctn_blocked(blocks, halves, dtype=None) -> Tuple[torch.Tensor, ...]:
    """Natural-layout blocks -> spectral-layout blocks (orthonormal
    coefficients, even/odd frequencies per axis).  dtype: the products'
    result type (None: the blocks')."""
    p = len(halves)
    cur = list(blocks)
    dtype = blocks[0].dtype if dtype is None else dtype
    for j, (te, to) in enumerate(halves):
        md = te.dtype
        new = [None] * len(cur)
        for b0 in range(len(cur)):
            if _bit(b0, j, p):
                continue
            b1 = b0 | (1 << (p - 1 - j))
            a0, a1 = cur[b0], cur[b1]
            new[b0] = _lp_dot((a0 + a1).to(md), te, 1, dtype)
            new[b1] = _lp_dot((a0 - a1).to(md), to, 1, dtype)
        cur = new
    return tuple(cur)


def idctn_blocked(blocks, halves, dtype=None) -> Tuple[torch.Tensor, ...]:
    """Spectral-layout blocks -> natural-layout blocks (inverse of
    dctn_blocked)."""
    p = len(halves)
    cur = list(blocks)
    dtype = blocks[0].dtype if dtype is None else dtype
    for j, (te, to) in enumerate(halves):
        md = te.dtype
        new = [None] * len(cur)
        for b0 in range(len(cur)):
            if _bit(b0, j, p):
                continue
            b1 = b0 | (1 << (p - 1 - j))
            a = _lp_dot(cur[b0].to(md), te, 0, dtype)
            bb = _lp_dot(cur[b1].to(md), to, 0, dtype)
            new[b0] = a + bb
            new[b1] = a - bb
        cur = new
    return tuple(cur)


# Depth-2 fast DCT: per axis, the even/odd fold, a second fold of the even
# half and a Givens rotation of the odd (DCT-IV) half, four (n/4)^2
# products instead of two (n/2)^2.  Natural layout per axis: M0 = x[0:q],
# M1 = flip(x[q:2q]), M2 = x[2q:3q], M3 = flip(x[3q:4q]); spectral layout
# [EE, EO, OE, OO] = frequencies k mod 4 in QUARTER_FREQ_PATTERN.
QUARTER_FREQ_PATTERN = (0, 2, 1, 3)


def _cos_kernel_np(n: int, dct4: bool) -> np.ndarray:
    k = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    if dct4:
        return np.cos(np.pi * (2.0 * k + 1.0) * (2.0 * j + 1.0) / (4.0 * n))
    return np.cos(np.pi * k * (2.0 * j + 1.0) / (2.0 * n))


def dct_quarter_mats(n: int, dtype=torch.float32, device=None):
    """Per-axis operands of the depth-2 fast DCT: (C2q, V4q, C2qf, c1, s1,
    alt, w); w = the 4 orthonormalization weight vectors in block order."""
    if n % 4:
        raise ValueError(f"the quartered DCT needs n % 4 == 0, got {n}")
    q, h = n // 4, n // 2
    c2q = _cos_kernel_np(q, False)
    th = np.pi * (2.0 * np.arange(q) + 1.0) / (4.0 * h)
    wn = np.full(n, np.sqrt(2.0 / n))
    wn[0] = np.sqrt(1.0 / n)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return (t(c2q), t(_cos_kernel_np(q, True)), t(c2q[::-1, :]), t(np.cos(th)), t(np.sin(th)),
            t((-1.0) ** np.arange(q)), tuple(t(wn[k::4]) for k in QUARTER_FREQ_PATTERN))


def to_blocks4(x: torch.Tensor, p: int) -> Tuple[torch.Tensor, ...]:
    """Natural p-axis array -> 4^p M-layout blocks (digits M0..M3 per
    axis, see above)."""
    blocks = [x]
    for ax in range(p):
        new = []
        for a in blocks:
            n = a.shape[ax]
            if n % 4:
                raise ValueError(f"to_blocks4 needs axes divisible by 4, got {n}")
            q = n // 4
            qs = [a.narrow(ax, i * q, q) for i in range(4)]
            new += [qs[0], torch.flip(qs[1], (ax,)), qs[2], torch.flip(qs[3], (ax,))]
        blocks = new
    return tuple(blocks)


def from_blocks4(blocks, p: int) -> torch.Tensor:
    """Inverse of to_blocks4."""
    blocks = list(blocks)
    for ax in reversed(range(p)):
        new = []
        for i in range(0, len(blocks), 4):
            m0, m1, m2, m3 = blocks[i:i + 4]
            new.append(torch.cat([m0, torch.flip(m1, (ax,)), m2, torch.flip(m3, (ax,))],
                                 dim=ax))
        blocks = new
    return blocks[0]


def quartered_spectrum(eigs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Natural-frequency-order spectral array -> quartered layout (per-axis
    digit d keeps the frequencies k = QUARTER_FREQ_PATTERN[d] mod 4)."""
    blocks = [eigs]
    for j in range(eigs.ndim):
        new = []
        for a in blocks:
            sel = [slice(None)] * a.ndim
            for pat in QUARTER_FREQ_PATTERN:
                sel[j] = slice(pat, None, 4)
                new.append(a[tuple(sel)].contiguous())
        blocks = new
    return tuple(blocks)


def _shift(x: torch.Tensor, ax: int, down: bool) -> torch.Tensor:
    """down: y_t = x_{t-1} (y_0 = 0); else y_t = x_{t+1} (y_last = 0)."""
    n = x.shape[ax]
    zero = torch.zeros_like(x.narrow(ax, 0, 1))
    if down:
        return torch.cat([zero, x.narrow(ax, 0, n - 1)], dim=ax)
    return torch.cat([x.narrow(ax, 1, n - 1), zero], dim=ax)


def _groups(nblocks: int, stride: int):
    return [g for g in range(nblocks) if (g // stride) % 4 == 0]


def dctn_quartered(blocks, quarters, dtype=None) -> Tuple[torch.Tensor, ...]:
    """M-layout natural blocks -> [EE, EO, OE, OO]-per-axis spectral blocks
    (orthonormal coefficients).  dtype: the products' result type (None:
    the blocks'; the weights promote bf16 blocks to float32 after the
    first axis, the products keep this type)."""
    p = len(quarters)
    cur = list(blocks)
    dtype = blocks[0].dtype if dtype is None else dtype
    for ax, (c2q, v4q, c2qf, c1, s1, alt, w) in enumerate(quarters):
        md = c2q.dtype
        # acts along the block's axis 0 (a block may have more axes than
        # the transform: parallel/spectral.py transforms one axis at a time)
        dshape = (c1.shape[0],) + (1,) * (cur[0].ndim - 1)
        c1b, s1b, altb = c1.reshape(dshape), s1.reshape(dshape), alt.reshape(dshape)
        stride = 4 ** (p - 1 - ax)
        new = [None] * len(cur)
        for g in _groups(len(cur), stride):
            d0, d1, d2, d3 = (cur[g + k * stride] for k in range(4))
            e0, e1 = d0 - d3, d1 - d2
            ee = _lp_dot((d0 + d1 + d2 + d3).to(md), c2q, 1, dtype)
            eo = _lp_dot((d0 - d1 - d2 + d3).to(md), v4q, 1, dtype)
            ce = _lp_dot((c1b * e0 + s1b * e1).to(md), c2q, 1, dtype)
            se = _lp_dot((altb * (s1b * e0 - c1b * e1)).to(md), c2qf, 1, dtype)
            last = ee.ndim - 1
            new[g] = ee * w[0]
            new[g + stride] = eo * w[1]
            new[g + 2 * stride] = (ce - _shift(se, last, down=True)) * w[2]
            new[g + 3 * stride] = (_shift(ce, last, down=False) + se) * w[3]
        cur = new
    return tuple(cur)


def idctn_quartered(blocks, quarters, dtype=None) -> Tuple[torch.Tensor, ...]:
    """Inverse of dctn_quartered: spectral quartered blocks -> M-layout
    natural blocks."""
    p = len(quarters)
    cur = list(blocks)
    dtype = blocks[0].dtype if dtype is None else dtype
    for ax, (c2q, v4q, c2qf, c1, s1, alt, w) in enumerate(quarters):
        md = c2q.dtype
        dshape = (w[0].shape[0],) + (1,) * (cur[0].ndim - 1)
        wb = [wv.reshape(dshape) for wv in w]
        stride = 4 ** (p - 1 - ax)
        new = [None] * len(cur)
        for g in _groups(len(cur), stride):
            eew, eow, oew, oow = (cur[g + k * stride] * wb[k] for k in range(4))
            ce_a = oew + _shift(oow, 0, down=True)
            se_a = oow - _shift(oew, 0, down=False)
            ss_a = _lp_dot(eew.to(md), c2q, 0, dtype)
            sd_a = _lp_dot(eow.to(md), v4q, 0, dtype)
            u_a = _lp_dot(ce_a.to(md), c2q, 0, dtype)
            v_a = alt * _lp_dot(se_a.to(md), c2qf, 0, dtype)
            # the rotation's transpose: its diagonals act along the last axis
            spd, smd = ss_a + sd_a, ss_a - sd_a
            cu, su, cv, sv = c1 * u_a, s1 * u_a, c1 * v_a, s1 * v_a
            new[g] = spd + cu + sv
            new[g + stride] = smd + su - cv
            new[g + 2 * stride] = smd - su + cv
            new[g + 3 * stride] = spd - cu - sv
        cur = new
    return tuple(cur)
