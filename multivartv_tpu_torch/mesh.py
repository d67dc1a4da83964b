"""Lattice and point-cloud meshes, and nearest-knot indexing.

Counterpart of ``multivartv_tpu/mesh.py``.  A lattice mesh is per-axis
knot vectors plus TV cell sizes (``MeshSpec``): nearest-knot lookup is the
closed form of ``nearest_knot_multi_index`` on evenly spaced axes and a
``searchsorted`` on irregular ones (a user's ``mesh=``, e.g. the 1-D fused
lasso's mesh = x); an exact midpoint goes to the lower index, as the
reference's index_min scan does (utils.cpp:275).  Any other user mesh is a
``PointCloudMeshSpec``: (ntheta, p) points whose row k is lattice node k
in the reference's order (gen_mesh, solvers.cpp:233-244), searched by
nearest neighbour (ops/interp.py).  Flat orders appear only at the API
boundary, where the reference's axis-0-fastest layout (tensor2vector,
utils.cpp:45-57) is reproduced.  Knots, points and data are float32, as in
the JAX package, so the two bin samples identically, float32 knots that
coincide included.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from multivartv_tpu_torch.config import DEFAULT_MESH, MeshConfig


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A p-dim lattice: per-axis knots (ascending) and the (p,) TV cell
    sizes, all on one device.  regular: every axis is evenly spaced, which
    allows the closed-form nearest-knot index."""

    knots: Tuple[torch.Tensor, ...]
    deltas: torch.Tensor
    m: Tuple[int, ...]
    regular: bool = True

    @property
    def ndim(self) -> int:
        return len(self.m)

    @property
    def ntheta(self) -> int:
        return int(np.prod(self.m))


@dataclasses.dataclass(frozen=True)
class PointCloudMeshSpec:
    """An arbitrary (non-lattice) user mesh: (ntheta, p) knot coordinates
    in the reference's axis-0-fastest row order.  Nearest-neighbour
    assignment uses the points; D acts on the m-lattice of row indices
    (utils.cpp:245-252)."""

    points: torch.Tensor
    deltas: torch.Tensor
    m: Tuple[int, ...]

    @property
    def ndim(self) -> int:
        return len(self.m)

    @property
    def ntheta(self) -> int:
        return int(np.prod(self.m))


def _dims(m) -> Tuple[int, ...]:
    return tuple(int(v) for v in np.ravel(m))


def _resolve(device):
    from multivartv_tpu_torch.api import resolve_device
    return resolve_device(device)


def ref_flat_to_multi(flat_ref: np.ndarray, m: Sequence[int]) -> np.ndarray:
    """Reference-order (axis 0 fastest) flat indices as (n, p)
    multi-indices: the inverse of flat_index_ref."""
    m = _dims(m)
    out = np.empty((len(flat_ref), len(m)), np.int64)
    rem = np.asarray(flat_ref, np.int64).copy()
    for j, mj in enumerate(m):
        out[:, j] = rem % mj
        rem //= mj
    return out


def _linspace32(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
    """jnp.linspace(lo, hi, num) in float32: lo (1 - t) + hi t with
    t = i / (num - 1), the last knot hi."""
    if num == 1:
        return lo.reshape(1)
    t = torch.arange(num - 1, dtype=torch.float32, device=lo.device) / float(num - 1)
    return torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])


def make_mesh_spec(data, m: Sequence[int], *, config: MeshConfig = DEFAULT_MESH,
                   device="cuda") -> MeshSpec:
    """A regular MeshSpec over [min - eps, max + eps] of every axis, in
    float32 (create_mesh, utils.cpp:234-254); deltas (range + 2 eps) / m_j
    ("cpp") or the knot spacing ("py"; create_deltas, utils.cpp:256-263)."""
    dev = _resolve(device)
    data = torch.as_tensor(np.asarray(data), dtype=torch.float32, device=dev)
    if data.ndim == 1:
        data = data[:, None]
    m = _dims(m)
    if len(m) != data.shape[1]:
        raise ValueError(f"m has {len(m)} entries but data has {data.shape[1]} columns")
    knots, deltas = [], []
    for j, mj in enumerate(m):
        lo = torch.min(data[:, j]) - config.eps
        hi = torch.max(data[:, j]) + config.eps
        knots.append(_linspace32(lo, hi, mj))
        deltas.append((hi - lo) / (mj if config.delta_mode == "cpp" else max(mj - 1, 1)))
    return MeshSpec(knots=tuple(knots), deltas=torch.stack(deltas), m=m, regular=True)


def mesh_spec_from_points(points, m: Sequence[int], deltas=None, *, validate: bool = True,
                          device="cuda") -> MeshSpec:
    """A user's (ntheta, p) mesh matrix as a lattice: its per-axis knots,
    checked to be strictly increasing and, with validate, to rebuild the
    matrix in axis-0-fastest order; deltas default to the knot spacing.
    Raises ValueError where the matrix is no such lattice."""
    points = np.asarray(points)
    m = _dims(m)
    p, ntheta = len(m), int(np.prod(m))
    if points.shape != (ntheta, p):
        raise ValueError(f"mesh has shape {points.shape}, expected {(ntheta, p)}")
    knots, regular, stride = [], True, 1
    for j in range(p):
        kj = np.asarray(points[: stride * m[j]: stride, j])
        knots.append(kj)
        stride *= m[j]
        if m[j] > 2:
            sp = np.diff(kj)
            if not np.allclose(sp, sp[0], rtol=1e-5, atol=1e-8):
                regular = False
        if np.any(np.diff(kj) <= 0):
            raise ValueError(f"mesh axis {j} knots are not strictly increasing")
    knots32 = tuple(torch.tensor(k, dtype=torch.float32) for k in knots)
    if validate:
        rebuilt = lattice_points(knots32, m).numpy()
        if not np.allclose(rebuilt, points, rtol=1e-5, atol=1e-7):
            raise ValueError("user mesh is not a lattice in axis-0-fastest order; "
                             "supply per-axis knots or a lattice mesh")
    if deltas is None:
        deltas = [(k[-1] - k[0]) / max(len(k) - 1, 1) for k in knots]
    dev = _resolve(device)
    return MeshSpec(knots=tuple(k.to(dev) for k in knots32),
                    deltas=torch.as_tensor(np.asarray(deltas, np.float64), dtype=torch.float32,
                                           device=dev).reshape(p),
                    m=m, regular=regular)


def lattice_points(knots: Sequence[torch.Tensor], m: Sequence[int]) -> torch.Tensor:
    """(ntheta, p) knot coordinates in the reference's axis-0-fastest order
    (create_mesh, utils.cpp:245-252)."""
    m = _dims(m)
    total = int(np.prod(m))
    cols = []
    before = 1
    for j, mj in enumerate(m):
        col = torch.repeat_interleave(knots[j], before)
        cols.append(col.repeat(total // (before * mj)))
        before *= mj
    return torch.stack(cols, dim=1)


def gen_mesh(data, m: Sequence[int], mesh=None, *, config: MeshConfig = DEFAULT_MESH,
             device="cuda") -> torch.Tensor:
    """The reference's gen_mesh (solvers.cpp:233-244): the (ntheta, p) knot
    matrix in its order, float32 on ``device``.  A given mesh is returned
    as it is, once it has passed mesh_spec_from_points' lattice check."""
    dev = _resolve(device)
    m = _dims(m)
    if mesh is not None:
        mesh_spec_from_points(mesh, m, device="cpu")
        return torch.as_tensor(np.asarray(mesh), dtype=torch.float32, device=dev)
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    knots = [torch.as_tensor(np.linspace(data[:, j].min() - config.eps,
                                         data[:, j].max() + config.eps, m[j]),
                             dtype=torch.float32, device=dev) for j in range(len(m))]
    return lattice_points(knots, m)


def nearest_knot_multi_index(spec: MeshSpec, data: torch.Tensor) -> torch.Tensor:
    """Per-axis nearest-knot indices, shape (n, p) int64: the closed form on
    a regular lattice, else a searchsorted; an exact midpoint goes to the
    lower index, and of knots that coincide the first takes the samples."""
    if data.ndim == 1:
        data = data[:, None]
    idxs = []
    for j, mj in enumerate(spec.m):
        kj = spec.knots[j]
        x = data[:, j]
        if mj == 1:
            idxs.append(torch.zeros(x.shape, dtype=torch.int64, device=x.device))
            continue
        if spec.regular:
            h = (kj[-1] - kj[0]) / (mj - 1)
            t = (x - kj[0]) / h
            i = torch.floor(t)
            idx = i.to(torch.int64) + ((t - i) > 0.5).to(torch.int64)
        else:
            hi = torch.searchsorted(kj.contiguous(), x.contiguous(), right=False)
            hi = hi.clamp(1, mj - 1)
            lo = hi - 1
            pick_hi = (kj[hi] - x) < (x - kj[lo])    # strict: a tie goes to lo
            idx = torch.where(pick_hi, hi, lo)
        idxs.append(idx.clamp(0, mj - 1))
    return torch.stack(idxs, dim=1)


def _strides(m: Sequence[int], c_order: bool) -> torch.Tensor:
    m = _dims(m)
    s = np.ones(len(m), np.int64)
    if c_order:
        for j in range(len(m) - 2, -1, -1):
            s[j] = s[j + 1] * m[j + 1]
    else:
        for j in range(1, len(m)):
            s[j] = s[j - 1] * m[j - 1]
    return torch.as_tensor(s)


def flat_index_c(multi_idx: torch.Tensor, m: Sequence[int]) -> torch.Tensor:
    """C-order (last axis fastest) flat index: internal lattice addressing."""
    return (multi_idx * _strides(m, True).to(multi_idx.device)).sum(dim=1)


def flat_index_ref(multi_idx: torch.Tensor, m: Sequence[int]) -> torch.Tensor:
    """Reference-order (axis 0 fastest) flat index."""
    return (multi_idx * _strides(m, False).to(multi_idx.device)).sum(dim=1)


def flatten_ref_order(theta: torch.Tensor) -> torch.Tensor:
    """Lattice array -> the reference's axis-0-fastest vector layout."""
    return theta.permute(*reversed(range(theta.ndim))).reshape(-1)


def unflatten_ref_order(vec: torch.Tensor, m: Sequence[int]) -> torch.Tensor:
    """The inverse of flatten_ref_order."""
    m = _dims(m)
    return vec.reshape(tuple(reversed(m))).permute(*reversed(range(len(m))))
