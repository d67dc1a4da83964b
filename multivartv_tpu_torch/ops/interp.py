"""The interpolation matrix O as gather and scatter-add.

Counterpart of ``multivartv_tpu/ops/interp.py``: with one nearest knot per
sample, O theta is a gather, O'v a scatter-add onto the lattice and O'O =
diag(counts).  On a point-cloud mesh the nearest knot is the nearest row
of the user's points (``pointcloud_flat_c_indices``).  On CUDA ``index_add_`` adds with atomics, so the float
sums of O'y come out in a run-dependent order: counts stay exact
(integers), O'y may differ in its last bits from run to run.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from multivartv_tpu_torch import mesh as mesh_lib
from multivartv_tpu_torch.mesh import PointCloudMeshSpec
from multivartv_tpu_torch.ops import dct as dct_ops


def flat_knot_indices(spec, data) -> torch.Tensor:
    """Per-sample C-order flat index of the nearest knot, shape (n,): on a
    lattice (MeshSpec) by nearest_knot_multi_index, on a point cloud by
    pointcloud_flat_c_indices."""
    if isinstance(spec, PointCloudMeshSpec):
        return pointcloud_flat_c_indices(spec, data)
    multi = mesh_lib.nearest_knot_multi_index(spec, data)
    return mesh_lib.flat_index_c(multi, spec.m)


def pointcloud_flat_c_indices(spec: PointCloudMeshSpec, data) -> torch.Tensor:
    """The nearest mesh row of every sample of a point-cloud mesh, as a
    C-order flat lattice index (int64, on the points' device).  Host numpy
    data goes through the kd-tree (native/loader.py, float64); a tensor
    through nearest_pointcloud_indices on its device (float32)."""
    if isinstance(data, np.ndarray):
        from multivartv_tpu_torch.native import loader
        idx_ref = loader.nearest_kdtree(data, spec.points.cpu().numpy())
        multi = torch.as_tensor(mesh_lib.ref_flat_to_multi(idx_ref, spec.m),
                                device=spec.points.device)
        return mesh_lib.flat_index_c(multi, spec.m)
    rem = nearest_pointcloud_indices(data, spec.points)
    cols = []
    for mj in spec.m:
        cols.append(rem % mj)
        rem = rem // mj
    return mesh_lib.flat_index_c(torch.stack(cols, dim=1), spec.m)


def gather_fitted(theta: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """O theta: the fitted value of every sample."""
    return theta.reshape(-1)[flat_idx]


def gather_fitted_batch(theta: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """(B, n) fitted values of a batch of B lattices; flat_idx is (B, n) or
    shared (n,)."""
    flat = theta.reshape(theta.shape[0], -1)
    return flat[:, flat_idx] if flat_idx.ndim == 1 else torch.gather(flat, 1, flat_idx)


def scatter_to_lattice(values: torch.Tensor, flat_idx: torch.Tensor,
                       m: Sequence[int]) -> torch.Tensor:
    """O'v: per-sample values added onto the lattice (shape m)."""
    m = tuple(int(v) for v in m)
    out = torch.zeros(int(np.prod(m)), dtype=values.dtype, device=values.device)
    return out.index_add_(0, flat_idx, values).reshape(m)


def knot_counts(flat_idx: torch.Tensor, m: Sequence[int], weights=None,
                dtype=torch.float32) -> torch.Tensor:
    """diag(O'O): the number of samples at every knot, or the sum of the
    per-sample weights (a CV fold's 0/1 training mask)."""
    w = (torch.ones(flat_idx.shape, dtype=dtype, device=flat_idx.device) if weights is None
         else weights.to(dtype))
    return scatter_to_lattice(w, flat_idx, m)


def nearest_pointcloud_indices(data: torch.Tensor, mesh_points: torch.Tensor,
                               chunk: int = 4096) -> torch.Tensor:
    """Brute-force nearest neighbour of each data row among the (ntheta, p)
    rows of an arbitrary point cloud (reference nearest1, utils.cpp:280-287),
    as ||x||^2 - 2 x . mesh' + ||mesh||^2 over chunks of ``chunk`` rows, in
    float32 with TF32 off.  Ties go to the first (lowest) row, as
    index_min does.  Returns int64 (n,)."""
    if data.ndim == 1:
        data = data[:, None]
    if mesh_points.ndim == 1:
        mesh_points = mesh_points[:, None]
    mesh_sq = torch.sum(torch.square(mesh_points), dim=1)
    out = []
    with dct_ops.exact_f32_matmul():
        for x in torch.split(data, chunk):
            d = (torch.sum(torch.square(x), dim=1, keepdim=True)
                 - 2.0 * torch.matmul(x, mesh_points.T) + mesh_sq[None, :])
            out.append(torch.argmin(d, dim=1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64, device=data.device)
