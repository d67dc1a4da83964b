"""multivartv_tpu_torch: the PyTorch/CUDA port of multivartv_tpu.

Multivariate total-variation denoising on a lattice by ADMM, for one
NVIDIA H100.  The JAX package ``multivartv_tpu`` is the reference; this
package mirrors its layout (config, mesh, ops/, solver/, api) so each
module's counterpart is easy to find, and replaces its Pallas TPU kernels
with CUDA kernels written by hand for Hopper (``ops/kernels.py``, sources
in ``csrc/``, built by ``ops/_build.py`` at first use).

Idiom: plain functions on tensors, and frozen dataclasses holding tensors
for ``Operators``, ``Problem`` and ``ADMMState``.  The solver has no learned
parameters and no gradients, so ``nn.Module`` does not fit here.

Importing the package imports torch and numpy, never jax and never
matplotlib.  The port covers the cross-validated ``mvtv`` (``MVTVModel``,
with ``plot`` and ``plot_residuals``; ``plotting.py`` needs matplotlib),
``mvtv_one`` and ``predict_mvtv`` on 1-D (the exact tridiagonal x-update),
2-D, 3-D and higher lattices, under every solver profile of
``sibling_profile`` and both x-update arms of ``SolverConfig`` (``xla_packed``,
``spectral_cg``), on the default mesh or a user's ``mesh=`` (a lattice,
regular or not, or a point cloud; ``gen_mesh``, ``make_mesh_spec``); the
resumable lambda path ``solver.path.solve_path_checkpointed``
(``utils/checkpoint.py``, the JAX package's on-disk format); the sharded
fit on row slabs (``parallel.fit.mvtv_sharded``); and ``utils/``: metrics,
a profiler trace and timers (``profiling.py``), and the H100 roofline of
the kernels and the iteration (``roofline.py``).  See ROADMAP.md for the
rest.
"""

from multivartv_tpu_torch.api import MVTVModel, mvtv, mvtv_one, predict_mvtv, resolve_device
from multivartv_tpu_torch.config import (CVConfig, MeshConfig, PathConfig, SolverConfig,
                                         sibling_profile)
from multivartv_tpu_torch.mesh import MeshSpec, gen_mesh, make_mesh_spec

__all__ = ["mvtv", "MVTVModel", "mvtv_one", "predict_mvtv", "resolve_device", "SolverConfig",
           "PathConfig", "CVConfig", "MeshConfig", "sibling_profile", "MeshSpec",
           "make_mesh_spec", "gen_mesh"]
