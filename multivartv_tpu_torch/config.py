"""Configuration dataclasses for the PyTorch port.

Counterpart of ``multivartv_tpu/config.py``: the solver, the lambda path,
cross-validation and the mesh, with the JAX package's names and defaults.
Defaults are the reference C++ behaviour: Boyd stopping at TOL=1e-4
(rcpp-code .../solvers.cpp:110-122), adaptive rho with tau=2 and a 10x band
(solvers.cpp:77-94), iteration cap 3000 (solvers.cpp:103), EPS=1e-4 mesh
padding (utils.hpp:14).  ``sibling_profile`` returns the bundles of the
reference's sibling implementations.

Renamed from the JAX package:
  * ``use_pallas`` -> ``use_kernels``: True runs the hand-written CUDA
    kernels (ops/kernels.py) on the lattice routes; False selects the
    exact-f32 per-iteration route, the explicit comparison arm.

``xla_packed`` and ``spectral_cg`` keep the JAX names: they pick the
x-update of the routes that run the folded bf16 DCT (the tiled, tiled3 and
spectral routes, and the whole route where no dense DCT matrices exist;
solver/xupdate.py), while the route's kernels stay on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

X_SOLVERS = ("dct_pcg", "jacobi_pcg", "dct_direct", "cg")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Single-lambda ADMM solver configuration (see the JAX package's
    SolverConfig for the reference citations of each field)."""

    tol: float = 1e-4
    max_iters: int = 3000
    # Adaptive rho (solvers.cpp:77-94); False keeps rho fixed, the
    # reference Python prototype's rule.
    adapt_rho: bool = True
    adapt_tau: float = 2.0
    adapt_band: float = 10.0
    # rho /= adapt_tau_shrink when the dual residual dominates; None =
    # adapt_tau (the symmetric C++ rule).  The standalone C++ sibling grows
    # x20 and shrinks /10 at band 20 (cpp-code/solvers.cpp:71-88).
    adapt_tau_shrink: Optional[float] = None
    # The x-update's linear solve: "dct_pcg" (DCT-preconditioned CG),
    # "jacobi_pcg", "dct_direct" (exact only for equal counts) or "cg".
    x_solver: str = "dct_pcg"
    # Tolerance and step cap of the tolerance-driven PCG x-updates.
    cg_tol: float = 1e-6
    cg_max_iters: int = 100
    # Fixed PCG step count of the kernel x-update (None = 3).
    cg_fixed_iters: Optional[int] = None
    # Hand-written CUDA kernels for the lattice routes (see module doc).
    use_kernels: bool = True
    # The dense-DCT preconditioner of the fused-dot PCG x-update
    # (gram_matvec_2d's route) in bfloat16 products instead of float32.
    precond_bf16: bool = False
    # Finish with exact-f32 transforms when the bf16-preconditioned solve
    # stalls on its residual floor (solver/admm.py::_stalled_while).
    bf16_residual_escape: bool = True
    # The x-update of the routes that run the folded bf16 DCT
    # (xupdate.xla_packed_applies): True = the bf16 fixed-step PCG on the
    # folded DCT; False = the exact float32 tolerance-driven DCT-PCG
    # (cg_tol, cg_max_iters) with the route's kernels kept on, the
    # comparison arm of the matched-objective gates.  The whole route's
    # kernels B3-B7 do not read it.
    xla_packed: bool = True
    # Where xla_packed applies: True = the CG in the spectral domain as a
    # correction solve from the exact float32 r0 (D'D diagonal there);
    # False = the fixed-step PCG in the natural domain, its preconditioner
    # the bf16 packed DCT (JAX xupdate.py:489-500).
    spectral_cg: bool = True
    # Convergence-check cadence of the kernel chain: None = AUTO_CHUNK.
    chunk_iters: Optional[int] = None
    # Store the spectral-correction CG's block vectors in bfloat16 (dots
    # still sum in float32, r0 stays exact float32): None = on above 2^23
    # knots, as in the JAX package (solver/xupdate.py::spectral_vec_dtype).
    spectral_vec_bf16: Optional[bool] = None
    include_full_mixed: bool = True
    # "boyd": relative primal/dual residuals (solvers.cpp:110-122);
    # "theta_inf": max |theta - theta_old| <= tol (the reference Python
    # prototype, code/solvers.py:69).
    stop_rule: str = "boyd"
    # The row group of a sharded fit, a key into parallel/tiled_shard.py's
    # registry (set by parallel.fit.mvtv_sharded): operators cut to its
    # row slabs run the solver's shard route.  None: no sharding.
    tiled_shard_key: Optional[int] = None

    def __post_init__(self):
        if self.x_solver not in X_SOLVERS:
            raise ValueError(f"unknown x_solver: {self.x_solver!r}")
        if self.stop_rule not in ("boyd", "theta_inf"):
            raise ValueError(f"unknown stop_rule: {self.stop_rule!r}")


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """Lambda-grid configuration (create_lambdas, solvers.cpp:186-200;
    lam_max_pinv, utils.cpp:351-355)."""

    n_lambda: int = 100
    lambda_min_ratio: float = 1e-4
    # lambda_max = lam_max_scale * ||D (D'D)^+ O'y||_inf ("cpp",
    # utils.cpp:354), or that norm times prod(deltas) ("py",
    # code/solvers.py:116).
    lam_max_mode: str = "cpp"
    lam_max_scale: float = 5.0
    # What the path records: "fitted" keeps the per-lambda theta and fitted
    # values (the reference keeps full models, solvers.cpp:292-302), "mse"
    # only the per-lambda MSEs.
    store: str = "fitted"
    # Warm-start theta, u and rho from the previous lambda (solvers.cpp:212-219).
    warm_start: bool = True

    def __post_init__(self):
        if self.lam_max_mode not in ("cpp", "py"):
            raise ValueError(f"unknown lam_max_mode: {self.lam_max_mode!r}")
        if self.store not in ("fitted", "mse"):
            raise ValueError(f"unknown store: {self.store!r}")


@dataclasses.dataclass(frozen=True)
class CVConfig:
    """K-fold cross-validation: fold labels are shuffled i mod k
    (kfoldinds, utils.cpp:367-376; solver/cv.py), each fold solves the
    warm-started path on its training samples, and the full data is refit
    at the lambda of least mean held-out MSE (solvers.cpp:305-376).
    vmap_folds: solve the folds together as one batch (B5) instead of one
    after another."""

    folds: int = 5
    seed: int = 123
    vmap_folds: bool = True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """eps: domain padding.  delta_mode: the TV cell size along axis j is
    (range + 2 eps) / m_j ("cpp", create_deltas, utils.cpp:256-263) or the
    knot spacing (range + 2 eps) / (m_j - 1) ("py", code/utils.py:187)."""

    eps: float = 1e-4
    delta_mode: str = "cpp"

    def __post_init__(self):
        if self.delta_mode not in ("cpp", "py"):
            raise ValueError(f"unknown delta_mode: {self.delta_mode!r}")


DEFAULT_SOLVER = SolverConfig()
DEFAULT_PATH = PathConfig()
DEFAULT_CV = CVConfig()
DEFAULT_MESH = MeshConfig()


def sibling_profile(name: str):
    """(SolverConfig, PathConfig, MeshConfig) of a reference sibling
    (SURVEY.md section 0; the JAX package's sibling_profile):

      "rcpp"           - the production R package: the defaults.
      "python"         - the scipy prototype: theta_inf stopping at 1e-3,
                         fixed rho, the reduced block set, lambda_max x
                         prod(deltas), EPS = 0.01, knot-spacing deltas
                         (code/solvers.py:15-78, code/utils.py:145,183).
      "cpp_standalone" - the Armadillo port: theta_inf stopping at 1e-3,
                         rho grown x20 / shrunk /10 at band 20, unscaled
                         lambda_max, grid ratio 1e-5, cap 2000, EPS = 0.01
                         (cpp-code/solvers.cpp:71-88, 187; utils.cpp:14).

    rho0 and u0 are run-time choices: the python and cpp_standalone
    siblings start from rho0 = lambda and u = 1/lambda
    (solver/admm.py::initial_state(u_fill=))."""
    if name == "rcpp":
        return SolverConfig(), PathConfig(), MeshConfig()
    if name == "python":
        return (SolverConfig(stop_rule="theta_inf", adapt_rho=False, tol=1e-3,
                             include_full_mixed=False, max_iters=5000),
                PathConfig(lam_max_mode="py"),
                MeshConfig(eps=0.01, delta_mode="py"))
    if name == "cpp_standalone":
        return (SolverConfig(stop_rule="theta_inf", tol=1e-3, max_iters=2000, adapt_rho=True,
                             adapt_tau=20.0, adapt_tau_shrink=10.0, adapt_band=20.0),
                PathConfig(lam_max_mode="cpp", lam_max_scale=1.0, lambda_min_ratio=1e-5),
                MeshConfig(eps=0.01))
    raise ValueError(f"unknown sibling profile: {name!r} (expected rcpp | python | "
                     "cpp_standalone)")
