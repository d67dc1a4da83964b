"""mvtv_sharded at 16^4 on the 3-lambda grid from lambda_max, beside two
witnesses on the same grid and cap.

    python3 scripts/shard_grid_witness.py [--cap N] [--device cpu|cuda]
                                          [--fits shard,single,exact,cold]

The data are chip_smoke.py phase 16's C7 fit's (quad_data, n = 2^18, folds
1).  The fits:

  * shard:  mvtv_sharded, the default x-update (the spectral CG across
            ranks, on a group of one: this process alone);
  * single: the single card's mvtv (its spectralN route, the same
            spectral CG);
  * exact:  mvtv_sharded with SolverConfig(xla_packed=False), the exact
            float32 PCG on the slab;
  * cold:   the exact route's cold solve (use_kernels=False) at the grid's
            last lambda from rho0 = lambda_0 / 5, uncapped.

Each fit prints one JSON line: its iterations per lambda, its float64
objective at each lambda, its chosen index and its seconds.  On the CPU a
fit at the default cap of 3,000 takes about ten minutes on two threads;
run the fits as separate processes (--fits) to run them side by side.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from chip_smoke import model_objective, objective64, quad_data
from multivartv_tpu_torch import SolverConfig, mvtv
from multivartv_tpu_torch.api import _fit_configs, _fresh_solve, _lambda_grid, _setup
from multivartv_tpu_torch.config import DEFAULT_MESH
from multivartv_tpu_torch.parallel import fit as pfit

M = (16, 16, 16, 16)
N = 1 << 18
N_LAMBDA = 3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cap", type=int, default=3000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fits", default="shard,single,exact,cold")
    args = ap.parse_args()
    x, y = quad_data(N)
    fits = {
        "shard": lambda cfg: pfit.mvtv_sharded(x, y, m=M, folds=1, n_lambda=N_LAMBDA,
                                               solver_config=cfg, device=args.device),
        "single": lambda cfg: mvtv(x, y, m=M, folds=1, n_lambda=N_LAMBDA, solver_config=cfg,
                                   device=args.device),
        "exact": lambda cfg: pfit.mvtv_sharded(
            x, y, m=M, folds=1, n_lambda=N_LAMBDA, device=args.device,
            solver_config=SolverConfig(xla_packed=False, max_iters=cfg.max_iters)),
    }
    for name in args.fits.split(","):
        t0 = time.perf_counter()
        if name == "cold":
            cfg = SolverConfig(use_kernels=False)
            _, _, spec, _, _, ops, problem = _setup(x, y, M, None, cfg, DEFAULT_MESH,
                                                   args.device)
            path_config, _ = _fit_configs(N_LAMBDA, 1, None, None)
            grid, _ = _lambda_grid(ops, problem, None, path_config, False)
            grid = torch.as_tensor(grid, device=args.device)
            theta, fitted = _fresh_solve(ops, problem, grid[-1], grid[0] / 5.0, cfg)
            obj = objective64({"theta_lattice": theta.cpu().numpy(),
                               "fitted": fitted.cpu().numpy(), "y": y, "mesh_spec": spec,
                               "lambda": float(grid[-1])})
            out = {"lambda": float(grid[-1]), "objective": obj}
        else:
            model = fits[name](SolverConfig(max_iters=args.cap))
            out = {"lambdas": [float(v) for v in model.lambdas],
                   "iters": [int(mm["iters"]) for mm in model.models],
                   "objectives": [model_objective(model, i) for i in range(N_LAMBDA)],
                   "chosen": int(model.lambda_minmse_ind)}
        out.update(fit=name, cap=args.cap, device=args.device,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
