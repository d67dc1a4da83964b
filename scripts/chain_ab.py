"""B4 and B5 (kernels.admm_iters_2d, admm_iters_2d_batched: K whole ADMM
iterations a call) on one H100, for an A/B of two trees on one card.

    python3 scripts/chain_ab.py ROOT [--tag T] [--e2e]

ROOT is a tree that holds ``multivartv_tpu_torch`` (this repo's, or a
``git archive`` of another commit unpacked into a directory that
.gitignore lists); the package is imported from there and its kernels
built.  On the main path's launch sizes (B4 at 512^2 and 1024^2, B5 at
316^2 with B = 5; K = 4, n_steps = 3; the DCT operators of a lattice of
that size, a seeded random state, Poisson(2) counts) it prints, with the
card's name and power limit: CUDA-event ms per call (two runs of 50 calls;
B5 updates its state in place from call to call), torch.profiler device
ms and kernels per call, and a digest of one call's outputs from a fixed
state, so that two trees show whether they give the same bits.  --e2e
adds 400 admm_fixed_iterations at 512^2 (iterations/s, the bench_data
problem at lambda = 0.05) and the wall time of mvtv(x, y) at 316^2 (n =
1e5 bivariate-exp data, 5 folds, 20 lambdas).  Run the trees in turns (A,
B, B, A) within one call.  The kernels' checks against their plain
versions are chip_smoke.py's (phase 3)."""
import hashlib
import os
import subprocess
import sys
import time

import numpy as np

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
import torch
from multivartv_tpu_torch.config import SolverConfig
from multivartv_tpu_torch.ops import kernels as K
from multivartv_tpu_torch.solver.problem import build_operators

dev = torch.device("cuda", 0)
tag = sys.argv[sys.argv.index("--tag") + 1] if "--tag" in sys.argv else root
gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.time()
K._lib()
print(f"[{tag}] build+load {time.time() - t0:.1f} s; torch {torch.__version__}; {gpu}",
      flush=True)


def timeit(fn, n=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, n=20):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    us = sum(float(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0))
             for e in ev)
    kernels = sum(e.count for e in ev) / n
    return us / 1e3 / n, kernels, [(e.key[:50], e.count) for e in ev]


def digest(out):
    h = hashlib.sha256()
    for t in out:
        for x in (t if isinstance(t, (tuple, list)) else (t,)):
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def inputs(m, batch):
    g = torch.Generator(device=dev).manual_seed(11)
    ops = build_operators(m, (2.0 / (m[0] - 1), 2.0 / (m[1] - 1)), SolverConfig(), dev)
    lead = (batch,) if batch > 1 else ()
    state = [torch.randn(*lead, *m, device=dev, generator=g)]
    state += [torch.randn(*lead, *m, device=dev, generator=g) * 0.1 for _ in range(6)]
    counts = torch.poisson(torch.full((*lead, *m), 2.0, device=dev), generator=g)
    oty = torch.randn(*lead, *m, device=dev, generator=g) * counts
    return ops, state, counts, oty


def scalar(x, batch):
    return torch.full(() if batch == 1 else (batch,), x, dtype=torch.float32, device=dev)


for label, m, batch in (("B4 512^2 K=4", (512, 512), 1), ("B5 316^2 B=5 K=4", (316, 316), 5),
                        ("B4 1024^2 K=4", (1024, 1024), 1)):
    ops, state, counts, oty = inputs(m, batch)
    cbar = scalar(float(counts.mean()), batch)
    lam, rho, us = scalar(0.05, batch), scalar(0.4, batch), scalar(1.0, batch)
    scratch = {}
    if batch == 1:
        run = lambda: K.admm_iters_2d(state[0], state[1:4], state[4:7], counts, oty,
                                      ops.dct_halves_lp, ops.gram_eigs_packed, lam, rho, us,
                                      cbar, ops.scales, k_iters=4, n_steps=3, scratch=scratch)
        bits = digest(run())
    else:
        start = [s.clone() for s in state]
        run = lambda: K.admm_iters_2d_batched(state[0], state[1:4], state[4:7], counts, oty,
                                              ops.dct_halves_lp, ops.gram_eigs_packed, lam, rho,
                                              us, cbar, ops.scales, k_iters=4, n_steps=3,
                                              scratch=scratch)
        bits = digest(run())
        for s, s0 in zip(state, start):
            s.copy_(s0)
    ms = [timeit(run), timeit(run)]
    dms, kpc, ks = device_ms(run)
    print(f"[{tag}] {label}: CUDA events {ms[0]:.4f} / {ms[1]:.4f} ms per call, device "
          f"{dms:.4f} ms in {kpc:.1f} kernels per call {ks}; digest {bits}; {gpu}", flush=True)
    del ops, state, counts, oty, scratch

if "--e2e" in sys.argv:
    from multivartv_tpu_torch import mvtv
    from multivartv_tpu_torch.api import _resolve_mesh
    from multivartv_tpu_torch.config import DEFAULT_MESH
    from multivartv_tpu_torch.solver import admm
    from multivartv_tpu_torch.solver.problem import build_problem

    rng = np.random.RandomState(0)
    x, y = rng.uniform(-1, 1, (1 << 20, 2)), rng.randn(1 << 20)
    spec = _resolve_mesh(x, (512, 512), DEFAULT_MESH, dev)
    ops = build_operators(spec.m, spec.deltas, SolverConfig(), dev)
    problem = build_problem(spec, torch.as_tensor(x, dtype=torch.float32, device=dev),
                            torch.as_tensor(y, dtype=torch.float32, device=dev))
    lam = torch.tensor(0.05, dtype=torch.float32, device=dev)
    s0 = admm.initial_state(ops, problem, lam)
    run = lambda: admm.admm_fixed_iterations(ops, problem, lam, s0, SolverConfig(), 400)
    rates = [400 / (timeit(run, 3) / 1e3) for _ in range(2)]
    print(f"[{tag}] admm_fixed_iterations 512^2 x 400: {rates[0]:.1f} / {rates[1]:.1f} "
          f"iterations/s; {gpu}", flush=True)

    rng = np.random.RandomState(117)
    x = rng.uniform(-1, 1, (100_000, 2))
    y = np.exp(-(x[:, 0] ** 2 + x[:, 1] ** 2)) + rng.randn(100_000) * 0.3
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mvtv(x, y, n_lambda=20, folds=5, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"[{tag}] mvtv 316^2 n=1e5 folds=5 n_lambda=20: wall "
          f"{' / '.join(f'{w:.3f}' for w in walls)} s (the first with set-up); {gpu}",
          flush=True)
