"""The sharded p = 3 PCG's slab matvec (kernels.gram_matvec_tiled_3d_shard)
on one H100: its time, for an A/B of two trees on one card.

    python3 scripts/slab_matvec_ab.py ROOT [--tag T]

ROOT is a tree that holds ``multivartv_tpu_torch`` (this repo's, a
``git archive`` of another commit, or a copy with the kernel's tile
constants changed); the package is imported from there and its kernels
built.  It times the one-rank slab at 256^3 and 256 x 256 x 64 (random v,
Poisson(0.25) counts): CUDA events over 50 calls, twice, and the device
time per call by torch.profiler, with the card's name and power limit.
Run the trees in turns (A, B, B, A) within one call.  The matvec's check
against its plain version and B13 is chip_smoke.py's (phase 3,
check_matvec3)."""
import os
import subprocess
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
import torch
from multivartv_tpu_torch.ops import kernels as K

dev = torch.device("cuda", 0)
tag = sys.argv[sys.argv.index("--tag") + 1] if "--tag" in sys.argv else root
gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
t0 = time.time()
K._lib()
print(f"[{tag}] build+load {time.time() - t0:.1f} s; {gpu}", flush=True)
g = torch.Generator(device=dev).manual_seed(7)
sc = (0.6, 1.1, 0.8, 0.9, 1.3, 0.7, 0.5)
rho = torch.tensor(0.37, device=dev)


def inputs(m, lam=0.25):
    v = torch.randn(m, generator=g, device=dev)
    c = torch.poisson(torch.full(m, lam, device=dev), generator=g)
    return v, c


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
    return us / 1e3 / n, [(e.key[:60], e.count) for e in ev]


for m in ((256, 256, 256), (256, 256, 64)):
    v, c = inputs(m)
    z = torch.zeros((1,) + m[1:], device=dev)     # the one-rank slab's halo planes
    a = (v, z, z, 0, m[0], c, rho, sc)
    run = lambda: K.gram_matvec_tiled_3d_shard(*a)
    ms = [timeit(run), timeit(run)]
    dms, ks = device_ms(run)
    print(f"[{tag}] matvec {m} one-rank slab: CUDA events {ms[0]:.4f} / {ms[1]:.4f} ms, device "
          f"{dms:.4f} ms {ks}; {gpu}", flush=True)
