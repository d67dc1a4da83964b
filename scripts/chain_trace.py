"""Where a call of B4/B5's persistent kernel (csrc/chain.cu) spends its
time, stage by stage, on one H100; and the call's time at each grid size.

    python3 scripts/chain_trace.py [--grids]

Builds a copy of the kernel library with MVTV_CHAIN_TRACE defined (into
multivartv_tpu_torch/_build/trace/), which records the global timer at
every grid barrier: the latest arrival of any CTA and CTA 0's leaving, and
CTA 0's clock.  For B4 at 512^2 and 1024^2 and B5 at 316^2 with B = 5 (K =
4, n_steps = 3; the DCT operators of the lattice, a seeded random state,
Poisson(2) counts, as scripts/chain_ab.py) it prints, for each of an
iteration's 20 stages averaged over the 4 iterations of one warm call: the
span (the latest arrival less the previous barrier's leaving) and the
barrier (CTA 0's leaving less the latest arrival), in microseconds.  The
trace adds a few instructions a barrier; time the kernel with
scripts/chain_ab.py.  It also prints the registers and the SASS
instructions of the kernel.  --grids times the untraced kernel (CUDA
events, 50 calls) at the grid chain_plan picks, at one CTA an SM and at
every resident CTA; results do not depend on the grid (their digests are
printed).  With the card's name and power limit."""
import ctypes
import hashlib
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import torch
from multivartv_tpu_torch.config import SolverConfig
from multivartv_tpu_torch.ops import _build
from multivartv_tpu_torch.ops import kernels as K
from multivartv_tpu_torch.solver.problem import build_operators

dev = torch.device("cuda", 0)
gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
READER = r'''
extern "C" int mvtv_chain_trace_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, mvtv::g_chain_trace, sizeof(mvtv::g_chain_trace));
  static unsigned long long zero[4][1024];
  cudaMemcpyToSymbol(mvtv::g_chain_trace, zero, sizeof(zero));
  return int(e);
}
'''
STAGES = ["R", "P1", "P2", "P3", "P4", "M", "U", "P1", "P2", "P3", "P4", "M", "U", "P1", "P2",
          "P3", "P4", "M", "U last", "dual"]


def run(cmd):
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(" ".join(cmd) + "\n" + p.stdout + p.stderr)
    return p.stdout + p.stderr


def build_traced():
    """The library with the trace (chain.cu with MVTV_CHAIN_TRACE and the
    trace reader); returns its path and ptxas's and cuobjdump's report of
    the traced and the plain kernel."""
    out = _build.BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    src = _build.CSRC_DIR
    chain = out / "chain.cu"
    chain.write_text((src / "chain.cu").read_text() + READER)
    others = sorted(p for p in src.glob("*.cu") if p.name != "chain.cu")
    jobs = [(p, out / (p.stem + ".o"), []) for p in others]
    jobs += [(chain, out / "chain_trace.o", ["-DMVTV_CHAIN_TRACE"]),
             (src / "chain.cu", out / "chain_plain.o", [])]
    with ThreadPoolExecutor(len(jobs)) as ex:
        logs = list(ex.map(lambda j: run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", *j[2], "-I",
                                          str(src), "-c", "-o", str(j[1]), str(j[0])]), jobs))
    lib = out / "libtrace.so"
    run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(lib), str(out / "chain_trace.o"),
         *(str(j[1]) for j in jobs[:-2])])
    report = {}
    for name, log, obj in (("traced", logs[-2], out / "chain_trace.o"),
                           ("plain", logs[-1], out / "chain_plain.o")):
        regs = [l.strip() for l in log.splitlines() if "Used" in l][-1]
        sass = run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", str(obj)])
        body = sass[sass.index("admm_chain_kernel"):]
        count = len(re.findall(r"/[*][0-9a-f]{4,}[*]/", body))
        report[name] = f"{regs}; {count} SASS instructions"
    return lib, report


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


def make_run(case):
    (m, batch), (ops, state, counts, oty) = case
    cbar = scalar(float(counts.mean()), batch)
    lam, rho, us = scalar(0.05, batch), scalar(0.4, batch), scalar(1.0, batch)
    scratch = {}
    if batch == 1:
        return lambda: K.admm_iters_2d(state[0], state[1:4], state[4:7], counts, oty,
                                       ops.dct_halves_lp, ops.gram_eigs_packed, lam, rho, us,
                                       cbar, ops.scales, k_iters=4, n_steps=3, scratch=scratch)
    return lambda: K.admm_iters_2d_batched(state[0], state[1:4], state[4:7], counts, oty,
                                           ops.dct_halves_lp, ops.gram_eigs_packed, lam, rho,
                                           us, cbar, ops.scales, k_iters=4, n_steps=3,
                                           scratch=scratch)


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


def digest(out):
    h = hashlib.sha256()
    for t in out:
        for x in (t if isinstance(t, (tuple, list)) else (t,)):
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def use(lib_path):
    _build._lib = ctypes.CDLL(str(lib_path))
    K._configured = False
    K._OCCUPANCY.clear()


CASES = {"B4 512^2 K=4": ((512, 512), 1), "B5 316^2 B=5 K=4": ((316, 316), 5),
         "B4 1024^2 K=4": ((1024, 1024), 1)}

t0 = time.time()
plain_lib = _build.build()
lib_path, report = build_traced()
print(f"built in {time.time() - t0:.1f} s; plain kernel: {report['plain']}; traced: "
      f"{report['traced']}; {gpu}", flush=True)
cases = {label: (mb, inputs(*mb)) for label, mb in CASES.items()}

if "--grids" in sys.argv:
    use(plain_lib)
    plan = K.chain_plan
    per_sm, sms = K._chain_occupancy(dev)
    for label, case in cases.items():
        (m, batch), (ops, state, counts, oty) = case
        start = [s.clone() for s in state]
        p = plan(batch, *m, per_sm, sms)
        most = batch * max(p["quad_items"], p["dual_items"], 2 * p["fold_mh"] * p["fold_n"],
                           p["fold_m"] * p["fold_n"])
        res = []
        for name, grid in (("chain_plan", p["grid"]), ("1 an SM", min(sms, most)),
                           (f"{per_sm} an SM", min(per_sm * sms, most))):
            K.chain_plan = lambda *args, grid=grid: dict(plan(*args), grid=grid)
            run = make_run(case)
            bits = digest(run())
            for s, s0 in zip(state, start):
                s.copy_(s0)
            ms = [timeit(run), timeit(run)]
            for s, s0 in zip(state, start):
                s.copy_(s0)
            res.append(f"{name} (grid {grid}): {ms[0]:.4f} / {ms[1]:.4f} ms [{bits}]")
        K.chain_plan = plan
        print(f"  {label}: " + "; ".join(res) + f"; {gpu}", flush=True)

use(lib_path)
_build._lib.mvtv_chain_trace_read.argtypes = [ctypes.c_void_p]
for label, case in cases.items():
    run = make_run(case)
    buf = np.zeros((4, 1024), dtype=np.uint64)
    for _ in range(5):
        run()
    torch.cuda.synchronize()
    _build._lib.mvtv_chain_trace_read(buf.ctypes.data)
    run()
    torch.cuda.synchronize()
    _build._lib.mvtv_chain_trace_read(buf.ctypes.data)
    buf = buf.astype(np.float64)
    n = K.chain_barriers(4, 3)
    fin, ex = buf[0][:n], buf[1][:n]
    start = buf[1][1023]
    span = (fin - np.concatenate([[start], ex[:-1]])) / 1e3
    bar = (ex - fin) / 1e3
    total = (ex[-1] - start) / 1e3
    (m, batch), _ = case
    grid = K.chain_plan(batch, *m, *K._chain_occupancy(dev))["grid"]
    print(f"  trace {label} (grid {grid}): {total:.1f} us to the last barrier; per stage, the "
          f"mean of the 4 iterations, span / barrier in us:", flush=True)
    rows = []
    for pos, name in enumerate(STAGES):
        idx = [1 + pos + 20 * k for k in range(4) if 1 + pos + 20 * k < n]
        rows.append(f"{name} {np.mean(span[idx]):.2f} / {np.mean(bar[idx]):.2f}")
    print("    " + "; ".join(rows) + f"; set-up {span[0]:.2f} / {bar[0]:.2f}; {gpu}",
          flush=True)
