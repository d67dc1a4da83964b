"""Profiling and timing hooks.

Counterpart of ``multivartv_tpu/utils/profiling.py``: a profiler trace
context, a steady-state iterations/s measurement and a host-side phase
timer.  The JAX package traces with jax.profiler for TensorBoard; here
``trace`` runs torch.profiler over the CPU and, where a card is present,
CUDA, and writes a Chrome trace (chrome://tracing, Perfetto).  CUDA calls
return before the card finishes, so every clock read here follows a
``torch.cuda.synchronize()`` where CUDA is initialised.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the enclosed block, written on exit as
    ``<log_dir>/trace.json`` (a Chrome trace).  Yields the profiler, whose
    ``key_averages()`` sums the time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def measure_iterations_per_s(run_fixed: Callable[[object, int], object], state0,
                             warmup: int = 20, iters: int = 200) -> float:
    """iters / seconds of run_fixed(state, iters) after run_fixed(state0,
    warmup); run_fixed(state, k) runs k iterations from state and returns
    the new state.  The clock is read after a CUDA synchronize, so the
    time is the device's finish, not the host's enqueue."""
    state = run_fixed(state0, warmup)
    _sync()
    t0 = time.perf_counter()
    run_fixed(state, iters)
    _sync()
    return iters / (time.perf_counter() - t0)


class StepTimer:
    """Host-side accumulating timer of named phases (synchronizing CUDA at
    each phase's ends)."""

    def __init__(self):
        self.totals = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.totals[name] = self.totals.get(name, 0.0) + (time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        return "\n".join(f"{k:24s} {v:8.3f}s ({100 * v / total:5.1f}%)"
                         for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1]))


def lattice_tensors(shape) -> tuple:
    """(tensors, bytes): the live tensors whose trailing shape is `shape`,
    counted after a gc pass, and the bytes of their distinct storages."""
    import gc
    gc.collect()
    shape, n, storages = tuple(shape), 0, {}
    for o in gc.get_objects():
        if issubclass(type(o), torch.Tensor) and tuple(o.shape[-len(shape):]) == shape:
            n += 1
            st = o.untyped_storage()
            storages[(st.device, st.data_ptr())] = st.nbytes()
    return n, sum(storages.values())


# The lattice-sized operand sets of an Operators: the Gram eigenvalues in
# each layout the x-update divides by (solver/problem.py).
EIGEN_SETS = ("gram_eigs", "gram_eigs_packed", "gram_eigs_blocked", "gram_eigs_blocked_lp",
              "gram_eigs_quartered", "gram_eigs_quartered_lp")


def operand_shares(ops) -> dict:
    """{field: the set's bytes over the whole lattice's set's}: each
    eigenvalue set of ops (EIGEN_SETS) counted by bytes, since a set of
    2^p or 4^p half- or quarter-sized blocks is whole-lattice-sized though
    no tensor in it has the lattice's shape.  1.0 is a whole set."""
    out = {}
    for name in EIGEN_SETS:
        v = getattr(ops, name, None)
        if v is None:
            continue
        ts = v if isinstance(v, tuple) else (v,)
        whole = int(np.prod(ops.m)) * ts[0].element_size()
        out[name] = sum(t.numel() * t.element_size() for t in ts) / whole
    return out


@contextlib.contextmanager
def solve_census(shape, first_only: bool = False):
    """Takes ``lattice_tensors(shape)`` and the solve's ``operand_shares``
    as each ADMM solve of the enclosed block starts (before its first
    iteration), or as the first one starts under first_only.  Yields the
    list of censuses, one (tensors, bytes, shares) a solve, and the seconds
    the censuses took (a one-element list)."""
    from ..solver import admm
    solve, seen, seconds = admm.admm_solve, [], [0.0]

    def census(*args, **kwargs):
        if not (first_only and seen):
            t0 = time.perf_counter()
            ops = args[0] if args else kwargs["ops"]
            seen.append(lattice_tensors(shape) + (operand_shares(ops),))
            seconds[0] += time.perf_counter() - t0
        return solve(*args, **kwargs)

    admm.admm_solve = census
    try:
        yield seen, seconds
    finally:
        admm.admm_solve = solve
