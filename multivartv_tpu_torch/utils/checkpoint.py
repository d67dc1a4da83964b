"""Checkpoint and resume of a lambda path.

Counterpart of ``multivartv_tpu/utils/checkpoint.py``, with its on-disk
format: after each chunk of lambdas, the warm-start carry (theta, alpha,
u, rho) goes to ``path_state_<index>.npz``, the chunk's per-lambda results
to ``path_res_<lo>_<hi>.npz``, and ``manifest.json`` names the newest
carry.  u is stored scale-free (u_scale folded in), so a state restores
with u_scale = 1, and the counters and norms restart as between two
lambdas of a path.  The port's own fields of ``ADMMState`` (the tiled
routes' dta/dtu carries and the route counters) are never written: the
next solve seeds the carries again (``admm._seed_adjoints``).  So a
directory written by the JAX package resumes here, and one written here
resumes there.  Every file is written to a temporary name and renamed.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from multivartv_tpu_torch.solver.admm import ADMMState


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flatten_state(state: ADMMState) -> Dict[str, np.ndarray]:
    out = {"theta": _host(state.theta), "rho": _host(state.rho)}
    for i, a in enumerate(state.alpha):
        out[f"alpha_{i}"] = _host(a)
    scale = _host(state.u_scale)
    for i, u in enumerate(state.u):
        out[f"u_{i}"] = scale * _host(u)
    return out


def _write_atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def save_path_state(directory: str, state: ADMMState, lambda_index: int,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write the warm-start carry after lambda_index and point the manifest
    at it; returns the state file's path."""
    os.makedirs(directory, exist_ok=True)
    arrays = _flatten_state(state)
    arrays["n_blocks"] = np.asarray(len(state.alpha))
    path = os.path.join(directory, f"path_state_{lambda_index:05d}.npz")
    _write_atomic(path, lambda f: np.savez(f, **arrays))
    manifest = {"lambda_index": int(lambda_index), "file": os.path.basename(path),
                "meta": meta or {}}
    _write_atomic(os.path.join(directory, "manifest.json"),
                  lambda f: f.write(json.dumps(manifest).encode()))
    return path


def save_path_results(directory: str, lo: int, hi: int,
                      arrays: Dict[str, Any]) -> str:
    """Write the per-lambda results of the chunk [lo, hi) (None entries
    left out), so that a resumed path returns the whole merged path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"path_res_{lo:05d}_{hi:05d}.npz")
    host = {k: _host(v) for k, v in arrays.items() if v is not None}
    _write_atomic(path, lambda f: np.savez(f, **host))
    return path


def load_path_results(directory: str, upto: int) -> Optional[list]:
    """The saved chunk results that cover lambdas [0, upto) one after
    another (a list of dicts of numpy arrays, in order), or None where they
    do not (a directory written before results were saved).  A chunk that
    runs past upto is cut at upto, so a manifest pointed at a lambda inside
    a chunk resumes without repeating lambdas (the JAX package returns the
    whole chunk there)."""
    if upto <= 0:
        return []
    if not os.path.isdir(directory):
        return None
    chunks = []
    for name in os.listdir(directory):
        if name.startswith("path_res_") and name.endswith(".npz"):
            try:
                lo, hi = name[len("path_res_"):-len(".npz")].split("_")
                chunks.append((int(lo), int(hi), name))
            except ValueError:
                continue
    chunks.sort()
    out, pos = [], 0
    for lo, hi, name in chunks:
        if lo != pos:
            return None
        with np.load(os.path.join(directory, name)) as z:
            keep = min(hi, upto) - lo
            out.append({k: z[k][:keep] for k in z.files})
        pos = hi
        if pos >= upto:
            return out
    return out if pos >= upto else None


def latest_checkpoint(directory: str) -> Optional[Tuple[int, str]]:
    """(lambda index, state file) that the manifest names, or None."""
    mpath = os.path.join(directory, "manifest.json")
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        manifest = json.load(f)
    return manifest["lambda_index"], os.path.join(directory, manifest["file"])


def load_path_state(directory: str, like: ADMMState) -> Optional[Tuple[ADMMState, int]]:
    """(state, lambda index) of the newest checkpoint as a warm-start carry
    in like's type and on its device, or None without one: u_scale 1,
    counters 0, norms 1 and eps 0 (as between two lambdas of a path), no
    dta/dtu carries."""
    found = latest_checkpoint(directory)
    if found is None:
        return None
    idx, path = found
    dtype, dev = like.theta.dtype, like.theta.device

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    with np.load(path) as z:
        n_blocks = int(z["n_blocks"])
        theta = tensor(z["theta"])
        alpha = tuple(tensor(z[f"alpha_{i}"]) for i in range(n_blocks))
        u = tuple(tensor(z[f"u_{i}"]) for i in range(n_blocks))
        rho = tensor(z["rho"]).reshape(())
    one = torch.ones((), dtype=dtype, device=dev)
    state = dataclasses.replace(
        like, theta=theta, alpha=alpha, u=u, rho=rho, counter=0, cg_iters=0,
        primal_norm=one, dual_norm=one, eps_primal=one * 0.0, eps_dual=one * 0.0,
        u_scale=one, chunked_iters=0, exact_iters=0, escaped=False, dta=None, dtu=None)
    return state, idx
