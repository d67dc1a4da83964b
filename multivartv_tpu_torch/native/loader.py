"""Build and load the host kd-tree and binning (``native/nearest.cpp``) with ctypes.

Counterpart of ``multivartv_tpu/native/loader.py``: the nearest-neighbour
searches, the closed-form binning of a regular lattice (``bin_regular``,
exported as the JAX package exports it; the port bins on the device) and
``available``.  The library is compiled by g++ at first use, never at
import, into ``multivartv_tpu_torch/_build/native-<hash>/``, keyed by a
hash of the source and the flags:

    g++ -O3 -fPIC -std=c++17 -shared -o libmvtv_nearest.so nearest.cpp

without ``-march=native``, so the library runs on any x86-64 host, and
without OpenMP, whose runtime a toolchain may lack (the queries run on one
thread).  A failed build raises: the point-cloud path never switches to
the brute force on its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "nearest.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "libmvtv_nearest.so"
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (set CXX): the kd-tree cannot be built")
    return cxx


def build() -> Path:
    """Compile the library unless a build of the same source exists."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_DIR / f"native-{h.hexdigest()[:16]}"
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        tmp = os.path.join(tmp_dir, LIB_NAME)
        proc = subprocess.run([_compiler(), *FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded library with its signatures set (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            pd, pi = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)
            for fn in (lib.mvtv_nearest_kdtree, lib.mvtv_nearest_brute):
                fn.argtypes = [pd, ctypes.c_int64, pd, ctypes.c_int64, ctypes.c_int32, pi]
                fn.restype = ctypes.c_int
            pl = ctypes.POINTER(ctypes.c_int64)
            lib.mvtv_bin_regular.argtypes = [pd, ctypes.c_int64, ctypes.c_int32, pd, pd, pl, pl]
            lib.mvtv_bin_regular.restype = ctypes.c_int
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here (the entry points raise
    where it does not)."""
    try:
        load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _nearest(name: str, data, mesh) -> np.ndarray:
    data = np.ascontiguousarray(data, dtype=np.float64)
    if data.ndim == 1:
        data = data[:, None]
    mesh = np.ascontiguousarray(mesh, dtype=np.float64)
    if mesh.ndim == 1:
        mesh = mesh[:, None]
    n, p = data.shape
    if mesh.shape[1] != p:
        raise ValueError(f"data has {p} columns but the mesh {mesh.shape[1]}")
    out = np.empty(n, np.int32)
    pd, pi = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)
    rc = getattr(load(), name)(data.ctypes.data_as(pd), n, mesh.ctypes.data_as(pd),
                               mesh.shape[0], p, out.ctypes.data_as(pi))
    if rc != 0:
        raise ValueError(f"{name} refused its inputs (data {data.shape}, mesh {mesh.shape})")
    return out


def nearest_kdtree(data, mesh) -> np.ndarray:
    """The nearest mesh row of every data row (float64; ties to the lowest
    row index), int32 (n,), through the kd-tree."""
    return _nearest("mvtv_nearest_kdtree", data, mesh)


def nearest_brute(data, mesh) -> np.ndarray:
    """nearest_kdtree by the reference's exact scan."""
    return _nearest("mvtv_nearest_brute", data, mesh)


def bin_regular(data, knot0, spacing, dims) -> np.ndarray:
    """The C-order flat index of every data row's nearest knot on a regular
    lattice, int64 (n,), in float64: knot0 and spacing per axis (an axis
    of one knot, or spacing 0, bins to index 0), dims the lattice's m;
    ties at a midpoint to the lower index, indices clipped to the
    lattice (the JAX package's ``native.bin_regular``)."""
    data = np.ascontiguousarray(data, dtype=np.float64)
    if data.ndim == 1:
        data = data[:, None]
    n, p = data.shape
    knot0 = np.ascontiguousarray(knot0, dtype=np.float64).reshape(-1)
    spacing = np.asarray(spacing, np.float64).reshape(-1)
    dims = np.ascontiguousarray(dims, dtype=np.int64).reshape(-1)
    if not knot0.shape == spacing.shape == dims.shape == (p,):
        raise ValueError(f"data has {p} columns; knot0 {knot0.shape}, spacing "
                         f"{spacing.shape} and dims {dims.shape} must have one entry each")
    inv_h = np.divide(1.0, spacing, out=np.zeros_like(spacing), where=spacing > 0)
    out = np.empty(n, np.int64)
    pd, pl = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
    rc = load().mvtv_bin_regular(data.ctypes.data_as(pd), n, p, knot0.ctypes.data_as(pd),
                                 inv_h.ctypes.data_as(pd), dims.ctypes.data_as(pl),
                                 out.ctypes.data_as(pl))
    if rc != 0:
        raise ValueError(f"mvtv_bin_regular refused its inputs (data {data.shape})")
    return out
