"""Multi-process bring-up: torch.distributed process groups for the sharded fit.

Counterpart of ``multivartv_tpu/parallel/distributed.py``.  Every process
runs the same program; ``init_distributed`` brings up the default process
group, and ``global_lattice_mesh`` returns the row group over all of its
ranks, which ``parallel.fit.mvtv_sharded`` cuts the lattice over.  The
backend follows the device and is never chosen silently: NCCL for a CUDA
device (a CUDA device without NCCL raises), gloo for ``device="cpu"`` (the
parity dry run on the CPU, the counterpart of the JAX package's virtual
CPU devices).  Nothing tells a process of a cluster: the caller gives the
rendezvous, its world size and its rank, or sets the ``env://`` variables
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).

Typical multi-process fit, one process per card:

    from multivartv_tpu_torch.parallel import distributed, fit, sharding
    distributed.init_distributed("tcp://localhost:29500", world_size=4, rank=r,
                                 device=f"cuda:{r}")
    model = fit.mvtv_sharded(x, y, m=(4096, 4096), device=f"cuda:{r}")

On four cards a (dp, sx, 1) mesh splits the CV folds over dp and the
lattice over sx (2 x 2 here; (4, 1, 1) runs one fold per card):

    mesh = sharding.make_device_mesh((2, 2, 1), ("dp", "sx", "sy"))
    model = fit.mvtv_sharded(x, y, m=(1024, 1024), folds=4, device_mesh=mesh,
                             device=f"cuda:{r}")
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# Every process group gets a timeout, so that a rank that never arrives
# fails the others instead of hanging them.
TIMEOUT = datetime.timedelta(seconds=300)


def backend_for(device) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU; raises otherwise, and
    for a CUDA device when this PyTorch has no NCCL."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("the sharded fit on CUDA needs NCCL, which this PyTorch lacks")
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {dev}")


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, device="cuda",
                     timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Initialize the default process group once (a no-op on re-entry, and
    for a single process with no rendezvous given or set in the
    environment).  Returns True when more than one process takes part.
    A CUDA device with an index becomes the process's current card before
    the group comes up: NCCL runs every collective and point-to-point call
    on the current card (one card per rank)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None and world_size is None and rank is None:
        if not all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
            return False
        init_method = "env://"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(device), init_method=init_method,
                            world_size=world_size, rank=rank, timeout=timeout)
    return dist.get_world_size() > 1


def global_lattice_mesh(p: int, dp: int = 1):
    """(row group, axis names) over every rank of the default group: the
    layout of parallel/fit.py::default_lattice_mesh (any p; axis 0 cut over
    sx = ranks / dp, the CV folds over dp; ("dp", "sx") at p = 1 and ("dp",
    "sx", "sy") above)."""
    from multivartv_tpu_torch.parallel.fit import default_lattice_mesh
    return default_lattice_mesh(p, dp=dp)


def process_summary() -> dict:
    """Host-side report of the distributed runtime."""
    up = dist.is_available() and dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 0,
        "backend": dist.get_backend() if up else None,
    }
