"""Device-mesh construction (SURVEY.md §2.4).

Axes:
  data  — embarrassingly-parallel pixel/ray tiles (the SIMT-over-fragments
          parallelism the GPU gave the reference implicitly)
  model — spatial voxel-brick sharding for 512^3+ grids (parallel/brick.py);
          also used to shard voxelization surface samples

Multi-host: jax.distributed.initialize() before calling make_mesh; the mesh
spans all processes' devices and XLA hands collectives to NCCL (NVLink
within a host).  There is no hand-written transport layer —
the reference has none either (single GPU); scaling is mesh + shardings.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """A ('data', 'model') mesh. n_data=None uses all remaining devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        if len(devices) % n_model:
            raise ValueError(
                f"{len(devices)} devices not divisible by n_model={n_model}")
        n_data = len(devices) // n_model
    need = n_data * n_model
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_data, n_model)
    return Mesh(arr, axis_names=("data", "model"))


def make_mesh_for(cfg, devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Mesh from VCTConfig.sharding: ('data', 'model') with
    data_parallel x brick_parallel devices (BASELINE config 5 shape)."""
    return make_mesh(n_data=cfg.sharding.data_parallel,
                     n_model=cfg.sharding.brick_parallel,
                     devices=devices)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Multi-host entry: initialize the JAX coordination service.

    Call once per process before make_mesh*; afterwards jax.devices()
    spans every host's devices and the mesh/collectives go through NCCL
    (SURVEY.md §2.4 comm-backend row).

    Args default from the standard env vars (COORDINATOR_ADDRESS,
    NUM_PROCESSES, PROCESS_ID) when omitted; on single-process runs with
    none of those set this is a no-op.  Returns the process count.
    """
    import os

    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        return 1                                   # single-process run
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    return jax.process_count()


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def rays_sharding(mesh: Mesh) -> NamedSharding:
    """Image rows sharded over 'data' (tile-DP)."""
    return NamedSharding(mesh, P("data"))


def samples_sharding(mesh: Mesh) -> NamedSharding:
    """Voxelization surface samples sharded over 'model': each model shard
    splats its samples; XLA all-reduces the partial grids."""
    return NamedSharding(mesh, P("model"))


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad axis 0 so sharded dims divide evenly; returns (padded, orig_len)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(np.asarray(x), widths), n
