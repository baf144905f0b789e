"""Multi-process setup: jax.distributed + (hosts, rows) meshes.

The reference has no inter-node code at all (SURVEY.md §2.5); this is the
net-new multi-process layer. On one host the cards are joined all to all
(NVLink), so a 1-D mesh (dist/sharding.make_row_mesh) is the whole
topology and nothing here is needed. Across processes:

  * `initialize()` wraps jax.distributed.initialize; the coordinator
    address, process count and process id come from the arguments or
    the HSPMV_COORDINATOR / HSPMV_NUM_PROCESSES / HSPMV_PROCESS_ID
    environment variables (nothing is autodetected).
  * `make_hybrid_mesh()` builds a 2-D ("hosts", "rows") mesh, one row of
    the mesh per process. SpMV row-shards over the flattened axes, so
    only the two boundary shards of each process exchange halo rows
    with another process.
  * Simulation: under XLA_FLAGS=--xla_force_host_platform_device_count=N
    a single process presents N CPU devices; `make_hybrid_mesh` reshapes
    them the same way, so multi-process schedules compile and run in
    tests.
"""

from __future__ import annotations

import os

import numpy as np


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed when running multi-process.

    Returns True if distributed mode is active, False for single-process
    (the common single-host benchmark path; everything still works on
    the local devices). Safe to call twice.
    """
    import jax

    if num_processes is None:
        num_processes = int(os.environ.get("HSPMV_NUM_PROCESSES", "0")) or None
    if coordinator_address is None:
        coordinator_address = os.environ.get("HSPMV_COORDINATOR") or None
    if process_id is None:
        pid = os.environ.get("HSPMV_PROCESS_ID")
        process_id = int(pid) if pid is not None else None

    if num_processes in (None, 1) and coordinator_address is None:
        return False  # single-process
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True
    except RuntimeError as e:
        if "already initialized" in str(e):
            return True
        raise


def make_hybrid_mesh(
    axis_hosts: str = "hosts",
    axis_rows: str = "rows",
    num_hosts: int | None = None,
):
    """(hosts, rows) mesh: one mesh row per process.

    Single-process (or simulated-CPU) setups get hosts=1 by default;
    num_hosts overrides the shape so single-process simulations (virtual
    CPU devices) can exercise the exact (hosts, rows) schedule a
    multi-process run would compile. Row sharding uses PartitionSpec((axis_hosts,
    axis_rows)) so the row axis spans both — see dist.sharding.
    spmv_sharded's tuple-axis support.
    """
    import jax
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices())
    if num_hosts is None:
        num_hosts = max(jax.process_count(), 1)
    per_host = devices.shape[0] // num_hosts
    mesh_devices = devices[: num_hosts * per_host].reshape(num_hosts, per_host)
    return Mesh(mesh_devices, (axis_hosts, axis_rows))


def row_spec(axis_hosts: str = "hosts", axis_rows: str = "rows"):
    """PartitionSpec sharding rows over both mesh axes (hosts-major)."""
    from jax.sharding import PartitionSpec as P

    return P((axis_hosts, axis_rows))
