"""Multi-process start-up for renders that span hosts.

The reference is single-process/single-GPU. A render sharded over the
cards of one host needs nothing from here: ``parallel.sharding`` builds
its mesh from ``jax.devices()``. Several processes (one per host or per
card) first join one JAX runtime with :func:`init_distributed`; the same
sharded renders then run over ``jax.devices()`` of all processes.
"""

from __future__ import annotations

import os

import jax


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed from args or the standard env vars.

    Returns True if a multi-process runtime was initialized, False when
    running single-process (no-op). Safe to call unconditionally at
    program start. On GPU hosts nothing detects a cluster, so the
    coordinator address (``host:port``), the process count and this
    process's id must all be given, as arguments or as
    ``DIRT_COORDINATOR`` / ``DIRT_NUM_PROCESSES`` / ``DIRT_PROCESS_ID``.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "DIRT_COORDINATOR"
    )
    num = num_processes if num_processes is not None else int(
        os.environ.get("DIRT_NUM_PROCESSES", "0")
    )
    pid = process_id if process_id is not None else int(
        os.environ.get("DIRT_PROCESS_ID", "-1")
    )
    if coordinator_address is None and num <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num if num > 0 else None,
        process_id=pid if pid >= 0 else None,
    )
    return True
