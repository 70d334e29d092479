"""Multi-host initialization and mesh construction.

Single-host multi-device uses ``make_mesh`` directly. For meshes spanning
hosts, call ``init_multihost()`` once per process before any jax use; each
host then feeds its local channels/blocks (host-local ZMQ/USB ingest) while
the mesh spans every host's devices — the host network carries only
jax.distributed control traffic, sample data enters per-host, and the
device collectives carry the halo and smoother reductions (SURVEY.md §2.4
mapping).

The sharded runners are validated on virtual device meshes
(tests/test_parallel.py, tests/test_distributed.py); the multi-host path
follows the standard jax.distributed recipe.
"""

import os
from typing import Optional

import jax


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed from args or the standard env vars
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID); no-op when
    single-process."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", "0")
    )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(time: int, channel: int):
    """Mesh over all devices of all hosts (call after init_multihost)."""
    from coherent_rtlsdr_tpu.parallel.mesh import make_mesh

    return make_mesh(time, channel, devices=jax.devices())
