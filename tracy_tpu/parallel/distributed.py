"""Multi-host execution helpers.

The reference is strictly single-process (SURVEY.md §2.7). Here multi-host
rendering is the same `shard_map` program over a mesh that spans hosts:
`jax.distributed.initialize` wires the processes, the ('data','sample')
mesh covers the global device set, scene arrays are replicated to every
host's devices, each host feeds/holds only its own shards of the image,
and the pmean/psum collectives run between processes.

Usage (same program on every host):

    from tracy_tpu.parallel.distributed import initialize_multihost, host_rows
    initialize_multihost("localhost:12345", 2, 0)  # explicit cluster
    mesh = make_render_mesh(n_data, n_sample)   # spans ALL hosts' devices
    step = make_sharded_render_step(cfg, mesh)  # identical on every host
    # Feed with jax.make_array_from_callback using host_rows() so each host
    # materializes only its shard of the accumulator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax

from tracy_tpu.utils.log import log


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed (no-op on single process).

    Pass all three arguments where nothing in the environment describes
    the cluster (a plain GPU or CPU host); with none, JAX looks for a
    cluster it knows. Returns True when running multi-process.
    """
    try:
        if coordinator_address is not None:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        else:
            jax.distributed.initialize()
    except Exception as e:  # single-process runs raise / are already init'ed
        log(f"jax.distributed not initialized ({e}); single-process mode")
        return False
    return jax.process_count() > 1


def host_rows(height: int, mesh) -> Tuple[int, int]:
    """The [start, end) global image rows materialized by THIS host when the
    accumulator is sharded over the mesh's 'data' axis."""
    nd = mesh.shape["data"]
    rows_per = height // nd
    # Devices along 'data' owned by this process determine its row span.
    mine = [
        i for i in range(nd)
        if any(d.process_index == jax.process_index() for d in mesh.devices[i].flat)
    ]
    if not mine:
        return (0, 0)
    return (min(mine) * rows_per, (max(mine) + 1) * rows_per)
