"""Multi-host (DCN) runtime glue: init + scene broadcast.

SURVEY §2.5/§5: the reference has no distributed backend; the
equivalent here is the standard JAX multi-host runtime — device
collectives inside a host (parallel.tile_sharding), the network only for bringing every
process to the same scene. Scene flattening is host-side Python (OBJ
import, BVH build, atlas packing), so in a multi-host job only process 0
flattens and the resulting buffer pytree is broadcast; everything after
that is the normal sharded frame pipeline.

Single-process (the common case, incl. tests and the one-chip bench)
degrades to identity: `initialize()` is a no-op and `broadcast_scene`
returns the local buffers.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the JAX multi-host runtime (jax.distributed). No-op when
    unconfigured single-process (the driver/test environment)."""
    if num_processes is None and coordinator_address is None:
        return  # single-process: nothing to initialize
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def is_leader() -> bool:
    return jax.process_index() == 0


def broadcast_scene(buffers):
    """Broadcast the flattened scene pytree from process 0 over DCN.

    Non-leader processes may pass a zero-filled pytree of the right
    shapes (they never need to run the flattener). Single-process:
    returns `buffers` unchanged."""
    if jax.process_count() == 1:
        return buffers
    from jax.experimental import multihost_utils

    return multihost_utils.broadcast_one_to_all(buffers)


def build_and_broadcast(scene):
    """Flatten the scene graph and force every process onto the LEADER'S
    buffers. Each process runs the same SPMD host program, so all of them
    can flatten (broadcast_one_to_all needs matching pytree structure);
    the broadcast guarantees the device buffers are bit-identical across
    hosts even if host libm/BVH tie-breaks ever diverge."""
    from ..ops.buffers import build_scene_buffers

    return broadcast_scene(build_scene_buffers(scene))
