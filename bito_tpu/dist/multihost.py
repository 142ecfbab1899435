"""Multi-host distributed backend (SURVEY §5.8 / §2 P6).

The reference has no distributed layer at all; this is the new framework's
communication backend: `jax.distributed` initialization, a global device
mesh whose single data axis is site patterns (DP over alignment columns),
and placement helpers that work across processes.  Within a slice the
collectives ride ICI; across hosts they ride DCN — XLA inserts them when a
jitted program consumes pattern-sharded operands and produces replicated
outputs (one psum per per-edge/per-root reduction).

Topology: every host loads the same (small) alignment and tree data, so
global arrays are built with `jax.make_array_from_callback` — each process
fills exactly the shards that live on its local devices, no host-to-host
data movement is needed at setup.  DAG structure, model parameters, branch
lengths, and q stay replicated; per-pattern tensors (tips, weights, PLVs)
are sharded.

Launch recipe (2 hosts):
    # host 0
    python train.py --coordinator=host0:8476 --num-hosts=2 --host-id=0
    # host 1
    python train.py --coordinator=host0:8476 --num-hosts=2 --host-id=1
with train.py calling multihost.initialize(...) before any jax use, then
multihost.global_mesh() and engine.shard_patterns(mesh).

CPU emulation for tests/CI (no accelerator needed):
    python -m bito_tpu.dist.launch -n 2 --devices-per-process 2 script.py
runs `script.py` in 2 local processes with a shared coordinator; the
global mesh then has 4 virtual devices across 2 "hosts".
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Wire this process into the job (jax.distributed.initialize).  With
    no arguments, reads BITO_COORDINATOR / BITO_NUM_PROCESSES /
    BITO_PROCESS_ID (set by bito_tpu.dist.launch) and no-ops when absent
    (single-process run).  Must run before the backend initializes."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "BITO_COORDINATOR")
    if coordinator_address is None:
        return
    if jax._src.distributed.global_state.client is not None:
        return  # already joined (bito_tpu import-time auto-init)
    if num_processes is None:
        num_processes = int(os.environ["BITO_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["BITO_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_count() -> int:
    import jax

    return jax.process_count()


def is_primary() -> bool:
    import jax

    return jax.process_index() == 0


def global_mesh(axis: str = "sites"):
    """One-axis mesh over ALL global devices (every host's chips flattened
    onto the pattern axis)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def place(array, mesh, spec) -> "jax.Array":
    """Place a host-replicated numpy/jax array onto the mesh with the given
    PartitionSpec.  Single-process: a plain device_put.  Multi-process:
    jax.make_array_from_callback — every process materializes only its
    addressable shards from its local copy."""
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(array, sharding)
    host = np.asarray(array)
    return jax.make_array_from_callback(
        host.shape, sharding, lambda idx: host[idx])


def replicated_to_host(array) -> np.ndarray:
    """Fetch a fully-replicated global array as numpy (valid on every
    process; each reads its local replica)."""
    import jax

    if jax.process_count() == 1 or getattr(array, "is_fully_replicated",
                                           True):
        return np.asarray(array)
    raise ValueError("array is not fully replicated across processes")
