"""Device mesh helpers.

The "communication backend": meshes + NamedSharding with XLA collectives
(NCCL on GPUs), replacing nothing in the reference (it has no
distributed layer, SURVEY §2.3) but required by the BASELINE scaling
configs.  Axis convention:

- ``data`` — batch of independent sequences (pure data parallelism),
- ``bank`` — keyframe-bank slots (model parallelism for loop search and
  edge-sharded pose-graph assembly).

Multi-host: call ``jax.distributed.initialize()`` before ``make_mesh``;
``jax.devices()`` then spans hosts and the same axis spec shards over DCN.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401


def make_mesh(
    axes: Optional[dict] = None, *, devices: Optional[Sequence] = None
) -> Mesh:
    """Build a mesh from ``{axis_name: size}``; sizes must multiply to the
    device count (one axis may be −1 to infer)."""
    devices = list(devices if devices is not None else jax.devices())
    if not axes:
        axes = {"data": len(devices)}
    names = list(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    if total != len(devices):
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {len(devices)} devices")
    arr = np.asarray(devices).reshape(sizes)
    return Mesh(arr, tuple(names))


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (batch) dimension over ``axis``, replicate the rest."""
    return NamedSharding(mesh, P(axis))


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Multi-host bring-up: ``jax.distributed.initialize`` with arguments
    auto-detected from the cluster environment when omitted.  Call once per
    host before ``make_mesh``; afterwards ``jax.devices()`` spans every
    host and the same mesh/axis specs shard across hosts.  Returns the global device count.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return len(jax.devices())


def put_global(leaf, sharding: NamedSharding):
    """``jax.device_put`` that also works on multi-process meshes.

    Single-process: plain ``device_put``.  Multi-process: host inputs
    (which every process must hold identically — the multi-controller SPMD
    contract) become global arrays via ``make_array_from_callback``;
    already-global arrays reshard on-device (``np.asarray`` would raise
    for non-addressable inputs).  Leaves already carrying the target
    sharding pass through untouched (idempotent)."""
    if isinstance(leaf, jax.Array) and leaf.sharding == sharding:
        return leaf
    if jax.process_count() > 1:
        if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
            return jax.device_put(leaf, sharding)
        x = np.asarray(leaf)
        return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])
    return jax.device_put(leaf, sharding)


def place_global(tree, sharding: NamedSharding):
    """:func:`put_global` over a pytree (one sharding for every leaf)."""
    return jax.tree.map(lambda x: put_global(x, sharding), tree)
