"""Scaling evidence that is counted, not timed.

A virtual CPU mesh timeshares the host's cores, so wall-clock ratios on it
say nothing about devices.  What does transfer to a real mesh, and what
this module reports instead:

- **Per-shard work balance** of the sharded loop search: static shapes make
  it exact by construction — every shard scans ``capacity/N`` bank slots and
  re-registers ``min(max_candidates, capacity/N)`` candidates.
- **Collective traffic**, read from the compiled HLO of the two distributed
  programs (sharded loop search, edge-sharded GN-CG solve): the bytes each
  collective instruction moves over the mesh axis.  Loop search communicates
  O(nshards) winner records — independent of bank size; the solver psums one
  (K, 3) vector per CG iteration.
"""

from __future__ import annotations

import re
from typing import Dict

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1, "pred": 1,
    "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")

_SHAPE_RE = re.compile(r"\b(f64|f32|bf16|f16|s64|s32|s16|s8|u64|u32|u16|u8|pred|c64|c128)\[([0-9,]*)\]")


def _shape_bytes(text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes_from_hlo(hlo_text: str) -> int:
    """Sum the OUTPUT bytes of every collective instruction in an HLO dump.

    Instructions inside loops are counted once (the static program); for
    per-iteration totals multiply by the loop trip count.
    """
    total = 0
    for line in hlo_text.splitlines():
        stripped = line.strip()
        for op in _COLLECTIVES:
            # "%name = f32[...]{...} all-reduce(...)" — output shape is
            # everything before the op keyword.
            m = re.search(rf"=\s+(.*?)\s+{op}\(", stripped)
            if m:
                total += _shape_bytes(m.group(1))
                break
    return total


def shard_work_stats(
    *, keyframe_capacity: int, nshards: int, max_candidates: int
) -> Dict[str, float]:
    """Static per-shard work of the sharded loop search — exact by shape."""
    slots = keyframe_capacity // nshards
    regs = min(max_candidates, slots)
    return {
        "slots_per_shard": slots,
        "registrations_per_shard": regs,
        # Every shard executes the identical static program: balance is
        # exact (1.0) unless capacity does not divide the shard count.
        "balance": 1.0 if keyframe_capacity % nshards == 0 else round(
            slots / (slots + 1), 3
        ),
    }


def collective_bytes_loop_search(mesh, config) -> int:
    """Compile the sharded loop search on ``mesh`` and report its collective
    traffic (bytes per invocation)."""
    import jax
    import jax.numpy as jnp

    from nislam_tpu.core.map_store import make_keyframe_bank
    from nislam_tpu.ops.registration import make_cf_ops
    from nislam_tpu.parallel.loop_search import find_loop_closure_sharded

    cf_ops = make_cf_ops(config.cf)
    h, w = config.cf.height, config.cf.width

    def fn(bank, image, polar, fid, dist, prior):
        return find_loop_closure_sharded(
            bank, image, polar, fid, dist, prior, cf_ops,
            config.loop_closure, config.map.grid_scale, mesh,
        )

    # Pin input creation + compilation to the mesh's own devices: this
    # reads the mesh program's HLO and must not touch another device.
    with jax.default_device(list(mesh.devices.flat)[0]):
        bank = make_keyframe_bank(config.cf, config.map)
        lowered = jax.jit(fn).lower(
            bank,
            jnp.zeros((h, w), jnp.float32),
            jnp.zeros(
                (config.cf.polar_shape[0], config.cf.polar_shape[1] // 2 + 1),
                jnp.complex64,
            ),
            jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.float32),
            jnp.zeros((3,), jnp.float32),
        )
        return collective_bytes_from_hlo(lowered.compile().as_text())


def collective_bytes_solver(
    mesh, *, keyframe_capacity: int, edge_capacity: int
) -> int:
    """Compile the edge-sharded GN-CG solve and report its collective bytes
    (static program; the in-loop psum executes once per CG iteration)."""
    import jax
    import jax.numpy as jnp

    from nislam_tpu.core.pose_graph import PoseGraphProblem
    from nislam_tpu.parallel.solver import solve_pose_graph_cg

    k, e = keyframe_capacity, edge_capacity
    with jax.default_device(list(mesh.devices.flat)[0]):  # CPU-mesh only
        prob = PoseGraphProblem(
            poses=jnp.zeros((k, 3), jnp.float32),
            pose_mask=jnp.ones((k,), bool),
            from_slot=jnp.zeros((e,), jnp.int32),
            to_slot=jnp.zeros((e,), jnp.int32),
            T=jnp.zeros((e, 3), jnp.float32),
            sqrt_info=jnp.broadcast_to(jnp.eye(3), (e, 3, 3)),
            edge_mask=jnp.zeros((e,), bool),
        )
        lowered = jax.jit(
            lambda p: solve_pose_graph_cg(p, mesh)
        ).lower(prob)
        return collective_bytes_from_hlo(lowered.compile().as_text())

