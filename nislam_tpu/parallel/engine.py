"""Distributed SLAM engine: sharded keyframe bank + edge-sharded solver.

BASELINE config 5 as a *system*, not two demo functions: the same
``slam_step`` as the single-chip engine (``nislam_tpu.core.slam``) with its
two scale-bearing components swapped for their mesh-parallel versions via
the engine's plug points —

- **loop search** → ``find_loop_closure_sharded`` (``parallel.loop_search``):
  the bank's spectra/filters live block-sharded over the mesh's ``bank``
  axis; each device correlates the query against its local block inside
  ``shard_map`` and one gathered (nshards,) reduction picks the winner,
- **pose-graph solve** → ``solve_pose_graph_cg`` (``parallel.solver``):
  edges shard over the same axis; every Gauss-Newton/CG iteration costs one
  ``psum`` of a (3K,) vector over the mesh.

Everything else (tracking, keyframe decisions, stores, the deferred
optimize driver) is the identical compiled logic, so a distributed run is
trajectory-equal to the single-device engine up to solver tolerance —
tested on the 8-virtual-device CPU mesh (tests/test_parallel.py).

Memory scaling: the bank's spectra and cached filters — the O(K·H·W) state —
are placed with ``NamedSharding(P("bank"))``, so per-device map memory
shrinks 1/N with mesh size; per-slot scalars (poses, ids, grid cells) stay
replicated (they are KBs, and the tracker reads them every frame).

The reference has no distributed layer at all (SURVEY §2.3); this is the
scaling story for its unbounded in-RAM map (include/map.h:70-76).
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial

import jax

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nislam_tpu.core.camera import CameraOps, make_camera_ops
from nislam_tpu.core.config import SlamConfig
from nislam_tpu.core.slam import (
    SlamState,
    check_and_optimize_final,
    init_state,
    maybe_optimize,
    slam_step,
)
from nislam_tpu.ops.registration import CFOps, make_cf_ops
from nislam_tpu.parallel.loop_search import find_loop_closure_sharded
from nislam_tpu.parallel.solver import CGSolverConfig, solve_pose_graph_cg


@dataclasses.dataclass(frozen=True)
class DistributedSlamEngine:
    """One SLAM instance whose map state spans a device mesh."""

    config: SlamConfig
    cf_ops: CFOps
    camera: CameraOps
    mesh: Mesh
    axis: str = "bank"
    cg: CGSolverConfig = CGSolverConfig()

    def __post_init__(self):
        n = self.mesh.shape[self.axis]
        if self.config.map.keyframe_capacity % n:
            raise ValueError(
                f"keyframe_capacity {self.config.map.keyframe_capacity} not "
                f"divisible by {n} '{self.axis}' shards"
            )
        if self.config.map.edge_capacity % n:
            raise ValueError(
                f"edge_capacity {self.config.map.edge_capacity} not "
                f"divisible by {n} '{self.axis}' shards"
            )

    # -- plug points ------------------------------------------------------

    @property
    def _loop_search_fn(self):
        return partial(find_loop_closure_sharded, mesh=self.mesh, axis=self.axis)

    @property
    def _solver_fn(self):
        mesh, axis, cg = self.mesh, self.axis, self.cg
        return lambda prob: solve_pose_graph_cg(prob, mesh, axis, cg)

    # -- state placement ---------------------------------------------------

    def init_state(self) -> SlamState:
        return self.place(init_state(self.config, self.cf_ops))

    def place(self, state: SlamState) -> SlamState:
        """Shard the O(K·H·W) bank tensors over the mesh axis, replicate the
        rest (idempotent; use when resuming from a checkpoint — proven by
        tests/test_parallel.py::test_checkpoint_to_distributed_resume and
        the 2-process restore phase of tests/_dist_worker.py).

        Works on multi-process (multi-host) meshes too: when the mesh spans
        processes, leaves become global arrays via
        ``jax.make_array_from_callback`` — every process must hold the SAME
        host values (true for ``init_state`` and for checkpoints restored
        identically everywhere), exactly the multi-controller SPMD contract.
        """
        from nislam_tpu.parallel.mesh import put_global as put

        shard = NamedSharding(self.mesh, P(self.axis))
        repl = NamedSharding(self.mesh, P())

        bank = state.bank
        big = dict(
            fft=put(bank.fft, shard),
            polar_fft=put(bank.polar_fft, shard),
            filt=put(bank.filt, shard) if bank.filt.shape[1] else put(bank.filt, repl),
            filt_polar=(
                put(bank.filt_polar, shard)
                if bank.filt_polar.shape[1]
                else put(bank.filt_polar, repl)
            ),
            images=(
                put(bank.images, shard)
                if bank.images.shape[1]
                else put(bank.images, repl)
            ),
        )
        small = {
            f.name: put(getattr(bank, f.name), repl)
            for f in dataclasses.fields(bank)
            if f.name not in big
        }
        bank = type(bank)(**big, **small)
        rest = jax.tree.map(lambda x: put(x, repl),
                            (state.edges, state.track, state.pending, state.canvas))
        return SlamState(bank=bank, edges=rest[0], track=rest[1],
                         pending=rest[2], canvas=rest[3])

    # -- compiled programs --------------------------------------------------

    @functools.cached_property
    def step(self):
        config = self.config
        search = self._loop_search_fn

        @functools.partial(jax.jit, donate_argnums=0)
        def fn(state, image, cf_ops, camera):
            return slam_step(
                state, image, config=config, cf_ops=cf_ops, camera=camera,
                defer_optimize=True, loop_search_fn=search,
            )

        return lambda state, image: fn(state, image, self.cf_ops, self.camera)

    @functools.cached_property
    def run_chunk(self):
        config = self.config
        search = self._loop_search_fn

        @functools.partial(jax.jit, donate_argnums=0)
        def run(state, images, cf_ops, camera):
            def body(st, img):
                return slam_step(
                    st, img, config=config, cf_ops=cf_ops, camera=camera,
                    defer_optimize=True, loop_search_fn=search,
                )

            return jax.lax.scan(body, state, images)

        return lambda state, images: run(state, images, self.cf_ops, self.camera)

    @functools.cached_property
    def run_chunk_masked(self):
        """Masked-chunk variant (tail padding — see
        ``core.slam.chunked_deferred_drive``)."""
        from nislam_tpu.core.slam import dead_step_output

        config = self.config
        search = self._loop_search_fn

        @functools.partial(jax.jit, donate_argnums=0)
        def run(state, images, valid, cf_ops, camera):
            def body(st, xs):
                img, v = xs

                def live(st):
                    return slam_step(
                        st, img, config=config, cf_ops=cf_ops, camera=camera,
                        defer_optimize=True, loop_search_fn=search,
                    )

                def dead(st):
                    return st, dead_step_output()

                return jax.lax.cond(v, live, dead, st)

            return jax.lax.scan(body, state, (images, valid))

        return lambda state, images, valid: run(
            state, images, valid, self.cf_ops, self.camera
        )

    @functools.cached_property
    def optimize(self):
        config = self.config
        solver = self._solver_fn

        @functools.partial(jax.jit, donate_argnums=0)
        def fn(state, camera):
            return maybe_optimize(
                state, config=config, camera=camera, solver_fn=solver
            )

        return lambda state: fn(state, self.camera)

    @functools.cached_property
    def finalize(self):
        config = self.config
        solver = self._solver_fn

        @functools.partial(jax.jit, donate_argnums=0)
        def fn(state, camera):
            return check_and_optimize_final(
                state, config=config, camera=camera, solver_fn=solver
            )

        return lambda state: fn(state, self.camera)

    def run_sequence(
        self, state, images, *, numpy_outputs: bool = True, chunk_frames: int = 64
    ):
        """Chunked deferred-optimize driver — the SAME shared driver as
        ``SlamEngine.run_sequence``, so optimize timing (and therefore the
        trajectory) is identical between the single-chip and distributed
        engines by construction."""
        from nislam_tpu.core.slam import chunked_deferred_drive

        return chunked_deferred_drive(
            self, state, images,
            chunk_frames=chunk_frames, numpy_outputs=numpy_outputs,
        )


def make_distributed_engine(
    config: SlamConfig,
    mesh: Mesh,
    axis: str = "bank",
    cg: CGSolverConfig = CGSolverConfig(),
) -> DistributedSlamEngine:
    return DistributedSlamEngine(
        config=config,
        cf_ops=make_cf_ops(config.cf),
        camera=make_camera_ops(config.camera),
        mesh=mesh,
        axis=axis,
        cg=cg,
    )
