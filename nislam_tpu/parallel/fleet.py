"""Fleet data parallelism: one SLAM sequence per device over ``shard_map``.

The other data-parallel shape (``parallel.batch``) vmaps lanes in lockstep:
every data-dependent ``lax.cond`` lowers to both-branches-per-lane, so the
per-keyframe loop search and filter computation run every frame for every
lane (the any-lane hoist recovers part of it, but lockstep remains).

``shard_map`` removes the lockstep entirely: each device runs the REAL
single-lane program — the same scan `SlamEngine.run_chunk` compiles, with
genuine per-device control flow — on its own sequence shard.  The front end
has zero cross-device traffic (embarrassing parallelism, SURVEY §2.3), so
frames/s scales linearly with devices by construction; this is the
multi-chip deployment shape for BASELINE config 4.

Reference parity: the reference is single-process/single-sequence
(/root/reference/main.cpp:32-99); this engine is an addition.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nislam_tpu.core.camera import make_camera_ops
from nislam_tpu.core.config import SlamConfig
from nislam_tpu.core.slam import (
    check_and_optimize_final,
    frontend,
    init_state,
    maybe_optimize,
    slam_step,
)
from nislam_tpu.ops.registration import make_cf_ops


def _lane_chunk(state, images, cf_ops, camera, config):
    """The single-lane chunk program (identical to SlamEngine.run_chunk's
    body): hoisted batched frontend + per-frame scan.  Honors
    ``optimizer.inline`` exactly like SlamEngine.run_chunk — per-device
    control flow makes the in-step solve trigger viable here (unlike under
    vmap)."""
    feats = frontend(images, cf_ops=cf_ops, camera=camera)
    defer = not config.optimizer.inline

    def body(st, xs):
        return slam_step(
            st, None, config=config, cf_ops=cf_ops, camera=camera,
            defer_optimize=defer, features=xs,
        )

    return jax.lax.scan(body, state, feats)


def _lane_chunk_masked(state, images, valid, cf_ops, camera, config):
    """Masked-tail variant (mirrors SlamEngine.run_chunk_masked): invalid
    frames pass the state through and emit a dummy output, so a padded tail
    chunk reuses the same compiled program (VERDICT r2 #9b)."""
    from nislam_tpu.core.slam import dead_step_output

    feats = frontend(images, cf_ops=cf_ops, camera=camera)
    defer = not config.optimizer.inline

    def body(st, xs):
        f, v = xs

        def live(st):
            return slam_step(
                st, None, config=config, cf_ops=cf_ops, camera=camera,
                defer_optimize=defer, features=f,
            )

        def dead(st):
            return st, dead_step_output()

        return jax.lax.cond(v, live, dead, st)

    return jax.lax.scan(body, state, (feats, valid))


@dataclasses.dataclass(frozen=True)
class FleetSlamEngine:
    """One sequence per device: state pytrees carry a leading (n_devices,)
    axis sharded over the mesh ``data`` axis; each shard executes the plain
    single-lane program with real (non-lockstep) control flow."""

    config: SlamConfig
    mesh: Mesh

    @property
    def n_lanes(self) -> int:
        return self.mesh.shape["data"]

    @functools.cached_property
    def _cf_ops(self):
        return make_cf_ops(self.config.cf)

    @functools.cached_property
    def _camera(self):
        return make_camera_ops(self.config.camera)

    @functools.cached_property
    def _sharding(self):
        return NamedSharding(self.mesh, P("data"))

    def init_states(self):
        from nislam_tpu.parallel.mesh import place_global

        one = init_state(self.config, self._cf_ops)
        n = self.n_lanes
        states = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (n,) + x.shape), one
        )
        # place_global: also valid on multi-process meshes (lanes spanning
        # hosts), where a plain device_put of host arrays cannot target
        # non-addressable devices.
        return place_global(states, self._sharding)

    def place_states(self, states_list):
        """Stack per-lane ``SlamState``s onto the fleet mesh — the
        checkpoint-resume path: load each lane's state with
        ``io.checkpoint.load_state`` (single-lane template), then place
        the list here.  Works on multi-process meshes (place_global)."""
        from nislam_tpu.parallel.mesh import place_global

        if len(states_list) != self.n_lanes:
            raise ValueError(
                f"{len(states_list)} states for {self.n_lanes} lanes"
            )
        states = jax.tree.map(
            lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *states_list
        )
        return place_global(states, self._sharding)

    def _wrap(self, lane_fn, extra_in_specs=()):
        """shard_map a per-lane function over the ``data`` axis; each shard
        holds exactly one lane (leading local axis of size 1).  cf_ops and
        camera enter as jit ARGUMENTS supplied by the call-time lambda and
        ride the shard_map replicated — never closure constants of the
        traced function, which would embed the multi-MB spectra/tap tables
        as HLO constants in every program (same rule as the other engines;
        the eager binding here also keeps the lazy cached_properties from
        materializing inside a trace)."""
        config = self.config
        cf_ops = self._cf_ops
        camera = self._camera

        def sharded(states, *args):
            def body(st, *a):
                *lane_args, cf1, cam1 = a
                st1 = jax.tree.map(lambda x: x[0], st)
                a1 = tuple(
                    x if spec == P() else jax.tree.map(lambda y: y[0], x)
                    for x, spec in zip(lane_args, extra_in_specs)
                )
                st1, out1 = lane_fn(st1, *a1, cf1, cam1, config)
                return (
                    jax.tree.map(lambda x: x[None], st1),
                    jax.tree.map(lambda x: jnp.asarray(x)[None], out1),
                )

            # check_vma=False: the lane body is collective-free (each device
            # fully independent), so varying-manifest-axes tracking has
            # nothing to validate — and the full slam_step's many lax.conds
            # mix constant and data-derived branch outputs, which the vma
            # checker rejects.
            return jax.shard_map(
                body,
                mesh=self.mesh,
                in_specs=(P("data"),) + tuple(extra_in_specs) + (P(), P()),
                out_specs=(P("data"), P("data")),
                check_vma=False,
            )(states, *args)

        jfn = jax.jit(sharded, donate_argnums=0)

        def call(states, *args):
            return jfn(states, *args, cf_ops, camera)

        # Expose lowering for the collective-free guard test: check_vma=False
        # above disables shard_map's varying-axes validation, so CI instead
        # compiles this program and asserts ZERO collective instructions —
        # an accidentally-introduced cross-lane dependency fails loudly
        # (VERDICT r3 weak #7 / next #8) instead of silently corrupting lanes.
        call.lower = lambda states, *args: jfn.lower(states, *args, cf_ops, camera)
        return call

    @functools.cached_property
    def run_chunk(self):
        """(states[n], images[n, N, H, W]) → (states, outputs[n, N])."""
        return self._wrap(_lane_chunk, extra_in_specs=(P("data"),))

    @functools.cached_property
    def run_chunk_masked(self):
        """:attr:`run_chunk` with a per-frame (time-axis) validity mask
        shared across lanes — lets the shared chunked driver pad a tail
        chunk into the same compiled program (VERDICT r2 #9b)."""
        return self._wrap(_lane_chunk_masked, extra_in_specs=(P("data"), P()))

    @functools.cached_property
    def optimize(self):
        """Per-lane deferred pose-graph trigger — a REAL cond per device:
        only lanes with ≥2 live pending matches pay the solve (unlike the
        vmapped batch engine, where any lane's solve runs for all)."""

        def lane(st, cf_ops, camera, config):
            return maybe_optimize(st, config=config, camera=camera)

        return self._wrap(lane)

    @functools.cached_property
    def finalize(self):
        def lane(st, cf_ops, camera, config):
            return check_and_optimize_final(st, config=config, camera=camera)

        return self._wrap(lane)

    def run_sequences(self, states, images, *, chunk_frames: int = 64,
                      numpy_outputs: bool = True):
        """Chunked driver over (n, N, H, W) with per-lane optimize triggers
        between chunks — the shared masked-tail driver, lane axis leading."""
        import numpy as np

        from nislam_tpu.core.slam import (
            chunked_deferred_drive,
            empty_step_output,
        )

        images = jnp.asarray(images)
        if images.shape[0] != self.n_lanes:
            raise ValueError(
                f"images lane axis {images.shape[0]} != n_lanes "
                f"{self.n_lanes} (one sequence per mesh 'data' device)"
            )
        if images.shape[1] == 0:  # empty sequences (ADVICE r2 #4)
            outs = jax.tree.map(
                lambda x: jnp.zeros((self.n_lanes,) + x.shape, x.dtype),
                empty_step_output(),
            )
            if numpy_outputs:
                outs = jax.tree.map(np.asarray, outs)
            return states, outs
        return chunked_deferred_drive(
            self, states, images,
            chunk_frames=chunk_frames, numpy_outputs=numpy_outputs,
            time_axis=1,
            # Inline lanes already solve in-step with the reference's exact
            # trigger; the chunk-boundary trigger is deferred-mode-only
            # (ADVICE r3 #1 — keeps fleet inline runs lane-for-lane equal
            # to SlamEngine.run_sequence's single unchunked inline run).
            between_chunk_optimize=not self.config.optimizer.inline,
        )


def make_fleet_engine(config: SlamConfig, mesh: Mesh) -> FleetSlamEngine:
    if "data" not in mesh.shape:
        raise ValueError("fleet engine needs a mesh with a 'data' axis")
    return FleetSlamEngine(config=config, mesh=mesh)
