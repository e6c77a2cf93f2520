"""Data-parallel multi-sequence SLAM: vmap over sequences, shard over a mesh.

BASELINE config 4 (ICL-NUIM multi-sequence batch): B independent sequences
run as one program — the per-frame step is ``vmap``-ped over the batch and
the batch dimension is sharded over the mesh's ``data`` axis, so every chip
tracks its own subset of sequences with zero cross-chip traffic in the front
end (embarrassing parallelism, exactly as SURVEY §2.3 prescribes).

Batch mode runs with ``defer_optimize=True``: pose graphs are solved once
per sequence at :meth:`BatchSlamEngine.finalize` with a vmapped LM solve (a
batched dense Cholesky), instead of mid-sequence triggers
(see the note on ``slam_step``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nislam_tpu.core.camera import make_camera_ops
from nislam_tpu.core.config import SlamConfig
from nislam_tpu.core.slam import (
    SlamState,
    StepOutput,
    check_and_optimize_final,
    dead_step_output,
    deferred_loop_search,
    frontend,
    init_state,
    maybe_optimize,
    slam_step,
)
from nislam_tpu.ops.registration import make_cf_ops


@dataclasses.dataclass(frozen=True)
class BatchSlamEngine:
    """B sequences in lockstep; state pytrees carry a leading (B,) axis."""

    config: SlamConfig
    batch: int
    mesh: Optional[Mesh] = None

    @functools.cached_property
    def _cf_ops(self):
        return make_cf_ops(self.config.cf)

    @functools.cached_property
    def _camera(self):
        return make_camera_ops(self.config.camera)

    @functools.cached_property
    def _state_sharding(self):
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, P("data"))

    def init_states(self) -> SlamState:
        one = init_state(self.config, self._cf_ops)
        states = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (self.batch,) + x.shape), one
        )
        if self._state_sharding is not None:
            states = jax.device_put(states, self._state_sharding)
        return states

    def _scan_chunk(self, states, images, valid, cf_ops, camera):
        """Shared scan core of :attr:`run_chunk` / :attr:`run_chunk_masked`.

        ``valid`` is a per-frame (time-axis) mask shared across lanes, or
        None for an unmasked chunk.
        """
        config = self.config
        step = functools.partial(
            slam_step,
            config=config,
            cf_ops=cf_ops,
            camera=camera,
            defer_optimize=True,
            defer_loop_search=True,
        )
        vstep = jax.vmap(
            lambda st, ft: step(st, None, features=ft), in_axes=(0, 0)
        )
        vsearch = jax.vmap(
            functools.partial(
                deferred_loop_search,
                config=config,
                cf_ops=cf_ops,
                camera=camera,
            )
        )

        # Frontend hoisted over the whole (B, N) chunk: batched transforms
        # instead of per-frame ones inside the scan body (same hoist as
        # SlamEngine.run_chunk).
        feats = frontend(images, cf_ops=cf_ops, camera=camera)
        feats_t = jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), feats)

        # scan over time; batch axis stays leading on every carry leaf so
        # the "data" sharding propagates untouched through the scan.
        # The loop search is hoisted out of the vmapped step behind ONE
        # any-lane-stored cond: a vmapped per-lane cond would execute
        # the full multi-candidate search every frame for every lane,
        # while keyframes arrive ~1 in 10 frames.
        def live(st, ft_t):
            st, out = vstep(st, ft_t)
            if config.loop_closure.to_find_loop:
                any_stored = jnp.any(
                    jnp.logical_and(out.keyframe_slot >= 0, out.frame_id > 0)
                )

                def do(args):
                    st, ft, out = args
                    return vsearch(st, ft, out)

                def skip(args):
                    st, _ft, out = args
                    return st, out

                st, out = jax.lax.cond(any_stored, do, skip, (st, ft_t, out))
            return st, out

        if valid is None:
            body = live
            xs = feats_t
        else:
            batch = self.batch

            def dead(st, _ft_t):
                return st, dead_step_output((batch,))

            def body(st, args):
                ft_t, v = args
                return jax.lax.cond(v, live, dead, st, ft_t)

            xs = (feats_t, valid)

        states, outs = jax.lax.scan(body, states, xs)
        outs = jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), outs)
        return states, outs

    @functools.cached_property
    def run_chunk(self):
        """(states[B], images[B, N, H, W]) → (states, outputs[B, N]).

        cf_ops/camera travel as jit arguments (replicated), not closure
        constants — see the note on ``SlamEngine``.
        """

        def run(states: SlamState, images: jnp.ndarray, cf_ops, camera):
            return self._scan_chunk(states, images, None, cf_ops, camera)

        if self.mesh is None:
            jfn = jax.jit(run, donate_argnums=0)
        else:
            # A single NamedSharding acts as a pytree prefix: every state
            # leaf is sharded on its leading (batch) axis over "data";
            # cf_ops/camera replicate.
            sh = self._state_sharding
            rep = NamedSharding(self.mesh, P())
            jfn = jax.jit(
                run,
                donate_argnums=0,
                in_shardings=(sh, sh, rep, rep),
                out_shardings=(sh, sh),
            )
        return lambda states, images: jfn(states, images, self._cf_ops, self._camera)

    @functools.cached_property
    def run_chunk_masked(self):
        """:attr:`run_chunk` with a per-frame (time-axis) validity mask
        shared across lanes: lets :meth:`run_sequences` pad a tail chunk
        into the SAME compiled program instead of tracing a second scan
        program per distinct remainder length (VERDICT r2 #9b, batch
        engine)."""

        def run(states, images, valid, cf_ops, camera):
            return self._scan_chunk(states, images, valid, cf_ops, camera)

        if self.mesh is None:
            jfn = jax.jit(run, donate_argnums=0)
        else:
            sh = self._state_sharding
            rep = NamedSharding(self.mesh, P())
            jfn = jax.jit(
                run,
                donate_argnums=0,
                in_shardings=(sh, sh, rep, rep, rep),
                out_shardings=(sh, sh),
            )
        return lambda states, images, valid: jfn(
            states, images, valid, self._cf_ops, self._camera
        )

    @functools.cached_property
    def optimize(self):
        """Vmapped deferred trigger (chunk-boundary solves).  Under vmap the
        ≥2-pending ``cond`` lowers to a select — every lane pays the batched
        dense Cholesky whenever the program runs — so the driver invokes it
        once per chunk, not per frame."""
        config = self.config

        def fn(states, camera):
            return jax.vmap(
                functools.partial(maybe_optimize, config=config, camera=camera)
            )(states)

        if self.mesh is None:
            jfn = jax.jit(fn, donate_argnums=0)
        else:
            sh = self._state_sharding
            rep = NamedSharding(self.mesh, P())
            jfn = jax.jit(
                fn, donate_argnums=0, in_shardings=(sh, rep), out_shardings=(sh, sh)
            )
        return lambda states: jfn(states, self._camera)

    def run_sequences(
        self, states, images, *, numpy_outputs: bool = True, chunk_frames: int = 64
    ):
        """Chunked driver over (B, N, H, W): scan chunks with the batched
        deferred trigger between them — the batch analogue of
        ``SlamEngine.run_sequence``."""
        import numpy as np

        images = jnp.asarray(images)
        n = images.shape[1]
        if n == 0:  # empty sequences: nothing to scan (ADVICE r2 #4)
            from nislam_tpu.core.slam import empty_step_output

            outs = jax.tree.map(
                lambda x: jnp.zeros((self.batch,) + x.shape, x.dtype),
                empty_step_output(),
            )
            if numpy_outputs:
                outs = jax.tree.map(np.asarray, outs)
            return states, outs
        from nislam_tpu.core.slam import chunked_deferred_drive

        return chunked_deferred_drive(
            self, states, images,
            chunk_frames=chunk_frames, numpy_outputs=numpy_outputs,
            time_axis=1,
        )

    @functools.cached_property
    def finalize(self):
        """Vmapped end-of-sequence pose-graph solve (batched Cholesky)."""
        config = self.config

        def fn(states, camera):
            return jax.vmap(
                functools.partial(
                    check_and_optimize_final, config=config, camera=camera
                )
            )(states)

        if self.mesh is None:
            jfn = jax.jit(fn, donate_argnums=0)
        else:
            sh = self._state_sharding
            rep = NamedSharding(self.mesh, P())
            jfn = jax.jit(
                fn, donate_argnums=0, in_shardings=(sh, rep), out_shardings=(sh, sh)
            )
        return lambda states: jfn(states, self._camera)


def make_batch_engine(
    config: SlamConfig, batch: int, mesh: Optional[Mesh] = None
) -> BatchSlamEngine:
    if mesh is not None and batch % mesh.shape["data"] != 0:
        raise ValueError(
            f"batch {batch} not divisible by data axis {mesh.shape['data']}"
        )
    return BatchSlamEngine(config=config, batch=batch, mesh=mesh)
