"""The SLAM engine: one jitted per-frame step + a ``lax.scan`` sequence driver.

Re-design of ``MapBuilder`` (/root/reference/src/map_builder.cc).
The reference's per-frame pipeline (``AddNewInput``, map_builder.cc:30-70) is
Python-free here: undistort → KCC features → track → keyframe decision →
edge/bank insert → loop search → optimize trigger all compile into ONE XLA
program with static shapes; every data-dependent branch of the reference
becomes a masked update or a ``lax.cond`` (SURVEY §7 hard part 3).

The only sequential dependency is the keyframe chain (frame *i* registers
against the last *inserted* keyframe, map_builder.cc:53,68,99-106), which is
exactly the scan carry; consequently whole sequences run on device via
``lax.scan`` with zero host round-trips (:func:`make_sequence_fn`).

Coordinate-frame bookkeeping mirrors map_builder.h:52-62: the engine carries
the pose chain in three frames — image-plane/'cf' (pixels, principal-point
based), camera (normalized), robot (metric) — because keyframe decisions use
camera-frame deltas, edges store camera-frame relatives, and the bank stores
robot-frame poses.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from nislam_tpu.core.camera import CameraOps, make_camera_ops
from nislam_tpu.core.config import SlamConfig
from nislam_tpu.core.loop_closure import find_loop_closure, no_loop_result
from nislam_tpu.core.map_store import (
    EDGE_KCC,
    EDGE_LOOP,
    EdgeStore,
    KeyframeBank,
    add_edge,
    add_keyframe,
    invalidate_edges,
    make_edge_store,
    make_keyframe_bank,
)
from nislam_tpu.core.pose_graph import (
    PoseGraphProblem,
    SolverConfig,
    solve_pose_graph,
    sqrt_information,
)
from nislam_tpu.core.se2 import absolute_pose, relative_pose
from nislam_tpu.core.stitcher import (
    StitchCanvas,
    insert_frame,
    make_canvas,
    recompute,
)
from nislam_tpu.ops.fft import c2r, r2c
from nislam_tpu.ops.registration import (
    CFOps,
    compute_intermedium,
    compute_keyframe_filters,
    compute_pose,
    make_cf_ops,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrackState:
    """Carry of the keyframe-relative tracking chain.

    The ``last_*`` fields advance only on keyframe insertion
    (``UpdateIntermedium``, map_builder.cc:99-106) — dropped frames keep
    registering against the same keyframe.
    """

    last_fft: jnp.ndarray  # (H, W//2+1, 2) f32 pair — keyframe image spectrum
    last_polar: jnp.ndarray  # (D, C//2+1, 2) f32 pair — keyframe polar spectrum
    last_filt: jnp.ndarray  # (H, W//2+1, 2) f32 pair — cached keyframe filter
    last_filt_polar: jnp.ndarray  # (D, C//2+1, 2) f32 pair — cached polar filter
    last_cf_pose: jnp.ndarray  # (3,) image-plane (principal) chain
    last_cf_real_pose: jnp.ndarray  # (3,) camera frame
    last_pose: jnp.ndarray  # (3,) robot frame
    last_slot: jnp.ndarray  # () i32 — bank slot of the keyframe
    distance: jnp.ndarray  # () f32 — accumulated travel distance
    next_frame_id: jnp.ndarray  # () i32
    initialized: jnp.ndarray  # () bool


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PendingLoops:
    """Accumulated loop matches awaiting the ≥2-matches optimize trigger
    (``_loop_matches`` + ``CheckAndOptimize``, map_builder.cc:108-116)."""

    loop_slot: jnp.ndarray  # (P,) i32
    cur_slot: jnp.ndarray  # (P,) i32
    rel_pose: jnp.ndarray  # (P, 3) image-plane, principal-based
    count: jnp.ndarray  # () i32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SlamState:
    bank: KeyframeBank
    edges: EdgeStore
    track: TrackState
    pending: PendingLoops
    # Occupancy mosaic, live only with MapStitcherConfig.online (else (0,0)
    # placeholders): insert on keyframe (map_builder.cc:62), recompute after
    # every optimize (map_builder.cc:113).
    canvas: StitchCanvas


class StepOutput(NamedTuple):
    """Per-frame observables (the reference's getters + stdout, SURVEY §3.4)."""

    tracked: jnp.ndarray  # bool — good tracking (or init frame)
    inserted: jnp.ndarray  # bool — became a keyframe
    loop_found: jnp.ndarray  # bool
    optimized: jnp.ndarray  # bool — pose graph ran this frame
    response: jnp.ndarray  # (3,) PSR confidences
    cf_pose: jnp.ndarray  # (3,) raw KCC odometry, robot frame (GetCFPose)
    pose: jnp.ndarray  # (3,) current robot pose
    frame_id: jnp.ndarray  # () i32
    keyframe_slot: jnp.ndarray  # () i32 — slot if inserted else -1
    loop_slot: jnp.ndarray  # () i32 — matched slot if loop_found else -1
    # Gating-eligible candidates the loop search saw (0 when no search ran);
    # values > max_candidates mean the search truncated (CLI warns).
    loop_eligible: jnp.ndarray  # () i32

    def pack(self) -> jnp.ndarray:
        """All fields as ONE (..., 17) f32 vector — the low-latency
        step-mode transfer format: fetching the NamedTuple leaf-by-leaf
        costs ~11 host round-trips per frame; one packed vector costs
        one.  Integer ids fit f32 exactly below
        2^24 frames/slots.  Inverse: :func:`unpack_step_output`."""
        f = lambda x: jnp.asarray(x, jnp.float32)
        return jnp.stack(
            [
                f(self.tracked), f(self.inserted), f(self.loop_found),
                f(self.optimized),
                f(self.response[..., 0]), f(self.response[..., 1]),
                f(self.response[..., 2]),
                f(self.cf_pose[..., 0]), f(self.cf_pose[..., 1]),
                f(self.cf_pose[..., 2]),
                f(self.pose[..., 0]), f(self.pose[..., 1]),
                f(self.pose[..., 2]),
                f(self.frame_id), f(self.keyframe_slot), f(self.loop_slot),
                f(self.loop_eligible),
            ],
            axis=-1,
        )


def unpack_step_output(v) -> StepOutput:
    """Inverse of :meth:`StepOutput.pack` (host side, numpy-friendly)."""
    import numpy as np

    v = np.asarray(v)
    i = lambda x: x.astype(np.int32)
    return StepOutput(
        tracked=v[..., 0] > 0.5,
        inserted=v[..., 1] > 0.5,
        loop_found=v[..., 2] > 0.5,
        optimized=v[..., 3] > 0.5,
        response=v[..., 4:7],
        cf_pose=v[..., 7:10],
        pose=v[..., 10:13],
        frame_id=i(v[..., 13]),
        keyframe_slot=i(v[..., 14]),
        loop_slot=i(v[..., 15]),
        loop_eligible=i(v[..., 16]),
    )


@dataclasses.dataclass(frozen=True)
class SlamEngine:
    """Static bundle: config + precomputed device constants + jitted fns."""

    config: SlamConfig
    cf_ops: CFOps
    camera: CameraOps

    def init_state(self) -> SlamState:
        return init_state(self.config, self.cf_ops)

    # NB: cf_ops/camera are passed as jit *arguments* (they are registered
    # pytrees), never closure-captured — closure capture would embed their
    # device arrays as HLO constants via a device→host copy, which bloats
    # the program.

    @functools.cached_property
    def step(self):
        """``(SlamState, image_f32[H,W]) -> (SlamState, StepOutput)`` jitted
        with the state donated (in-place device update).  With
        ``optimizer.inline`` the LM solve is compiled into this program
        (exact reference trigger timing); otherwise it lives in
        :attr:`optimize`, which the driver invokes between chunks."""
        config = self.config
        defer = not config.optimizer.inline

        @functools.partial(jax.jit, donate_argnums=0)
        def fn(state, image, cf_ops, camera):
            return slam_step(
                state, image, config=config, cf_ops=cf_ops, camera=camera,
                defer_optimize=defer,
            )

        return lambda state, image: fn(state, image, self.cf_ops, self.camera)

    @functools.cached_property
    def step_packed(self):
        """:attr:`step` with the output packed to ONE (17,) f32 vector
        inside the program — the live/robot deployment shape: one dispatch,
        one small device→host transfer per frame (see StepOutput.pack).
        With ``optimizer.inline`` the pose-graph trigger is already in the
        program, so a full real-time frame is exactly one round trip."""
        config = self.config
        defer = not config.optimizer.inline

        @functools.partial(jax.jit, donate_argnums=0)
        def fn(state, image, cf_ops, camera):
            state, out = slam_step(
                state, image, config=config, cf_ops=cf_ops, camera=camera,
                defer_optimize=defer,
            )
            return state, out.pack()

        return lambda state, image: fn(state, image, self.cf_ops, self.camera)

    @functools.cached_property
    def run_chunk(self):
        """``(SlamState, images[N,H,W]) -> (SlamState, StepOutput[N])`` — an
        on-device ``lax.scan`` over a chunk of frames."""
        config = self.config
        defer = not config.optimizer.inline

        @functools.partial(jax.jit, donate_argnums=0)
        def run(state, images, cf_ops, camera):
            # Hoisted batched front end: undistort + KCC features for the
            # whole chunk in one pass of batched transforms, leaving only
            # the carry-dependent work in the scan.
            feats = frontend(images, cf_ops=cf_ops, camera=camera)

            def body(st, xs):
                return slam_step(
                    st, None, config=config, cf_ops=cf_ops, camera=camera,
                    defer_optimize=defer, features=xs,
                )

            return jax.lax.scan(
                body, state, feats, unroll=config.scan_unroll
            )

        return lambda state, images: run(state, images, self.cf_ops, self.camera)

    @functools.cached_property
    def run_chunk_masked(self):
        """``(SlamState, images[N,H,W], valid[N]) -> (SlamState,
        StepOutput[N])`` — :attr:`run_chunk` with a per-frame validity mask:
        invalid frames pass the state through untouched and emit a dummy
        output.  Lets :meth:`run_sequence` pad a tail chunk into the SAME
        compiled program instead of tracing a second per-frame program for
        remainder frames (VERDICT r2 #9b)."""
        config = self.config
        defer = not config.optimizer.inline

        @functools.partial(jax.jit, donate_argnums=0)
        def run(state, images, valid, cf_ops, camera):
            feats = frontend(images, cf_ops=cf_ops, camera=camera)

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

            return jax.lax.scan(
                body, state, (feats, valid), unroll=config.scan_unroll
            )

        return lambda state, images, valid: run(
            state, images, valid, self.cf_ops, self.camera
        )

    @functools.cached_property
    def optimize(self):
        """``(SlamState) -> (SlamState, ran)`` — the deferred pose-graph
        trigger (:func:`maybe_optimize`), jitted separately so the dense LM
        factorization never bloats the per-frame program."""
        config = self.config

        @functools.partial(jax.jit, donate_argnums=0)
        def fn(state, camera):
            return maybe_optimize(state, config=config, camera=camera)

        return lambda state: fn(state, self.camera)

    def run_sequence(
        self,
        state,
        images,
        *,
        numpy_outputs: bool = True,
        chunk_frames: int = 64,
    ):
        """Host-side driver over a whole (N, H, W) sequence.

        Frames run through the scan program in chunks of ``chunk_frames``;
        in deferred-optimize mode (the default) the separately-
        jitted :attr:`optimize` program runs between chunks — a single
        extra dispatch per chunk whose ``lax.cond`` body executes only when
        ≥2 loop matches are pending (the reference solves rarely:
        map_builder.cc:108-116).  Returns ``(state, StepOutput[N])``.
        """
        import numpy as np

        if not self.config.optimizer.inline:
            return chunked_deferred_drive(
                self, state, images,
                chunk_frames=chunk_frames, numpy_outputs=numpy_outputs,
            )
        import numpy as np

        images = jnp.asarray(images)
        if images.shape[0] == 0:  # empty sequence (ADVICE r2 #4)
            outs = empty_step_output()
        else:
            state, outs = self.run_chunk(state, images)
        if numpy_outputs:
            outs = jax.tree.map(np.asarray, outs)
        return state, outs

    @functools.cached_property
    def finalize(self):
        """End-of-sequence optimize (main.cpp:68-69 fires ``CheckAndOptimize``
        on the last frame)."""
        config = self.config

        @functools.partial(jax.jit, donate_argnums=0)
        def fn(state, camera):
            return check_and_optimize_final(state, config=config, camera=camera)

        return lambda state: fn(state, self.camera)


def chunked_deferred_drive(
    engine,
    state,
    images,
    *,
    chunk_frames: int = 64,
    numpy_outputs: bool = True,
    time_axis: int = 0,
    between_chunk_optimize: bool = True,
    solve_tally: list | None = None,
):
    """Shared deferred-mode sequence driver: chunked scans with the
    separately-jitted optimize trigger between chunks, the tail padded into
    the SAME compiled program via the masked chunk variant (VERDICT r2 #9b —
    no second per-frame remainder program, and identical optimize timing for
    every engine that uses this driver).

    ``engine`` provides ``run_chunk``, ``run_chunk_masked``, ``optimize``.
    ``time_axis`` is the frame axis of ``images`` and the outputs: 0 for the
    single-lane engine, 1 for the lane-leading batch/fleet engines (one
    driver serves all three — the r2 #9b logic lives exactly once).
    Callers with a lane axis handle ``n == 0`` themselves (the empty output
    needs lane-shaped leaves).

    ``solve_tally`` (optional list) collects one 0/1 DEVICE scalar per
    chunk-boundary optimize that actually solved — callers that report
    solve counts (models.FullSlam.evaluate) convert AFTER the drive
    (``int(np.asarray(x))`` per chunk inside the loop would force a host
    round-trip sync per chunk and stall the dispatch pipeline — r5).

    ``between_chunk_optimize=False`` skips the deferred solve trigger after
    each chunk — for engines whose chunk program already solves INLINE
    (``optimizer.inline`` fleet lanes), where the extra chunk-boundary
    trigger would fire on matches the in-step cond intentionally left
    single-pending (ADVICE r3 #1).
    """
    import numpy as np

    def tslice(x, sl):
        return x[sl] if time_axis == 0 else x[:, sl]

    images = jnp.asarray(images)
    n = images.shape[time_axis]
    if n == 0:  # empty sequence (ADVICE r2 #4); single-lane shape only
        assert time_axis == 0, "lane engines pre-check the empty case"
        outs = empty_step_output()
        if numpy_outputs:
            outs = jax.tree.map(np.asarray, outs)
        return state, outs
    c = min(chunk_frames, n)
    n_chunks = -(-n // c)  # ceil: tail padded into the same program
    pad = n_chunks * c - n
    if pad:
        last = tslice(images, slice(n - 1, n))
        images = jnp.concatenate(
            [images, jnp.repeat(last, pad, axis=time_axis)], axis=time_axis
        )
    valid = jnp.arange(n_chunks * c) < n
    outs_list = []
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        if pad:
            state, o = engine.run_chunk_masked(
                state, tslice(images, sl), valid[sl]
            )
        else:
            state, o = engine.run_chunk(state, tslice(images, sl))
        outs_list.append(o)
        if between_chunk_optimize:
            state, ran = engine.optimize(state)
            if solve_tally is not None:
                solve_tally.append(ran)  # device scalar; convert after
    outs = jax.tree.map(
        lambda *xs: tslice(jnp.concatenate(xs, axis=time_axis), slice(0, n)),
        *outs_list,
    )
    if numpy_outputs:
        outs = jax.tree.map(np.asarray, outs)
    return state, outs


def streamed_deferred_drive(
    engine,
    state,
    chunk_iter,
    *,
    chunk_frames: int,
    max_frames: int = 0,
    between_chunk_optimize: bool = True,
):
    """Streaming counterpart of :func:`chunked_deferred_drive` for host
    chunk sources (the CLI's datasets and the native NISF prefetch reader).

    Consumes an iterator of ``(images (m≤chunk_frames, H, W) np, times
    (m,))`` and drives the SAME compiled programs as the array driver:
    full chunks through ``engine.run_chunk``, the short tail padded into
    ``engine.run_chunk_masked`` at the same shape — at most two compiled
    programs regardless of dataset length (VERDICT r2 #9b / r4 weak #3).

    Overlaps input with compute (VERDICT r4 weak #2): chunk i+1 is read
    from the source and its host→device transfer dispatched while chunk
    i's scan is still executing — with the C++ prefetch reader
    (io.native_loader) the disk read itself also overlaps in native
    threads.  The per-chunk ``optimize`` trigger results are returned as
    DEVICE scalars (summing them on the host would force a round-trip
    sync per chunk and break the pipeline).

    Returns ``(state, outs (numpy, N frames), times (N,) np, ran_flags
    [device scalars])``.
    """
    import numpy as np

    def put(pair):
        imgs, ts = pair
        imgs = np.asarray(imgs)
        m = imgs.shape[0]
        if max_frames:
            m = min(m, max_frames - put.done)
            imgs, ts = imgs[:m], ts[:m]
        put.done += m
        if m == 0:
            return None
        if m < chunk_frames:
            pad = chunk_frames - m
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, axis=0)])
            valid = jnp.asarray(np.arange(chunk_frames) < m)
        else:
            valid = None
        return jax.device_put(imgs), valid, m, np.asarray(ts)

    put.done = 0
    outs_list = []
    times_list = []
    ran_flags = []
    it = iter(chunk_iter)

    def nxt():
        if max_frames and put.done >= max_frames:
            return None
        try:
            return put(next(it))
        except StopIteration:
            return None

    cur = nxt()
    if cur is None:
        outs = jax.tree.map(np.asarray, empty_step_output())
        return state, outs, np.zeros((0,)), ran_flags
    while cur is not None:
        imgs_d, valid, m, ts = cur
        if valid is None:
            state, o = engine.run_chunk(state, imgs_d)
        else:
            state, o = engine.run_chunk_masked(state, imgs_d, valid)
        if between_chunk_optimize:
            state, ran = engine.optimize(state)
            ran_flags.append(ran)
        # Read + upload the NEXT chunk while this one runs on device.
        cur = nxt()
        outs_list.append(jax.tree.map(lambda x: np.asarray(x[:m]), o))
        times_list.append(ts)
    outs = jax.tree.map(lambda *xs: np.concatenate(xs), *outs_list)
    return state, outs, np.concatenate(times_list), ran_flags


def dead_step_output(batch: Tuple[int, ...] = ()) -> StepOutput:
    """An inert per-frame output — masked/padded frames and empty drivers
    share ONE constructor so StepOutput schema changes have a single home."""
    b = jnp.zeros(batch, bool)
    i = jnp.full(batch, -1, jnp.int32)
    v3 = jnp.zeros(batch + (3,), jnp.float32)
    return StepOutput(
        tracked=b, inserted=b, loop_found=b, optimized=b,
        response=v3, cf_pose=v3, pose=v3,
        frame_id=i, keyframe_slot=i, loop_slot=i,
        loop_eligible=jnp.zeros(batch, jnp.int32),
    )


def empty_step_output() -> StepOutput:
    """A zero-frame ``StepOutput`` (empty-sequence drivers)."""
    return dead_step_output((0,))


def make_engine(config: SlamConfig) -> SlamEngine:
    return SlamEngine(
        config=config,
        cf_ops=make_cf_ops(config.cf),
        camera=make_camera_ops(config.camera),
    )


def _stitch_online(config: SlamConfig) -> bool:
    ms = config.map_stitcher
    if ms.stitch_map and ms.online and not config.map.store_images:
        raise ValueError(
            "map_stitcher.online requires map.store_images (the recompute "
            "after optimization re-rasterizes stored keyframe images)"
        )
    return ms.stitch_map and ms.online


def init_state(config: SlamConfig, cf_ops: CFOps) -> SlamState:
    cf = config.cf
    p = config.loop_closure.pending_capacity
    canvas = (
        make_canvas(config.map_stitcher)
        if _stitch_online(config)
        else StitchCanvas(
            data=jnp.zeros((0, 0), jnp.float32),
            weight=jnp.zeros((0, 0), jnp.float32),
        )
    )
    return SlamState(
        canvas=canvas,
        bank=make_keyframe_bank(cf, config.map),
        edges=make_edge_store(config.map),
        track=TrackState(
            last_fft=jnp.zeros((cf.height, cf.width // 2 + 1, 2), jnp.float32),
            last_polar=jnp.zeros(
                (cf.polar_shape[0], cf.polar_shape[1] // 2 + 1, 2), jnp.float32
            ),
            last_filt=jnp.zeros((cf.height, cf.width // 2 + 1, 2), jnp.float32),
            last_filt_polar=jnp.zeros(
                (cf.polar_shape[0], cf.polar_shape[1] // 2 + 1, 2), jnp.float32
            ),
            last_cf_pose=jnp.zeros(3, jnp.float32),
            last_cf_real_pose=jnp.zeros(3, jnp.float32),
            last_pose=jnp.zeros(3, jnp.float32),
            last_slot=jnp.zeros((), jnp.int32),
            distance=jnp.zeros((), jnp.float32),
            next_frame_id=jnp.zeros((), jnp.int32),
            initialized=jnp.zeros((), bool),
        ),
        pending=PendingLoops(
            loop_slot=jnp.zeros((p,), jnp.int32),
            cur_slot=jnp.zeros((p,), jnp.int32),
            rel_pose=jnp.zeros((p, 3), jnp.float32),
            count=jnp.zeros((), jnp.int32),
        ),
    )


# ---------------------------------------------------------------------------
# Pose-graph trigger (CheckAndOptimize, map_builder.cc:108-116)
# ---------------------------------------------------------------------------


def _optimize_map(
    bank: KeyframeBank,
    edges: EdgeStore,
    config: SlamConfig,
    camera: CameraOps,
    solver_fn=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Solve the pose graph over the whole bank; returns (poses, cost).

    Parity with ``OptimizeMap`` (map_builder.cc:196-273): edge measurements
    stored in the camera frame are converted camera→robot at assembly
    (:240); information is the stored matrix (identity); base slot pinned.

    ``solver_fn(prob) -> (poses, cost)`` overrides the dense LM solver —
    the distributed engine passes the edge-sharded GN-CG solve
    (``nislam_tpu.parallel.solver``).
    """
    T_robot = camera.camera_to_robot(edges.T)
    # Whiten via the information matrix's Cholesky factor, exactly like the
    # reference (pose_graph_2d.cc:74: information.llt().matrixL()).  Dead
    # slots hold zero info (Cholesky → NaN); substitute identity there —
    # their residuals are masked out anyway.
    mask = edges.valid_mask()
    eye = jnp.eye(3, dtype=jnp.float32)
    safe_info = jnp.where(mask[:, None, None], edges.info, eye)
    prob = PoseGraphProblem(
        poses=bank.poses,
        pose_mask=bank.valid_mask(),
        from_slot=edges.from_slot,
        to_slot=edges.to_slot,
        T=T_robot,
        sqrt_info=sqrt_information(safe_info),
        edge_mask=mask,
    )
    if solver_fn is not None:
        return solver_fn(prob)
    cfg = SolverConfig(
        max_iterations=config.optimizer.max_iterations,
        estimate_scale=config.optimizer.with_scale,
    )
    poses, _, cost = solve_pose_graph(
        prob,
        cfg,
        init_scale=1.0,
        scale_free=not config.camera.accurate_height,
    )
    return poses, cost


def _invalidate_pending(pending: PendingLoops, evicted: jnp.ndarray) -> PendingLoops:
    """Drop accumulated matches that reference an evicted bank slot (-1: no-op).

    Surviving entries are **compacted** to the front (stable order) and
    ``count`` decremented — merely voiding in place would let dead entries
    occupy buffer positions forever: on a long ring-eviction run the buffer
    could fill with voided entries, permanently blocking both new appends
    (``fits`` False) and the ≥2-live optimize trigger, silently killing
    loop closure.  Compaction keeps the buffer's capacity meaningful.
    """
    p = pending.loop_slot.shape[0]
    live = jnp.arange(p) < pending.count
    ref = jnp.logical_or(
        pending.loop_slot == evicted, pending.cur_slot == evicted
    )
    kill = jnp.logical_and(jnp.logical_and(ref, live), evicted >= 0)
    keep = jnp.logical_and(live, ~kill)
    # Stable argsort of ~keep: kept entries first, original order preserved.
    order = jnp.argsort(~keep)
    return PendingLoops(
        loop_slot=pending.loop_slot[order],
        cur_slot=pending.cur_slot[order],
        rel_pose=pending.rel_pose[order],
        count=jnp.sum(keep.astype(jnp.int32)),
    )


def _live_pending_count(pending: PendingLoops) -> jnp.ndarray:
    """Number of pending matches still valid (not voided by eviction).

    The ≥2-matches optimize trigger counts LIVE entries, not raw
    ``count`` (the reference's 2-match confirmation threshold,
    map_builder.cc:108 — r2 ADVICE finding #2).  Since
    :func:`_invalidate_pending` compacts, in-count entries are live by
    construction; the ``loop_slot >= 0`` term is belt-and-braces.
    """
    p = pending.loop_slot.shape[0]
    live = jnp.logical_and(
        jnp.arange(p) < pending.count, pending.loop_slot >= 0
    )
    return jnp.sum(live.astype(jnp.int32))


def _add_loop_edges_and_solve(
    state: SlamState,
    config: SlamConfig,
    camera: CameraOps,
    solver_fn=None,
) -> SlamState:
    """AddLoopEdges + OptimizeMap + pending clear (map_builder.cc:108-116)."""
    pending = state.pending
    bank, edges = state.bank, state.edges
    # AddLoopEdges (map_builder.cc:184-194): image-plane → camera frame.
    p = pending.loop_slot.shape[0]
    live = jnp.arange(p) < pending.count
    rel_cam = camera.image_plane_to_camera(pending.rel_pose)

    def add_one(i, es):
        return add_edge(
            es,
            from_slot=pending.loop_slot[i],
            to_slot=pending.cur_slot[i],
            T=rel_cam[i],
            edge_type=EDGE_LOOP,
            # loop_slot -1 marks a match voided by ring eviction
            enabled=jnp.logical_and(live[i], pending.loop_slot[i] >= 0),
        )

    edges = jax.lax.fori_loop(0, p, add_one, edges)
    poses, _ = _optimize_map(bank, edges, config, camera, solver_fn)
    bank = dataclasses.replace(bank, poses=poses)
    canvas = state.canvas
    if _stitch_online(config):
        # RecomputeOccupancy after every optimize (map_builder.cc:113).
        canvas = recompute(canvas, bank, camera)
    cleared = dataclasses.replace(pending, count=jnp.zeros((), jnp.int32))
    return dataclasses.replace(
        state, bank=bank, edges=edges, pending=cleared, canvas=canvas
    )


def _flush_pending_loops(
    state: SlamState, config: SlamConfig, camera: CameraOps, solver_fn=None
) -> Tuple[SlamState, jnp.ndarray]:
    """Inline-mode trigger: solve iff ≥2 pending, then clear; returns (state, ran).

    The reference clears pending matches even when <2 accumulated
    (map_builder.cc:114-115) — single unconfirmed matches are discarded.
    """
    run = _live_pending_count(state.pending) >= 2
    state = jax.lax.cond(
        run,
        lambda st: _add_loop_edges_and_solve(st, config, camera, solver_fn),
        lambda st: st,
        state,
    )
    cleared = dataclasses.replace(state.pending, count=jnp.zeros((), jnp.int32))
    return dataclasses.replace(state, pending=cleared), run


def maybe_optimize(
    state: SlamState,
    *,
    config: SlamConfig,
    camera: CameraOps,
    solver_fn=None,
) -> Tuple[SlamState, jnp.ndarray]:
    """Deferred-mode trigger, invoked between scan chunks by the driver.

    Solves iff ≥2 matches are pending; unlike the reference's
    ``CheckAndOptimize`` (map_builder.cc:114-115), single pending matches
    are *kept* for a later pairing rather than discarded (deviation
    documented at ``OptimizerConfig.inline``).  After a solve the tracking
    chain is re-derived from the optimized pose of the current target —
    ``UpdateValueAfterLoop`` (map_builder.cc:275-279) applied at the chunk
    boundary instead of mid-frame.
    """

    def do(st):
        st = _add_loop_edges_and_solve(st, config, camera, solver_fn)
        opt = st.bank.poses[st.track.last_slot]
        opt_cam = camera.robot_to_camera(opt)
        tr = dataclasses.replace(
            st.track,
            last_pose=opt,
            last_cf_real_pose=opt_cam,
            last_cf_pose=camera.camera_to_image_plane(opt_cam),
        )
        return dataclasses.replace(st, track=tr)

    run = _live_pending_count(state.pending) >= 2
    state = jax.lax.cond(run, do, lambda st: st, state)
    return state, run


def check_and_optimize_final(
    state: SlamState,
    *,
    config: SlamConfig,
    camera: CameraOps,
    solver_fn=None,
) -> Tuple[SlamState, jnp.ndarray]:
    """Public end-of-sequence trigger (main.cpp:68-69)."""
    state, ran = maybe_optimize(
        state, config=config, camera=camera, solver_fn=solver_fn
    )
    cleared = dataclasses.replace(state.pending, count=jnp.zeros((), jnp.int32))
    return dataclasses.replace(state, pending=cleared), ran


# ---------------------------------------------------------------------------
# The per-frame step (AddNewInput, map_builder.cc:30-70)
# ---------------------------------------------------------------------------


def frontend(
    image: jnp.ndarray, *, cf_ops: CFOps, camera: CameraOps
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Carry-independent per-frame work: undistort + KCC features
    (``ComputeFFTResult``, map_builder.cc:72-75).  Returns
    ``(img_u, fft, polar_fft)``.  Batch-polymorphic over leading axes —
    the chunk driver hoists it OUT of the sequential scan and runs it once
    over the whole chunk as batched transforms instead of frame-at-a-time
    transforms inside the scan body.
    """
    if image.dtype == jnp.uint8:
        # Raw 8-bit input: normalize ON DEVICE (bit-parity with the host
        # path's `astype(f32)/255` — utils.cc:110-118).  Callers ship u8
        # across the host→device link for 4× fewer transfer bytes.
        image = image.astype(jnp.float32) / 255.0
    img_u = camera.undistort(image)
    fft, polar = compute_intermedium(img_u, cf_ops)
    return img_u, fft, polar


def slam_step(
    state: SlamState,
    image: jnp.ndarray | None,
    *,
    config: SlamConfig,
    cf_ops: CFOps,
    camera: CameraOps,
    defer_optimize: bool = False,
    defer_loop_search: bool = False,
    loop_search_fn=None,
    solver_fn=None,
    features: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray] | None = None,
) -> Tuple[SlamState, StepOutput]:
    """Process one grayscale frame (f32 in [0, 1], shape (H, W)).

    ``defer_optimize`` (static) removes the in-sequence pose-graph trigger:
    pending loop matches accumulate and are flushed once by ``finalize``.
    Required under ``vmap`` (batched multi-sequence mode, ``nislam_tpu.
    parallel``) where a batched ``lax.cond`` would execute the LM solve on
    every frame for every lane; also never discards single matches, unlike
    the reference's clear-on-<2 behavior (map_builder.cc:114-115) — a
    documented deviation of batch mode.

    ``defer_loop_search`` (static) removes the in-step loop search + pending
    append; the caller runs :func:`deferred_loop_search` afterwards.  Under
    ``vmap`` the in-step ``lax.cond`` on keyframe insertion executes the
    full multi-candidate search every frame for every lane (a per-lane
    tax); the batch engine instead hoists one
    any-lane-inserted ``cond`` to the scan-body level, restoring the
    keyframe duty factor (~1 in 10 frames) whenever lanes insert sparsely.

    ``features`` — precomputed :func:`frontend` output for this frame;
    when given, ``image`` is ignored (may be None).
    """
    kfs = config.keyframe_selection
    lc_cfg = config.loop_closure

    if features is None:
        features = frontend(image, cf_ops=cf_ops, camera=camera)
    img_u, fft, polar = features
    frame_id = state.track.next_frame_id

    def init_branch(state):
        # Initialize (map_builder.cc:86-97): pose 0 in every frame; insert.
        track = state.track
        zero = jnp.zeros(3, jnp.float32)
        fi, fp = compute_keyframe_filters(fft, polar, cf_ops)
        bank, slot, _, _ = add_keyframe(
            state.bank,
            fft=fft,
            polar_fft=polar,
            filt=fi,
            filt_polar=fp,
            image=img_u,
            pose=camera.image_plane_to_robot(zero),
            frame_id=frame_id,
            distance=jnp.zeros((), jnp.float32),
            grid_scale=config.map.grid_scale,
            enabled=jnp.asarray(True),
            evict=config.map.eviction == "ring",
        )
        canvas = state.canvas
        if _stitch_online(config):
            # Initialize → MapStitcher::InsertFrame (map_builder.cc:96).
            canvas = insert_frame(
                canvas, img_u, camera.image_plane_to_robot(zero), camera
            )
        state = dataclasses.replace(state, canvas=canvas)
        track = TrackState(
            last_fft=c2r(fft),
            last_polar=c2r(polar),
            last_filt=c2r(fi),
            last_filt_polar=c2r(fp),
            last_cf_pose=zero,
            last_cf_real_pose=camera.image_plane_to_camera(zero),
            last_pose=camera.image_plane_to_robot(zero),
            last_slot=slot,
            distance=jnp.zeros((), jnp.float32),
            next_frame_id=frame_id + 1,
            initialized=jnp.asarray(True),
        )
        out = StepOutput(
            tracked=jnp.asarray(True),
            inserted=jnp.asarray(True),
            loop_found=jnp.asarray(False),
            optimized=jnp.asarray(False),
            response=jnp.full((3,), jnp.inf, jnp.float32),
            cf_pose=camera.image_plane_to_robot(zero),
            pose=track.last_pose,
            frame_id=frame_id,
            keyframe_slot=slot,
            loop_slot=jnp.asarray(-1, jnp.int32),
            loop_eligible=jnp.zeros((), jnp.int32),
        )
        return dataclasses.replace(state, bank=bank, track=track), out

    def track_branch(state):
        track = state.track

        # --- Tracking (map_builder.cc:127-138) --------------------------
        rel_center, response = compute_pose(
            r2c(track.last_fft), img_u, r2c(track.last_polar), polar, cf_ops,
            large_rotation=False,
            filters=(r2c(track.last_filt), r2c(track.last_filt_polar)),
        )
        rel_principal = camera.center_to_principal(rel_center)
        good = jnp.logical_and(
            response[0] > kfs.lower_response_thr,
            response[2] > kfs.lower_rot,
        )
        cur_cf_pose = absolute_pose(track.last_cf_pose, rel_principal)
        cur_cf_real = camera.image_plane_to_camera(cur_cf_pose)

        # UpdateCurrentPose (map_builder.cc:118-125): compose in robot frame.
        rel_robot = relative_pose(
            camera.image_plane_to_robot(track.last_cf_pose),
            camera.image_plane_to_robot(cur_cf_pose),
        )
        cur_pose = absolute_pose(track.last_pose, rel_robot)

        # --- Keyframe decision (map_builder.cc:47-53) --------------------
        # ComputeRelativeDA (:158-167): componentwise cf delta → camera frame.
        da_cam = camera.image_plane_to_camera(cur_cf_pose - track.last_cf_pose)
        d = jnp.linalg.norm(da_cam[:2])
        a = jnp.abs(da_cam[2])
        c1 = d > kfs.max_distance
        c2 = a > kfs.max_angle
        c3 = jnp.logical_and(
            response[0] > kfs.lower_response_thr,
            response[0] < kfs.upper_response_thr,
        )
        c4 = jnp.logical_and(
            response[2] > kfs.lower_rot,
            response[2] < kfs.upper_rot,
        )
        insert = jnp.logical_and(good, c1 | c2 | c3 | c4)
        new_distance = track.distance + jnp.where(insert, d, 0.0)

        # --- Edge + bank insert (map_builder.cc:59-62) -------------------
        rel_cf_real = relative_pose(track.last_cf_real_pose, cur_cf_real)
        # Cached filters for the new keyframe — only paid when inserting
        # (lax.cond skips the 4 transforms on dropped/non-keyframe frames).
        fi_pair, fp_pair = jax.lax.cond(
            insert,
            lambda: tuple(
                c2r(f) for f in compute_keyframe_filters(fft, polar, cf_ops)
            ),
            lambda: (track.last_filt, track.last_filt_polar),
        )
        bank, slot, stored, evicted = add_keyframe(
            state.bank,
            fft=fft,
            polar_fft=polar,
            filt=fi_pair,
            filt_polar=fp_pair,
            image=img_u,
            pose=cur_pose,
            frame_id=frame_id,
            distance=new_distance,
            grid_scale=config.map.grid_scale,
            enabled=insert,
            evict=config.map.eviction == "ring",
            protect_slot=track.last_slot,
        )
        # Constraints referencing the evicted slot are void (its record was
        # just replaced) — invalidate BEFORE appending the new edge, which
        # legitimately targets the reused slot.
        edges = invalidate_edges(state.edges, evicted)
        edges = add_edge(
            edges,
            from_slot=track.last_slot,
            to_slot=slot,
            T=rel_cf_real,
            edge_type=EDGE_KCC,
            enabled=stored,
        )
        canvas = state.canvas
        if _stitch_online(config):
            # InsertFrame per keyframe (map_builder.cc:62); cond so dropped
            # frames never pay the H·W scatter.
            def ins(cv):
                if config.map.store_images and config.map.eviction == "ring":
                    # Retire the evicted keyframe's pixels: the canvas keeps
                    # exact running sums, so removal is the negated scatter
                    # of the OLD bank record (ADVICE r2 #3 — the online
                    # canvas stays equal to recompute(bank) at all times).
                    ei = jnp.maximum(evicted, 0)
                    cv = insert_frame(
                        cv,
                        state.bank.images[ei],
                        state.bank.poses[ei],
                        camera,
                        enabled=evicted >= 0,
                        sign=-1.0,
                    )
                return insert_frame(cv, img_u, cur_pose, camera)

            canvas = jax.lax.cond(stored, ins, lambda cv: cv, canvas)
        state = dataclasses.replace(
            state,
            bank=bank,
            edges=edges,
            canvas=canvas,
            pending=_invalidate_pending(state.pending, evicted),
        )

        # --- Loop closure (map_builder.cc:63, §2.2) ----------------------
        search = loop_search_fn if loop_search_fn is not None else find_loop_closure

        def do_search(_):
            return search(
                bank,
                img_u,
                polar,
                frame_id,
                new_distance,
                cur_pose,
                cf_ops,
                lc_cfg,
                config.map.grid_scale,
                cur_fft=fft,  # reused by the coarse-to-fine path
            )

        def no_search(_):
            return no_loop_result()

        # ``to_find_loop`` is static: with it off the search branch is never
        # even compiled (map_builder.cc:63's ternary, resolved at trace time).
        # ``defer_loop_search`` moves it to a post-step pass (batch mode).
        if lc_cfg.to_find_loop and not defer_loop_search:
            lc = jax.lax.cond(stored, do_search, no_search, None)
            loop_found = jnp.logical_and(stored, lc.found)
        else:
            lc = no_search(None)
            loop_found = jnp.asarray(False)

        # Append pending match (FindLoopClosure → _loop_matches, :172-182).
        pending = state.pending
        pslot = jnp.minimum(pending.count, pending.loop_slot.shape[0] - 1)
        fits = pending.count < pending.loop_slot.shape[0]
        padd = jnp.logical_and(loop_found, fits)
        rel_pp = camera.center_to_principal(lc.relative_pose)
        pending = PendingLoops(
            loop_slot=jnp.where(
                padd, pending.loop_slot.at[pslot].set(lc.loop_slot), pending.loop_slot
            ),
            cur_slot=jnp.where(
                padd, pending.cur_slot.at[pslot].set(slot), pending.cur_slot
            ),
            rel_pose=jnp.where(
                padd, pending.rel_pose.at[pslot].set(rel_pp), pending.rel_pose
            ),
            count=pending.count + padd.astype(jnp.int32),
        )
        state = dataclasses.replace(state, pending=pending)

        # --- Optimize trigger: keyframe inserted, no loop found ----------
        if defer_optimize:
            optimized = jnp.asarray(False)
        else:

            def maybe_opt(st):
                return _flush_pending_loops(st, config, camera, solver_fn)

            state, optimized = jax.lax.cond(
                jnp.logical_and(stored, ~loop_found),
                maybe_opt,
                lambda st: (st, jnp.asarray(False)),
                state,
            )

        # UpdateValueAfterLoop (map_builder.cc:275-279): re-derive the chain
        # from the optimized pose when the solver ran.
        opt_pose = state.bank.poses[slot]
        cur_pose = jnp.where(optimized, opt_pose, cur_pose)
        cur_cf_real = jnp.where(
            optimized, camera.robot_to_camera(opt_pose), cur_cf_real
        )
        cur_cf_pose = jnp.where(
            optimized, camera.camera_to_image_plane(camera.robot_to_camera(opt_pose)),
            cur_cf_pose,
        )

        # --- UpdateIntermedium (map_builder.cc:99-106): only on insert ----
        track = TrackState(
            last_fft=jnp.where(insert, c2r(fft), track.last_fft),
            last_polar=jnp.where(insert, c2r(polar), track.last_polar),
            last_filt=jnp.where(insert, fi_pair, track.last_filt),
            last_filt_polar=jnp.where(insert, fp_pair, track.last_filt_polar),
            last_cf_pose=jnp.where(insert, cur_cf_pose, track.last_cf_pose),
            last_cf_real_pose=jnp.where(insert, cur_cf_real, track.last_cf_real_pose),
            last_pose=jnp.where(insert, cur_pose, track.last_pose),
            last_slot=jnp.where(stored, slot, track.last_slot),
            distance=new_distance,
            next_frame_id=frame_id + 1,
            initialized=jnp.asarray(True),
        )
        state = dataclasses.replace(state, track=track)

        # GetCFPose (map_builder.cc:282-291): raw odometry in robot frame
        # relative to the robot pose of the cf origin.
        cf_pose = relative_pose(
            camera.image_plane_to_robot(jnp.zeros(3, jnp.float32)),
            camera.image_plane_to_robot(cur_cf_pose),
        )
        out = StepOutput(
            tracked=good,
            inserted=insert,
            loop_found=loop_found,
            optimized=optimized,
            response=response,
            cf_pose=cf_pose,
            pose=cur_pose,
            frame_id=frame_id,
            keyframe_slot=jnp.where(stored, slot, -1),
            loop_slot=jnp.where(loop_found, lc.loop_slot, -1),
            loop_eligible=lc.eligible_count,
        )
        return state, out

    return jax.lax.cond(state.track.initialized, track_branch, init_branch, state)


def deferred_loop_search(
    state: SlamState,
    features: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
    out: StepOutput,
    *,
    config: SlamConfig,
    cf_ops: CFOps,
    camera: CameraOps,
    loop_search_fn=None,
) -> Tuple[SlamState, StepOutput]:
    """The loop search + pending append a ``defer_loop_search=True`` step
    skipped — bitwise-identical inputs to the in-step cond (the step has
    already inserted the keyframe and invalidated evicted pendings, exactly
    the state the inline search sees).  The batch engine vmaps this and
    guards the whole pass with ONE any-lane-stored ``lax.cond`` at the
    scan-body level; per-lane sparsity is restored by the inner cond only
    when that outer cond fires.

    Gate: a keyframe was stored this frame and it was not the
    initialization frame (``init_branch`` never searches).
    """
    img_u, _fft, polar = features
    lc_cfg = config.loop_closure
    search = loop_search_fn if loop_search_fn is not None else find_loop_closure
    stored = jnp.logical_and(out.keyframe_slot >= 0, out.frame_id > 0)

    def do_search(_):
        return search(
            state.bank,
            img_u,
            polar,
            out.frame_id,
            state.track.distance,
            out.pose,
            cf_ops,
            lc_cfg,
            config.map.grid_scale,
        )

    def no_search(_):
        return no_loop_result()

    lc = jax.lax.cond(stored, do_search, no_search, None)
    loop_found = jnp.logical_and(stored, lc.found)

    # Pending append — the verbatim logic of the in-step path.
    pending = state.pending
    pslot = jnp.minimum(pending.count, pending.loop_slot.shape[0] - 1)
    fits = pending.count < pending.loop_slot.shape[0]
    padd = jnp.logical_and(loop_found, fits)
    rel_pp = camera.center_to_principal(lc.relative_pose)
    pending = PendingLoops(
        loop_slot=jnp.where(
            padd, pending.loop_slot.at[pslot].set(lc.loop_slot), pending.loop_slot
        ),
        cur_slot=jnp.where(
            padd,
            pending.cur_slot.at[pslot].set(out.keyframe_slot),
            pending.cur_slot,
        ),
        rel_pose=jnp.where(
            padd, pending.rel_pose.at[pslot].set(rel_pp), pending.rel_pose
        ),
        count=pending.count + padd.astype(jnp.int32),
    )
    state = dataclasses.replace(state, pending=pending)
    out = out._replace(
        loop_found=loop_found,
        loop_slot=jnp.where(loop_found, lc.loop_slot, -1),
        loop_eligible=lc.eligible_count,
    )
    return state, out
