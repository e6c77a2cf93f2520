"""Fixed-capacity keyframe + edge stores in device memory.

Re-design of the reference ``Map`` (/root/reference/include/map.h,
/root/reference/src/map.cc): the ``std::map<int, FramePtr>`` keyframe store,
``std::map<int, EdgePtr>`` edge store, per-frame travel distance, and the
spatial hash ``GridMap`` all become preallocated dense arrays with an integer
cursor, so every operation is a static-shape masked update or gather that
lives inside one jitted program.

Key semantic choices carried over from the reference:

- the **grid location is captured at insertion time** and never rehashed when
  poses are optimized (``Map::AddFrame`` inserts into ``_grid_map`` using the
  pose at insert, ``Map::UpdatePoses`` does not touch the grid —
  /root/reference/src/map.cc:17-30,73-79),
- grid coordinates use C truncation-toward-zero (``static_cast<int>(x /
  _grid_scale)``, /root/reference/src/map.cc:81-85),
- the base frame is slot 0 and is pinned by the optimizer
  (/root/reference/src/map.cc:18-21).

Unlike the reference's unbounded RAM growth (SURVEY §5), capacities are
explicit.  Bank overflow policy (``MapConfig.eviction``): **ring** (default)
evicts the oldest non-base keyframe — slot 0 (the optimizer's pinned base,
/root/reference/src/map.cc:18-21) and the current tracking target are spared
— reusing its slot for the new record and invalidating edges/pending matches
that reference it; **drop** discards the new keyframe (tracking continues —
the dropped frame still becomes the registration target).  ``overflow``
counts evictions (ring) or drops (drop).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from nislam_tpu.core.config import CFConfig, MapConfig

# Edge types — /root/reference/include/edge.h:12 (Odom is never produced).
EDGE_NONE = 0
EDGE_KCC = 1
EDGE_LOOP = 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KeyframeBank:
    """Ring of keyframe records: spectra + pose + bookkeeping.

    Replaces ``Frame`` (/root/reference/include/frame.h:32-39) fields
    {id, timestamp, image, fft, polar fft, pose} and the per-frame distance
    map (/root/reference/include/map.h:71).  The never-used
    ``_depth_fft_result`` is intentionally absent (SURVEY §2 #3).
    """

    # Spectra live as float pairs (re, im innermost) — ops.fft.c2r — so the
    # bank supports gather/scatter and host transfer on every backend; r2c
    # happens at the point of use inside the consuming program.
    #
    # (A flat (K, N) row store was tried in r5 to kill a residual
    # whole-bank layout copy on the candidate-slice path — and REVERTED:
    # 2-D puts K in the (8, 128) tile's sublane dimension, making every
    # row op strided; flagship throughput dropped 3×.  The 4-D layout
    # keeps K purely major; the remaining per-search bank layout copy is
    # ~2% of HD frame time and accepted.)
    fft: jnp.ndarray  # (K, H, W//2+1, 2) — image spectra
    polar_fft: jnp.ndarray  # (K, D, C//2+1, 2) — polar spectra
    # Cached correlation filters H = target/(Kzz+λ) (ops.registration.
    # keyframe_filter): computed once at insertion instead of per
    # registration — the reference recomputes Kzz on every EstimateTrans.
    filt: jnp.ndarray  # (K, H, W//2+1, 2) or (K, 0, 0, 2)
    filt_polar: jnp.ndarray  # (K, D, C//2+1, 2) or (K, 0, 0, 2)
    images: jnp.ndarray  # (K, H, W) f32 — raw frames (for the stitcher), or (K,0,0)
    poses: jnp.ndarray  # (K, 3) f32 — robot-frame (x, y, θ), optimized in place
    grid_xy: jnp.ndarray  # (K, 2) i32 — spatial-hash cell captured at insertion
    frame_ids: jnp.ndarray  # (K,) i32 — global input-frame id
    distances: jnp.ndarray  # (K,) f32 — accumulated travel distance
    count: jnp.ndarray  # () i32 — number of live slots (saturates at capacity)
    overflow: jnp.ndarray  # () i32 — evictions (ring) / drops (drop) since start
    evict_cursor: jnp.ndarray  # () i32 — ring position over slots 1..K-1

    @property
    def capacity(self) -> int:
        return self.fft.shape[0]

    def valid_mask(self) -> jnp.ndarray:
        return jnp.arange(self.capacity) < self.count


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EdgeStore:
    """Pose-graph constraints — ``Edge`` (/root/reference/include/edge.h:10-24).

    ``from_slot``/``to_slot`` index bank slots (not frame ids — slots are
    contiguous, which keeps the optimizer assembly gather-friendly).  ``T`` is
    the relative pose in the **camera frame**, exactly as the reference stores
    edge ``_T`` (/root/reference/src/map_builder.cc:140-156,184-194); the
    optimizer converts camera→robot at assembly time
    (/root/reference/src/map_builder.cc:240).
    """

    from_slot: jnp.ndarray  # (E,) i32
    to_slot: jnp.ndarray  # (E,) i32
    T: jnp.ndarray  # (E, 3) f32 — camera-frame (x, y, θ)
    info: jnp.ndarray  # (E, 3, 3) f32 — information matrix (identity in practice)
    types: jnp.ndarray  # (E,) i32 — EDGE_KCC / EDGE_LOOP
    alive: jnp.ndarray  # (E,) bool — written and not invalidated by eviction
    count: jnp.ndarray  # () i32
    overflow: jnp.ndarray  # () i32

    @property
    def capacity(self) -> int:
        return self.from_slot.shape[0]

    def valid_mask(self) -> jnp.ndarray:
        return self.alive


def make_keyframe_bank(cf: CFConfig, map_cfg: MapConfig) -> KeyframeBank:
    k = map_cfg.keyframe_capacity
    h, w = cf.height, cf.width
    d, c = cf.polar_shape
    img_shape = (k, h, w) if map_cfg.store_images else (k, 0, 0)
    fshape = (k, h, w // 2 + 1, 2) if map_cfg.cache_filters else (k, 0, 0, 2)
    fpshape = (k, d, c // 2 + 1, 2) if map_cfg.cache_filters else (k, 0, 0, 2)
    if map_cfg.bank_dtype not in ("f32", "bf16"):
        raise ValueError(f"invalid bank_dtype {map_cfg.bank_dtype!r}")
    sdt = jnp.bfloat16 if map_cfg.bank_dtype == "bf16" else jnp.float32
    return KeyframeBank(
        fft=jnp.zeros((k, h, w // 2 + 1, 2), sdt),
        polar_fft=jnp.zeros((k, d, c // 2 + 1, 2), sdt),
        filt=jnp.zeros(fshape, sdt),
        filt_polar=jnp.zeros(fpshape, sdt),
        images=jnp.zeros(img_shape, jnp.float32),
        poses=jnp.zeros((k, 3), jnp.float32),
        grid_xy=jnp.zeros((k, 2), jnp.int32),
        frame_ids=jnp.full((k,), -1, jnp.int32),
        distances=jnp.zeros((k,), jnp.float32),
        count=jnp.zeros((), jnp.int32),
        overflow=jnp.zeros((), jnp.int32),
        evict_cursor=jnp.zeros((), jnp.int32),
    )


def make_edge_store(map_cfg: MapConfig) -> EdgeStore:
    e = map_cfg.edge_capacity
    return EdgeStore(
        from_slot=jnp.zeros((e,), jnp.int32),
        to_slot=jnp.zeros((e,), jnp.int32),
        T=jnp.zeros((e, 3), jnp.float32),
        info=jnp.zeros((e, 3, 3), jnp.float32),
        types=jnp.zeros((e,), jnp.int32),
        alive=jnp.zeros((e,), bool),
        count=jnp.zeros((), jnp.int32),
        overflow=jnp.zeros((), jnp.int32),
    )


def gather_slots_c2r(
    arr: jnp.ndarray,
    slots: jnp.ndarray,
    c: int,
    shape: tuple[int, int],
) -> jnp.ndarray:
    """Gather ``c`` spectral bank slots → complex64 ``(c, *shape)``.

    ``r2c(arr[slots])`` (an XLA gather) on a large bank can make the
    compiler layout-copy the ENTIRE bank into gather-friendly form first.
    ``c`` per-slot ``dynamic_slice``
    reads touch only the selected slots at the bank's native layout,
    with the f32 upcast applied PER SLICE — converting after
    concatenation lets XLA hoist the layout conversion back onto the
    whole bank.  ``c`` is static and small (max_candidates), so the
    unroll is cheap.  ``shape`` documents/asserts the per-slot spectrum
    shape ``(rows, cols)``.
    """
    from nislam_tpu.ops.fft import r2c

    assert arr.shape[1:] == (*shape, 2), (arr.shape, shape)
    # Residual (documented, accepted): XLA's layout assignment still
    # reconciles the while-carry bank layout with the slice path's by ONE
    # whole-bank copy per executed search.  An optimization_barrier around the per-slice
    # upcast was tried and does not remove it (the copy is placed at the
    # cond-computation boundary, not at the convert); neither does a flat
    # (K, N) store (slower overall — see KeyframeBank).
    parts = [
        jax.lax.dynamic_slice_in_dim(arr, slots[i], 1, axis=0).astype(
            jnp.float32
        )
        for i in range(c)
    ]
    return r2c(jnp.concatenate(parts, axis=0))


def grid_location(xy: jnp.ndarray, grid_scale: float) -> jnp.ndarray:
    """Spatial-hash cell of a robot-frame position.

    C-cast semantics of ``Map::ComputeGridLocation``
    (/root/reference/src/map.cc:81-85): truncation toward zero.
    """
    return jnp.trunc(xy / grid_scale).astype(jnp.int32)


class InsertResult(NamedTuple):
    bank: "KeyframeBank"
    slot: jnp.ndarray  # () i32 — slot written (or would-be slot if not stored)
    stored: jnp.ndarray  # () bool — the record actually landed in the bank
    evicted: jnp.ndarray  # () i32 — slot whose previous record was evicted, else -1


def add_keyframe(
    bank: KeyframeBank,
    *,
    fft: jnp.ndarray,
    polar_fft: jnp.ndarray,
    filt: jnp.ndarray | None = None,
    filt_polar: jnp.ndarray | None = None,
    image: jnp.ndarray,
    pose: jnp.ndarray,
    frame_id: jnp.ndarray,
    distance: jnp.ndarray,
    grid_scale: float,
    enabled: jnp.ndarray,
    evict: bool = True,
    protect_slot: jnp.ndarray | None = None,
) -> InsertResult:
    """Masked insert of one keyframe.

    ``enabled`` gates the whole write (the jit-friendly replacement for the
    reference's Python-level branch).  When the bank is full: with ``evict``
    (static, from ``MapConfig.eviction == "ring"``) the oldest non-base slot
    on the ring — skipping ``protect_slot``, the current tracking target —
    is reused and reported in ``evicted`` (callers must invalidate edges and
    pending matches referencing it, :func:`invalidate_edges`); without it
    the record is dropped (``stored=False``).  ``overflow`` counts either.

    Spectra/filters may be complex (as produced by ``compute_intermedium`` /
    ``compute_keyframe_filters``) or already float pairs.  Omitting the
    cached filters leaves the slot's filter entries untouched (zeros in a
    fresh bank) — hot-path callers must supply them, since registration
    consumes ``bank.filt`` directly.
    """
    from nislam_tpu.ops.fft import c2r

    def as_pair(x):
        return c2r(x) if x is not None and jnp.iscomplexobj(x) else x

    fft = as_pair(fft)
    polar_fft = as_pair(polar_fft)
    filt = as_pair(filt)
    filt_polar = as_pair(filt_polar)
    k = bank.capacity
    fits = bank.count < k
    cursor = bank.evict_cursor
    if evict and k > 2:
        victim = 1 + jnp.mod(cursor, k - 1)
        if protect_slot is not None:
            skip = victim == protect_slot
            victim = jnp.where(skip, 1 + jnp.mod(cursor + 1, k - 1), victim)
        else:
            skip = jnp.asarray(False)
        slot = jnp.where(fits, bank.count, victim)
        do = enabled
        evicting = jnp.logical_and(enabled, ~fits)
        cursor = cursor + jnp.where(evicting, 1 + skip.astype(jnp.int32), 0)
        evicted = jnp.where(evicting, slot, -1)
    else:
        slot = jnp.minimum(bank.count, k - 1)
        do = jnp.logical_and(enabled, fits)
        evicted = jnp.asarray(-1, jnp.int32)
    # Masked write as an out-of-bounds scatter with mode='drop': a disabled
    # insert writes nothing and an enabled one updates ONE slot in place.
    # (A `jnp.where(do, buf.at[slot].set(v), buf)` select would materialize
    # a full copy of every bank field per insert attempt — gigabytes of device-memory
    # traffic per scanned block at 256-slot capacity.)
    wslot = jnp.where(do, slot, k)

    def wr(buf, val):
        return buf.at[wslot].set(val.astype(buf.dtype), mode="drop")

    images = bank.images
    if images.shape[1]:
        images = wr(images, image)
    return InsertResult(
        bank=KeyframeBank(
            fft=wr(bank.fft, fft),
            polar_fft=wr(bank.polar_fft, polar_fft),
            filt=(
                bank.filt
                if filt is None or bank.filt.shape[1] == 0
                else wr(bank.filt, filt)
            ),
            filt_polar=(
                bank.filt_polar
                if filt_polar is None or bank.filt_polar.shape[1] == 0
                else wr(bank.filt_polar, filt_polar)
            ),
            images=images,
            poses=wr(bank.poses, pose),
            grid_xy=wr(bank.grid_xy, grid_location(pose[:2], grid_scale)),
            frame_ids=wr(bank.frame_ids, frame_id),
            distances=wr(bank.distances, distance),
            count=bank.count + jnp.logical_and(do, fits).astype(jnp.int32),
            overflow=bank.overflow
            + jnp.logical_and(enabled, ~fits).astype(jnp.int32),
            evict_cursor=cursor,
        ),
        slot=slot,
        stored=do,
        evicted=evicted,
    )


def add_edge(
    edges: EdgeStore,
    *,
    from_slot: jnp.ndarray,
    to_slot: jnp.ndarray,
    T: jnp.ndarray,
    edge_type: int | jnp.ndarray,
    enabled: jnp.ndarray,
    info: jnp.ndarray | None = None,
) -> EdgeStore:
    """Masked insert of one constraint (identity information by default,
    matching /root/reference/src/map_builder.cc:142,191).

    Slot lifecycle (r2 ADVICE/VERDICT #7 — bounded must not mean silently
    lossy): dead slots (edges invalidated by keyframe ring eviction,
    :func:`invalidate_edges`) are **reclaimed first**, so on long runs the
    store reaches a steady state where each evicted keyframe's voided edges
    make room for the new keyframe's constraints.  Only when the buffer is
    full with zero dead slots does it degrade: the lowest-slot alive **KCC**
    edge is overwritten (Loop edges — the rare, valuable constraints — are
    always preserved), and if even that fails (all alive edges are loops)
    the new edge is dropped.  Both forced paths bump ``overflow``, which
    CLI/bench surface as a warning.  ``count`` stays the high-water mark of
    used slots (reclaims do not increment it).
    """
    if info is None:
        info = jnp.eye(3, dtype=jnp.float32)
    cap = edges.capacity
    idx = jnp.arange(cap)
    used = idx < edges.count
    dead = jnp.logical_and(~edges.alive, used)
    has_dead = jnp.any(dead)
    first_dead = jnp.argmax(dead)  # first True in slot order
    fits = edges.count < cap
    # Forced-replacement victim: first alive KCC edge (never a Loop edge).
    kcc = jnp.logical_and(edges.alive, edges.types == EDGE_KCC)
    has_kcc = jnp.any(kcc)
    kcc_victim = jnp.argmax(kcc)
    slot = jnp.where(
        has_dead, first_dead, jnp.where(fits, edges.count, kcc_victim)
    )
    placeable = jnp.logical_or(has_dead, jnp.logical_or(fits, has_kcc))
    do = jnp.logical_and(enabled, placeable)
    appended = jnp.logical_and(do, jnp.logical_and(~has_dead, fits))
    forced = jnp.logical_and(enabled, jnp.logical_and(~has_dead, ~fits))
    wslot = jnp.where(do, slot, cap)  # OOB scatter drops (no copy)

    def wr(buf, val):
        return buf.at[wslot].set(jnp.asarray(val, buf.dtype), mode="drop")

    return EdgeStore(
        from_slot=wr(edges.from_slot, from_slot),
        to_slot=wr(edges.to_slot, to_slot),
        T=wr(edges.T, T),
        info=wr(edges.info, info),
        types=wr(edges.types, edge_type),
        alive=wr(edges.alive, jnp.asarray(True)),
        count=edges.count + appended.astype(jnp.int32),
        overflow=edges.overflow + forced.astype(jnp.int32),
    )


def invalidate_edges(edges: EdgeStore, evicted_slot: jnp.ndarray) -> EdgeStore:
    """Disable every edge referencing an evicted bank slot (no-op for -1).

    Ring eviction reuses the slot for a new keyframe; constraints built
    against the old record would silently link wrong poses otherwise.
    """
    ref = jnp.logical_or(
        edges.from_slot == evicted_slot, edges.to_slot == evicted_slot
    )
    kill = jnp.logical_and(ref, evicted_slot >= 0)
    return dataclasses.replace(edges, alive=jnp.logical_and(edges.alive, ~kill))


def frames_in_neighborhood(
    bank: KeyframeBank, prior_pose: jnp.ndarray, grid_scale: float
) -> jnp.ndarray:
    """Mask of keyframes whose insertion-time grid cell is in the 3×3
    neighborhood of ``prior_pose``'s cell.

    Vectorized equivalent of ``Map::GetFramesInGrids`` over the 3×3 offsets
    of ``LoopClosure::FindLoopClosure`` (/root/reference/src/map.cc:93-101,
    /root/reference/src/loop_closure.cc:19-31): the hash lookup becomes a
    masked compare over the whole bank — O(K) vector work instead of O(1)
    pointer chasing, which is the right trade on a 8×128-lane VPU.
    """
    cur = grid_location(prior_pose[:2], grid_scale)
    near = jnp.all(jnp.abs(bank.grid_xy - cur[None, :]) <= 1, axis=-1)
    return jnp.logical_and(near, bank.valid_mask())
