"""Per-frame step-mode latency on the current device (VERDICT r4 #4).

The reference's operating mode is a live ≤50 Hz loop with per-frame
latency prints (/root/reference/main.cpp:47,61-65).  This measures
`engine.step` (+ the deferred `optimize` trigger) per frame at the
flagship config: p50/p90/p99 over N frames with an honest d2h fence,
for both dispatch structures:

- deferred: step dispatch + optimize dispatch per frame (2 round trips),
- inline:   the pose-graph trigger compiled INTO the step (1 round trip).

Also measures the device's bare dispatch+fence floor at the same moment,
so latency numbers can be read next to it.

Usage: python scripts/stepbench.py [--frames 500] [--size 640|256]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--size", type=int, default=640)
    args = ap.parse_args()

    import dataclasses

    import jax
    import jax.numpy as jnp

    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"),
    )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)

    from nislam_tpu.core.config import (
        CFConfig,
        CameraConfig,
        KeyframeSelectionConfig,
        LoopClosureConfig,
        MapConfig,
        OptimizerConfig,
        SlamConfig,
        derive_response_thresholds,
    )
    from nislam_tpu.core.slam import make_engine
    from nislam_tpu.utils.synthetic import (
        heading_loop_path,
        make_world,
        render_sequence,
    )

    if args.size == 640:
        h, w, rd, rc = 480, 640, 720, 480
        world_n, step_px = 4096, 8.0
    elif args.size == 1200:
        h, w, rd, rc = 1200, 1600, 720, 480
        world_n, step_px = 4096, 8.0
    else:
        h, w, rd, rc = 256, 256, 360, 64
        world_n, step_px = 2048, 4.0
    fx = float(w)
    px = 1.0 / fx
    thr = derive_response_thresholds(w, h, rd, rc)
    base = SlamConfig(
        cf=CFConfig(width=w, height=h, rotation_divisor=rd, rotation_channel=rc),
        keyframe_selection=KeyframeSelectionConfig(
            max_distance=10.0 * step_px * px, max_angle=0.05236,
            lower_response_thr=thr["lower_response_thr"],
            upper_response_thr=thr["upper_response_thr"],
            lower_rotation_response_thr=thr["lower_rotation_response_thr"],
            upper_rotation_response_thr=thr["upper_rotation_response_thr"],
        ),
        map=MapConfig(
            grid_scale=0.3 * h * px,
            keyframe_capacity=256 if args.size != 1200 else 128,
            edge_capacity=1024, store_images=False,
            cache_filters=True, bank_dtype="bf16",
        ),
        loop_closure=LoopClosureConfig(
            to_find_loop=True,
            position_response_thr=thr["position_response_thr"],
            angle_response_thr=thr["angle_response_thr"],
            frame_gap_thr=30, distance_thr=16 * step_px * px,
            max_candidates=8,
        ),
        camera=CameraConfig(
            image_width=w, image_height=h, height=1.0,
            intrinsics=(fx, w / 2.0, fx, h / 2.0),
        ),
    )
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}  {h}x{w} polar {rd}x{rc}",
          flush=True)

    n = args.frames
    rng = np.random.default_rng(0)
    world = make_world(world_n, 3.0)
    poses = heading_loop_path(n, step_px, start=(world_n / 2.0,) * 2)
    t0 = time.time()
    frames = render_sequence(world, h, w, poses).astype(np.float32)
    print(f"data gen: {time.time()-t0:.1f}s", flush=True)

    # bare dispatch+fence floor right now
    @jax.jit
    def tiny(x):
        return x + 1.0

    z = jnp.float32(0)
    np.asarray(tiny(z))
    floors = []
    for _ in range(50):
        t0 = time.time()
        np.asarray(tiny(z))
        floors.append(time.time() - t0)
    floors = np.array(floors) * 1e3
    print(f"dispatch+fence floor: p50 {np.percentile(floors,50):.1f} ms  "
          f"p99 {np.percentile(floors,99):.1f} ms", flush=True)

    # u8 frames: the camera's native 8-bit payload, 4× fewer upload bytes
    # (the engine normalizes /255 on device, bit-identical).
    frames_u8 = np.clip(frames * 255.0, 0, 255).astype(np.uint8)

    from nislam_tpu.core.slam import unpack_step_output

    def run(label, config, two_dispatch, u8=True):
        eng = make_engine(config)
        state = eng.init_state()
        src = frames_u8 if u8 else frames
        img0 = jnp.asarray(src[0])
        t0 = time.time()
        state, out = eng.step_packed(state, img0)
        if two_dispatch:
            state, _ = eng.optimize(state)
        np.asarray(out)
        print(f"{label}: compile {time.time()-t0:.1f}s", flush=True)
        state = eng.init_state()
        lat = []
        tracked = 0
        loops = 0
        for i in range(n):
            t1 = time.time()
            img = jnp.asarray(src[i])  # upload inside the latency budget
            state, out = eng.step_packed(state, img)
            if two_dispatch:
                state, _ = eng.optimize(state)
            o = unpack_step_output(out)  # ONE (17,) f32 readback = fence
            lat.append(time.time() - t1)
            tracked += int(o.tracked)
            loops += int(o.loop_found)
        lat = np.array(lat) * 1e3
        print(
            f"{label}: p50 {np.percentile(lat,50):6.1f} ms  "
            f"p90 {np.percentile(lat,90):6.1f} ms  "
            f"p99 {np.percentile(lat,99):6.1f} ms  max {lat.max():6.1f} ms  "
            f"| tracked {tracked}/{n} loops {loops} "
            f"| sustainable {1e3/np.percentile(lat,99):.0f} Hz @p99",
            flush=True,
        )
        return lat

    run("deferred 2-dispatch, packed out", base, True)
    inline_cfg = dataclasses.replace(
        base, optimizer=OptimizerConfig(inline=True)
    )
    run("inline 1-dispatch, packed out", inline_cfg, False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
