"""Profile one HD chunk with jax.profiler and print top device ops.

Parses the trace-viewer events from the profile dump for exact op-level
attribution on the GPU device planes (``/device:GPU:N``).
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from nislam_tpu.core.config import (
        CFConfig,
        CameraConfig,
        KeyframeSelectionConfig,
        LoopClosureConfig,
        MapConfig,
        SlamConfig,
        derive_response_thresholds,
    )
    from nislam_tpu.core.slam import make_engine
    from nislam_tpu.utils.synthetic import (
        heading_loop_path,
        make_world,
        render_sequence,
    )

    # Default: the HD config.  NISLAM_PROF_SIZE="H W [D C]" re-points the
    # trace at another operating point (e.g. "480 640" for the flagship).
    size = os.environ.get("NISLAM_PROF_SIZE", "1200 1600").split()
    h, w = int(size[0]), int(size[1])
    rd, rc = (int(size[2]), int(size[3])) if len(size) >= 4 else (720, 480)
    coarse = int(os.environ.get("NISLAM_BENCH_COARSE", "4"))
    n = int(os.environ.get("NISLAM_PROF_FRAMES", "48"))
    fx = float(w)
    px = 1.0 / fx
    step_px = 8.0
    thr = derive_response_thresholds(w, h, rd, rc)
    config = SlamConfig(
        cf=CFConfig(width=w, height=h, rotation_divisor=rd, rotation_channel=rc),
        keyframe_selection=KeyframeSelectionConfig(
            max_distance=10.0 * step_px * px, max_angle=0.05236,
            lower_response_thr=thr["lower_response_thr"],
            upper_response_thr=thr["upper_response_thr"],
            lower_rotation_response_thr=thr["lower_rotation_response_thr"],
            upper_rotation_response_thr=thr["upper_rotation_response_thr"],
        ),
        map=MapConfig(
            grid_scale=0.3 * h * px, keyframe_capacity=256, edge_capacity=256,
            store_images=False, cache_filters=True, bank_dtype="bf16",
        ),
        loop_closure=LoopClosureConfig(
            to_find_loop=True,
            position_response_thr=thr["position_response_thr"],
            angle_response_thr=thr["angle_response_thr"],
            frame_gap_thr=30, distance_thr=16 * step_px * px,
            max_candidates=8, coarse_scale=coarse,
        ),
        camera=CameraConfig(
            image_width=w, image_height=h, height=1.0,
            intrinsics=(fx, w / 2.0, fx, h / 2.0),
        ),
    )
    world = make_world(4096, 3.0, seed=42)
    path = heading_loop_path(n, step_px, start=(2048.0, 2048.0))
    imgs = render_sequence(world, h, w, path).astype(np.float32)

    eng = make_engine(config)
    state = eng.init_state()
    x = jnp.asarray(imgs)
    state, outs = eng.run_chunk(state, x)  # compile + warm
    np.asarray(outs.frame_id)

    outdir = "/tmp/hdtrace"
    os.system(f"rm -rf {outdir}")
    state2 = eng.init_state()
    with jax.profiler.trace(outdir):
        state2, outs2 = eng.run_chunk(state2, x)
        np.asarray(outs2.frame_id)

    # parse trace events
    files = glob.glob(f"{outdir}/**/*.trace.json.gz", recursive=True)
    if not files:
        print("no trace files found under", outdir)
        os.system(f"find {outdir} -type f | head -20")
        return 1
    with gzip.open(files[0], "rt") as f:
        trace = json.load(f)
    events = [
        e for e in trace.get("traceEvents", [])
        if e.get("ph") == "X" and "dur" in e
    ]
    # keep device-lane events (TensorFlow Op / XLA Op tracks)
    agg = {}
    pid_names = {
        e["pid"]: e["args"].get("name", "")
        for e in trace.get("traceEvents", [])
        if e.get("ph") == "M" and e.get("name") == "process_name" and "args" in e
    }
    for e in events:
        pname = pid_names.get(e["pid"], "")
        if "/device:GPU" not in pname:
            continue
        key = (pname.split("/")[-1][:30], e["name"][:60])
        agg[key] = agg.get(key, 0) + e["dur"]
    top = sorted(agg.items(), key=lambda kv: -kv[1])[:40]
    total = sum(agg.values())
    print(f"pids: {set(pid_names.values())}")
    print(f"total accounted: {total/1e3:.1f} ms over {n} frames")
    for (lane, name), dur in top:
        print(f"{dur/1e3:9.2f} ms  {lane:28s} {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
