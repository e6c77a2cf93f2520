"""Command-line app — the equivalent of the reference's ROS node.

Mirrors ``main()`` (/root/reference/main.cpp:32-99): config → dataset →
engine → per-frame loop → end-of-dataset optimize → trajectory dumps
(``KCC_Keyframe.txt`` + ``optimized_keyframe.txt`` in TUM format) — minus the
ROS transport (offline artifacts instead: trajectory plot, occupancy PNG),
plus what the reference lacks: a scan (chunked, on-device) execution mode,
state checkpointing/resume, and ATE evaluation against ground truth.

Usage:
    python -m nislam_tpu run --config configs/synthetic.yaml
    python -m nislam_tpu run --config cfg.yaml --mode step   # per-frame ms prints
    python -m nislam_tpu pack --dataroot DATA --out frames.nisf
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List

import numpy as np


def _add_run_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", required=True, help="YAML config path")
    p.add_argument("--dataroot", default=None, help="override dataset.dataroot")
    p.add_argument(
        "--mode", choices=["scan", "step"], default="scan",
        help="scan: chunked lax.scan on device (fast); step: per-frame jitted "
        "steps with latency prints (reference main.cpp behavior)",
    )
    p.add_argument("--chunk", type=int, default=64, help="scan chunk length")
    p.add_argument("--max-frames", type=int, default=0, help="truncate dataset")
    p.add_argument("--saving-root", default=None, help="override saving.saving_root")
    p.add_argument("--load-state", default=None, help="resume from checkpoint")
    p.add_argument("--save-state", default=None, help="write final state checkpoint")
    p.add_argument("--groundtruth", default=None, help="TUM groundtruth file for ATE")
    p.add_argument("--plot", action="store_true", help="save trajectory plot")
    p.add_argument(
        "--stitch", action="store_true",
        help="rasterize the occupancy mosaic and save it as PNG",
    )
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a jax.profiler trace of the run into DIR (TensorBoard)",
    )
    p.add_argument(
        "--nisf", default=None, metavar="PATH",
        help="stream frames from a packed NISF file through the native "
        "C++ prefetch loader (io.native_loader) instead of decoding "
        "images in Python; 'auto' (the default) uses DATAROOT/frames.nisf "
        "when present and the loader builds; 'off' disables",
    )
    p.add_argument(
        "--calibrate", type=int, default=0, metavar="K", nargs="?", const=32,
        help="before running, measure the PSR anchors on the first K "
        "(default 32) dataset frames and rescale every response threshold "
        "to the measured texture (core.calibrate; the sqrt-area law alone "
        "cannot supply the texture anchor — docs/TEXTURES_r4.md)",
    )
    p.add_argument(
        "--snapshot-every", type=int, default=0, metavar="N",
        help="in step mode: save trajectory/occupancy snapshot PNGs to "
        "saving_root every N frames (the reference publishes live ROS "
        "topics per frame, visualization.cc:15-32; 0 disables)",
    )


def cmd_run(args: argparse.Namespace) -> int:
    import jax
    import jax.numpy as jnp

    from nislam_tpu.core.config import load_config
    from nislam_tpu.core.slam import make_engine
    from nislam_tpu.io.checkpoint import load_state, save_state
    from nislam_tpu.io.dataset import open_dataset
    from nislam_tpu.io.trajectory import ate_rmse, read_tum, write_tum

    config = load_config(args.config)
    dataroot = args.dataroot or config.dataset.dataroot
    dataset = open_dataset(dataroot, config.dataset.image_dir_name or "rgb")
    n = len(dataset)
    if args.max_frames:
        n = min(n, args.max_frames)
    print(f"dataset: {dataroot} ({n} frames)")

    if getattr(args, "calibrate", 0):
        from nislam_tpu.core.calibrate import (
            apply_thresholds,
            calibrate_thresholds,
        )

        k = min(args.calibrate, n)
        probe = np.stack([dataset.get_raw(i)[0] for i in range(k)])
        thr, diag = calibrate_thresholds(config, probe)
        config = apply_thresholds(config, thr)
        print(
            f"calibrated thresholds on {k} frames "
            f"(texture ratio t={diag['texture_ratio_translation']} "
            f"r={diag['texture_ratio_rotation']}; tracking margin "
            f"{diag['margin_tracking']}x, loop separation "
            f"{diag['separation_position']}x): "
            + ", ".join(f"{kk}={vv}" for kk, vv in thr.items())
        )

    engine = make_engine(config)
    state = engine.init_state()
    if args.load_state:
        state = load_state(args.load_state, state)
        print(f"resumed from {args.load_state} ({int(state.bank.count)} keyframes)")

    import contextlib

    if args.profile:
        from nislam_tpu.utils.profiling import trace

        prof_ctx = trace(args.profile)
    else:
        prof_ctx = contextlib.nullcontext()

    # Mid-run pose-graph triggering (CheckAndOptimize parity,
    # map_builder.cc:108-116): in deferred mode the separately-jitted
    # `optimize` program runs per frame (step mode) / per chunk (scan mode);
    # its lax.cond body only executes when ≥2 loop matches are pending, so
    # the extra dispatch is cheap.  With optimizer.inline the solve is
    # already compiled into the step itself.
    deferred = not config.optimizer.inline
    mid_run_solves = 0
    all_times: List[float] = []
    outs_list = []

    # Input source: the native NISF prefetch reader (C++ mmap + prefetch
    # threads, io.native_loader) when a packed file is available — the
    # high-throughput replacement for the reference's per-frame imread
    # (/root/reference/src/dataset.cc:38-46) — else the Python dataset.
    nisf_path = None
    if args.nisf not in ("off",):
        cand = args.nisf if args.nisf not in (None, "auto") else os.path.join(
            dataroot, "frames.nisf"
        )
        if os.path.exists(cand):
            from nislam_tpu.io.native_loader import NativeChunkReader

            if NativeChunkReader.available():
                nisf_path = cand
            else:
                from nislam_tpu.io.dataset import NisfDataset

                dataset = NisfDataset(cand)
                n = min(n, len(dataset))
                print(
                    f"native loader unavailable; reading {cand} through numpy"
                )
        elif args.nisf not in (None, "auto"):
            print(f"WARNING: NISF file {cand} not found; using Python reader")

    t_start = time.time()
    prof_ctx.__enter__()
    if args.mode == "step":
        snap = None
        if args.snapshot_every:
            from nislam_tpu.io.visualization import RunSnapshotter

            snap = RunSnapshotter(
                args.saving_root or config.saving.saving_root, engine, config
            )
        from nislam_tpu.core.slam import unpack_step_output

        if nisf_path is not None:
            # Zero-copy mmap frame views (no per-frame image decode) —
            # step-mode latency then measures the engine, not PNG I/O.
            from nislam_tpu.io.native_loader import NativeChunkReader

            reader = NativeChunkReader(nisf_path, chunk=1, threads=1, ring=2)
            n = min(n, len(reader))
            times_nisf = reader.timestamps()
            print(f"native loader: {nisf_path} ({len(reader)} frames)")

            def get_frame(i):
                return reader.frame(i), float(times_nisf[i])

        else:
            get_frame = dataset.get_raw  # u8 when 8-bit: 4× fewer upload bytes

        step_ran_flags = []
        for i in range(n):
            img, ts = get_frame(i)
            all_times.append(ts)
            t1 = time.time()
            # Packed single-vector output: ONE small device→host readback
            # per frame instead of one per StepOutput field.
            state, packed = engine.step_packed(state, jnp.asarray(img))
            if deferred:
                state, ran_mid = engine.optimize(state)
                step_ran_flags.append(ran_mid)  # device scalar; sum after
            out = unpack_step_output(packed)  # fence
            t2 = time.time()
            print(f"{i}: processing for one frame is {1e3 * (t2 - t1):.2f}ms")
            outs_list.append(out)
            if out.inserted:
                print("Insert a keyframe !")
            if snap is not None and (i + 1) % args.snapshot_every == 0:
                snap.emit(state, outs_list, i + 1)
        outs = jax.tree.map(lambda *xs: np.stack(xs), *outs_list)
        mid_run_solves += int(sum(int(np.asarray(r)) for r in step_ran_flags))
    else:
        # One shared streaming driver (core.slam.streamed_deferred_drive):
        # full chunks + masked tail share at most two compiled programs
        # (no tail retrace), chunk i+1's read + host→device transfer
        # overlap chunk i's scan, and the per-chunk optimize trigger runs
        # at the same cadence as the array driver the engines use.
        from nislam_tpu.core.slam import streamed_deferred_drive

        if nisf_path is not None:
            from nislam_tpu.io.native_loader import NativeChunkReader

            reader = NativeChunkReader(nisf_path, args.chunk)
            n = min(n, len(reader))
            print(f"native loader: {nisf_path} ({len(reader)} frames)")
            chunk_iter = iter(reader)
        else:
            # raw=True ships uint8 when the source is 8-bit (4× fewer
            # host→device bytes; the engine normalizes /255 on device).
            chunk_iter = dataset.chunks(args.chunk, raw=True)
        state, outs, times_arr, ran_flags = streamed_deferred_drive(
            engine, state, chunk_iter,
            chunk_frames=args.chunk, max_frames=n,
            between_chunk_optimize=deferred,
        )
        all_times = times_arr.tolist()
        mid_run_solves = int(sum(int(np.asarray(r)) for r in ran_flags))
    state, ran = engine.finalize(state)
    prof_ctx.__exit__(None, None, None)
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    elapsed = time.time() - t_start
    fps = n / elapsed
    n_kf = int(state.bank.count)
    print(
        f"{n} frames in {elapsed:.2f}s = {fps:.1f} frames/s | "
        f"tracked {int(outs.tracked.sum())} | "
        f"keyframes {n_kf} | edges {int(state.edges.count)} | "
        f"loops {int(outs.loop_found.sum())} | "
        f"optimized {int(outs.optimized.sum()) + mid_run_solves + int(ran)}x"
    )
    print(f"mid-run pose-graph solves: {mid_run_solves + int(outs.optimized.sum())}")
    edge_ovf = int(state.edges.overflow)
    bank_ovf = int(state.bank.overflow)
    if edge_ovf:
        print(
            f"WARNING: edge store overran capacity {int(state.edges.capacity)} "
            f"({edge_ovf} forced replacements/drops — oldest odometry edges "
            f"were sacrificed; raise map.edge_capacity)"
        )
    if bank_ovf and config.map.eviction == "drop":
        print(
            f"WARNING: keyframe bank dropped {bank_ovf} keyframes at capacity "
            f"{state.bank.capacity} (eviction=drop; raise map.keyframe_capacity)"
        )
    # One budget meaning across engines (LoopClosureConfig.max_candidates):
    # the sharded search derives its per-shard cap from the same global
    # budget (ceil(mc/n_shards) each), so this comparison is valid for any
    # engine — at worst conservative by n_shards−1 rounded-up slots.
    max_elig = int(outs.loop_eligible.max()) if len(outs.loop_eligible) else 0
    cand_cap = config.loop_closure.max_candidates
    if max_elig > cand_cap:
        n_trunc = int((outs.loop_eligible > cand_cap).sum())
        print(
            f"WARNING: loop search truncated on {n_trunc} frames — up to "
            f"{max_elig} eligible candidates vs max_candidates {cand_cap} "
            f"(the reference evaluates all eligible frames, loop_closure.cc:"
            f"42-66; prior-proximity priority applied — raise "
            f"loop_closure.max_candidates for exhaustive parity)"
        )

    # --- trajectory dumps (main.cpp:88-98) -------------------------------
    saving_root = args.saving_root or config.saving.saving_root
    os.makedirs(saving_root, exist_ok=True)
    times_arr = np.asarray(all_times)
    kf_idx = np.where(outs.keyframe_slot >= 0)[0]
    kf_slots = outs.keyframe_slot[kf_idx]
    kcc_path = os.path.join(saving_root, "KCC_Keyframe.txt")
    # KCC path: raw odometry at each inserted keyframe (main.cpp:76-78).
    write_tum(kcc_path, times_arr[kf_idx], outs.cf_pose[kf_idx])
    opt_path = os.path.join(saving_root, "optimized_keyframe.txt")
    bank_poses = np.asarray(state.bank.poses)
    write_tum(opt_path, times_arr[kf_idx], bank_poses[kf_slots])
    print(f"saved {kcc_path}, {opt_path}")

    if args.save_state:
        save_state(args.save_state, state)
        print(f"saved state checkpoint to {args.save_state}")

    if args.groundtruth:
        gt_times, gt_poses = read_tum(args.groundtruth)
        ate = ate_rmse(times_arr[kf_idx], bank_poses[kf_slots][:, :2], gt_times, gt_poses[:, :2])
        print(f"ATE RMSE (optimized keyframes): {ate:.4f} m")

    if args.plot:
        from nislam_tpu.io.visualization import save_trajectory_plot

        gt_xy = None
        if args.groundtruth:
            gt_xy = read_tum(args.groundtruth)[1][:, :2]
        p = save_trajectory_plot(
            os.path.join(saving_root, "trajectory.png"),
            outs.cf_pose[kf_idx][:, :2],
            bank_poses[kf_slots][:, :2],
            gt_xy,
        )
        print(f"saved {p}")

    if args.stitch and config.map_stitcher.stitch_map:
        from nislam_tpu.core.stitcher import make_canvas, occupancy_grid, recompute
        from nislam_tpu.io.visualization import save_occupancy_png

        canvas = recompute(make_canvas(config.map_stitcher), state.bank, engine.camera)
        p = save_occupancy_png(
            os.path.join(saving_root, "occupancy.png"),
            np.asarray(occupancy_grid(canvas)),
        )
        print(f"saved {p}")
    return 0


def cmd_synth(args: argparse.Namespace) -> int:
    """Generate a synthetic ground-texture dataset in the reference layout
    (/root/reference/README.md:142-153): rgb/ PNGs + image_names.txt +
    times.txt, plus groundtruth.txt (TUM) and a ready-to-run config YAML."""
    from nislam_tpu.io.synth_dataset import generate_synthetic_dataset

    cfg_path = generate_synthetic_dataset(
        args.out,
        n_frames=args.frames,
        height=args.height,
        width=args.width,
        seed=args.seed,
        path_kind=args.path,
        noise=args.noise,
    )
    print(f"wrote synthetic dataset to {args.out}; config: {cfg_path}")
    return 0


def cmd_pack(args: argparse.Namespace) -> int:
    from nislam_tpu.io.dataset import open_dataset

    ds = open_dataset(args.dataroot, args.image_dir)
    out = ds.pack(args.out)
    print(f"packed {len(ds)} frames to {out}")
    return 0


def cmd_eval(args: argparse.Namespace) -> int:
    """BASELINE-style evaluation through the models layer: one JSON line
    of frames/s + ATE + tracking stats (configs 1-2 = vo, config 3 = slam)."""
    import json

    import jax
    import numpy as np

    from nislam_tpu.core.config import load_config
    from nislam_tpu.io.dataset import open_dataset
    from nislam_tpu.io.trajectory import read_tum
    from nislam_tpu.models import FullSlam, VisualOdometry

    config = load_config(args.config)
    dataroot = args.dataroot or config.dataset.dataroot
    dataset = open_dataset(dataroot, config.dataset.image_dir_name or "rgb")
    n = len(dataset)
    if args.max_frames:
        n = min(n, args.max_frames)
    # Prefer the packed NISF file (native mmap reader, no image decode;
    # u8 frames transfer 4× cheaper and normalize on device).
    images = None
    nisf = os.path.join(dataroot, "frames.nisf")
    if os.path.exists(nisf):
        from nislam_tpu.io.native_loader import NativeChunkReader

        if NativeChunkReader.available():
            r = NativeChunkReader(nisf, chunk=max(64, n))
            pairs = list(iter(r))
            images = np.concatenate([p[0] for p in pairs])[:n]
            times = np.concatenate([p[1] for p in pairs])[:n]
            r.close()
    if images is None:
        chunks_l, times_l = [], []
        for chunk, ts in dataset.chunks(64, raw=True):
            chunks_l.append(chunk)
            times_l.extend(ts.tolist())
            if sum(len(c) for c in chunks_l) >= n:
                break
        images = np.concatenate(chunks_l)[:n]
        times = np.asarray(times_l[:n])
    gt_xy, gt_t = None, None
    if args.groundtruth:
        gt_t, gt_xy = read_tum(args.groundtruth)

    model = (
        VisualOdometry(config) if args.model == "vo" else FullSlam(config)
    )
    # Warm-up with a FULL identical run so the timed pass hits every
    # compiled program (chunked + masked-tail + inline variants alike) —
    # a partially-warm run reports compile time, not steady-state
    # throughput.
    _ = model.evaluate(images, times=times, chunk_frames=args.chunk)
    res = model.evaluate(images, times=times, gt_xy=gt_xy, gt_times=gt_t,
                         chunk_frames=args.chunk)
    dev = jax.devices()[0]
    rec = {
        "model": args.model,
        "frames": res.frames,
        "fps": round(res.fps, 1),
        "ate_rmse_m": None if res.ate_rmse_m is None else round(res.ate_rmse_m, 4),
        "tracked_frac": round(res.tracked_frac, 3),
        "keyframes": res.keyframes,
        "device": f"{dev.platform}:{dev.device_kind}",
    }
    if args.model == "slam":
        rec["loops"] = res.loops
        rec["solves"] = res.solves
    print(json.dumps(rec))
    return 0


def cmd_calibrate(args: argparse.Namespace) -> int:
    """Per-deployment threshold anchoring (VERDICT r4 #8): PSR anchors
    measured on the dataset's own texture rescale the derived thresholds;
    prints a ready-to-paste YAML snippet + margin diagnostics."""
    from nislam_tpu.core.calibrate import calibrate_thresholds
    from nislam_tpu.core.config import load_config
    from nislam_tpu.io.dataset import open_dataset

    config = load_config(args.config)
    dataroot = args.dataroot or config.dataset.dataroot
    dataset = open_dataset(dataroot, config.dataset.image_dir_name or "rgb")
    k = min(args.frames, len(dataset))
    probe = np.stack([dataset.get_raw(i)[0] for i in range(k)])
    thr, diag = calibrate_thresholds(config, probe)
    print(f"# calibrated on {k} frames of {dataroot}")
    print(
        f"# texture ratio vs gaussian anchor: translation "
        f"{diag['texture_ratio_translation']}, rotation "
        f"{diag['texture_ratio_rotation']}"
    )
    print(
        f"# margins: tracking q10/gate {diag['margin_tracking']}x, "
        f"rotation {diag['margin_rotation']}x; loop separation "
        f"pos {diag['separation_position']}x angle {diag['separation_angle']}x"
    )
    if diag["margin_tracking"] < 1.2 or diag["margin_rotation"] < 1.2:
        print(
            "# WARNING: thin matched-PSR margin — this texture tracks "
            "marginally at these sizes (cf. the powerlaw cliff, "
            "docs/TEXTURES_r4.md)"
        )
    if diag.get("data_nomatch_suspect"):
        print(
            "# WARNING: the 'no-match' probe frames still correlate like "
            "matches — the camera moved less than a frame-width over the "
            "probe window, so the separation diagnostics above are not "
            "meaningful (thresholds themselves remain valid); probe more "
            "frames (--frames) or a faster-moving segment"
        )
    print("keyframe_selection:")
    for kk in (
        "lower_response_thr", "upper_response_thr",
        "lower_rotation_response_thr", "upper_rotation_response_thr",
    ):
        print(f"  {kk}: {thr[kk]}")
    print("loop_closure:")
    for kk in ("position_response_thr", "angle_response_thr"):
        print(f"  {kk}: {thr[kk]}")
    return 0


def main(argv=None) -> int:
    from nislam_tpu.utils.compile_cache import enable_compile_cache

    # The scan programs are large; cache hits make repeat runs start fast.
    enable_compile_cache()
    parser = argparse.ArgumentParser(prog="nislam_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)
    run_p = sub.add_parser("run", help="run SLAM over a dataset (main.cpp parity)")
    _add_run_args(run_p)
    pack_p = sub.add_parser("pack", help="pack a dataset for the native loader")
    pack_p.add_argument("--dataroot", required=True)
    pack_p.add_argument("--image-dir", default="rgb")
    pack_p.add_argument("--out", required=True)
    synth_p = sub.add_parser("synth", help="generate a synthetic dataset + config")
    synth_p.add_argument("--out", required=True)
    synth_p.add_argument("--frames", type=int, default=200)
    synth_p.add_argument("--height", type=int, default=480)
    synth_p.add_argument("--width", type=int, default=640)
    synth_p.add_argument("--seed", type=int, default=42)
    synth_p.add_argument(
        "--path", choices=["square", "loop", "straight"], default="square",
        help="square: integer-pixel steps (exact recovery); loop: rounded "
        "square with tangent heading (360 deg of yaw); straight",
    )
    synth_p.add_argument(
        "--noise", action="store_true",
        help="add sensor noise + illumination drift to the rendered frames",
    )
    cal_p = sub.add_parser(
        "calibrate",
        help="measure PSR anchors on the dataset's first K frames and "
        "print texture-rescaled thresholds as a YAML snippet",
    )
    cal_p.add_argument("--config", required=True)
    cal_p.add_argument("--dataroot", default=None)
    cal_p.add_argument("--frames", type=int, default=32)
    eval_p = sub.add_parser(
        "eval", help="BASELINE-style model evaluation (fps + ATE JSON line)"
    )
    eval_p.add_argument("--config", required=True)
    eval_p.add_argument("--dataroot", default=None)
    eval_p.add_argument("--model", choices=["vo", "slam"], default="slam")
    eval_p.add_argument("--groundtruth", default=None)
    eval_p.add_argument("--max-frames", type=int, default=0)
    eval_p.add_argument("--chunk", type=int, default=64)
    args = parser.parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "pack":
        return cmd_pack(args)
    if args.cmd == "synth":
        return cmd_synth(args)
    if args.cmd == "eval":
        return cmd_eval(args)
    if args.cmd == "calibrate":
        return cmd_calibrate(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
