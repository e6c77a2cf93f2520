"""Smoke test of the SLAM main path on one NVIDIA GPU.

Runs, in one process, every phase below and exits non-zero if any fails:

- **flagship**: a seeded synthetic rotating loop at the NTU configuration
  (640×480 image, 720×480 polar grid, 2048-slot bank, 16 loop candidates —
  ``configs/config_ntu.yaml``) written as a NISF pack with its names file,
  ground truth and config, then driven through ``nislam_tpu.cli.main``:
  ``run`` in scan mode with ``--groundtruth``, then ``--mode step``;
- **parity**: the first frames of the same sequence through
  ``make_engine`` on the GPU and on the CPU backend of the same process,
  which must take the same per-frame decisions;
- **kernels**: ``rfft2``/``irfft2`` and ``peak_stats`` on the GPU against
  numpy at the widths the engine uses;
- **hd**: the ``configs/config_HD.yaml`` configuration (1600×1200,
  ``coarse_scale`` 4, bf16 bank) compiled and run with a loop search.

``--four`` runs only the paths that span cards — the sharded-bank
``DistributedSlamEngine`` and the one-lane-per-card ``FleetSlamEngine`` —
against the single-card engine on the same frames.

The card's name and power limit are printed before the last line, which is
one JSON object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
Without a GPU the script exits non-zero and prints no result.

Usage: python chip_smoke.py [--four] [--seed N]
"""

from __future__ import annotations

import os

# The parity phase compares against the CPU backend of this process.
_plats = os.environ.get("JAX_PLATFORMS")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402


@dataclasses.dataclass(frozen=True)
class Sizes:
    """One smoke workload: image/polar/bank sizes, motion, and the checks
    its run must pass."""

    h: int
    w: int
    rd: int
    rc: int
    frames: int
    kf_cap: int
    edge_cap: int
    max_cand: int
    step_px: float
    world_n: int
    frame_gap: int = 30
    coarse_scale: int = 1
    cand_per_shard: int = 0  # 0: the sharded search splits max_cand
    cache_filters: bool = True
    store_images: bool = True
    min_tracked: float = 0.99
    max_ate: float = 0.02
    min_loops: int = 1
    min_solves: int = 1

    @property
    def px(self) -> float:
        """Metric size of one pixel (camera 1 m above ground, fx = W)."""
        return 1.0 / self.w


# configs/config_ntu.yaml sizes; motion and gates as bench.py derives them.
FLAGSHIP = Sizes(h=480, w=640, rd=720, rc=480, frames=512, kf_cap=2048,
                 edge_cap=8192, max_cand=16, step_px=8.0, world_n=4096)
# configs/config_HD.yaml: coarse ranking, filters not cached, no images.
HD = Sizes(h=1200, w=1600, rd=720, rc=480, frames=48, kf_cap=1024,
           edge_cap=4096, max_cand=8, step_px=16.0, world_n=4096,
           frame_gap=20, coarse_scale=4, cache_filters=False,
           store_images=False, min_tracked=0.9, max_ate=float("inf"),
           min_loops=0, min_solves=0)
PARITY_FRAMES = 64
FOUR_FRAMES = 128
FOUR_CANDIDATES = 64
# Widths the engine transforms and reduces: image, half-polar grid, HD image.
FFT_SHAPES = ((480, 640), (360, 480), (1200, 1600))
# One response, a 16-frame batch, the flagship loop batch (16 candidates ×
# 2 hypotheses) and an HD batch.
PEAK_SHAPES = ((480, 640), (16, 480, 640), (16, 2, 480, 640), (16, 1200, 1600))
# Relative L2 error allowed for a float32 FFT against float64 numpy: the
# rounding error of an FFT grows as eps·O(log N) ≈ 1e-6 here; 10× margin.
FFT_RTOL = 1e-5
# Sums of a response: each GPU thread adds a few hundred terms in float32
# before the tree combine, so the worst case is ~300·eps of Σ|g|.
SUM_RTOL = 1e-4
# Per-frame poses may differ only by float32 rounding: every pose is a
# composition of integer-pixel shifts and polar-bin angles, which GPU and
# CPU FFTs find equal when their decisions are equal.
POSE_ATOL = 1e-4


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def peak_memory(device) -> str:
    stats = device.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "not reported" if peak is None else f"{peak / 2**30:.2f} GiB"


def render_loop(sz: Sizes, seed: int, n: int | None = None):
    """(uint8 frames (n, H, W), ground truth (n, 3) metres/rad) of a seeded
    rotating loop that revisits its start (utils.synthetic)."""
    from nislam_tpu.utils.synthetic import (
        add_sensor_noise,
        heading_loop_path,
        make_world,
        render_sequence,
    )

    n = n or sz.frames
    c = sz.world_n / 2.0
    world = make_world(sz.world_n, 3.0, seed=seed)
    poses = heading_loop_path(n, step=sz.step_px, start=(c, c))
    frames = add_sensor_noise(render_sequence(world, sz.h, sz.w, poses), seed=seed + 1)
    u8 = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    gt = np.array([((x - c) * sz.px, (y - c) * sz.px, th) for x, y, th in poses])
    return u8, gt


def write_config(sz: Sizes, root: str) -> str:
    """Camera and main YAML for ``sz`` under ``root``; returns the config path."""
    from nislam_tpu.core.config import derive_response_thresholds

    cam = os.path.join(root, "camera.yaml")
    with open(cam, "w") as f:
        f.write(
            f"image_size: [{sz.w}, {sz.h}]\nheight: 1.0\naccurate_height: true\n"
            f"intrinsics:\n  data: [{float(sz.w)}, {sz.w / 2.0}, {float(sz.w)}, {sz.h / 2.0}]\n"
            "distortion:\n  data: [0.0, 0.0, 0.0, 0.0, 0.0]\n"
            "extrinsics:\n  data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]\n"
        )
    thr = derive_response_thresholds(sz.w, sz.h, sz.rd, sz.rc)
    b = lambda v: "true" if v else "false"  # noqa: E731
    path = os.path.join(root, "config.yaml")
    with open(path, "w") as f:
        f.write(f"""dataset:
  dataroot: {root}
  image_dir_name: rgb
  camera_config: {cam}
correlation_flow:
  width: {sz.w}
  height: {sz.h}
  rotation_divisor: {sz.rd}
  rotation_channel: {sz.rc}
keyframe_selection:
  max_distance: {10.0 * sz.step_px * sz.px!r}
  max_angle: 0.05236
  lower_response_thr: {thr['lower_response_thr']}
  upper_response_thr: {thr['upper_response_thr']}
  lower_rotation_response_thr: {thr['lower_rotation_response_thr']}
  upper_rotation_response_thr: {thr['upper_rotation_response_thr']}
map:
  grid_scale: {0.3 * sz.h * sz.px!r}
  keyframe_capacity: {sz.kf_cap}
  edge_capacity: {sz.edge_cap}
  store_images: {b(sz.store_images)}
  cache_filters: {b(sz.cache_filters)}
  bank_dtype: bf16
loop_closure:
  to_find_loop: true
  position_response_thr: {thr['position_response_thr']}
  angle_response_thr: {thr['angle_response_thr']}
  frame_gap_thr: {sz.frame_gap}
  distance_thr: {16.0 * sz.step_px * sz.px!r}
  max_candidates: {sz.max_cand}
  max_candidates_per_shard: {sz.cand_per_shard}
  coarse_scale: {sz.coarse_scale}
saving:
  saving_root: {os.path.join(root, 'saving')}
""")
    return path


def write_dataset(root: str, frames_u8: np.ndarray, gt: np.ndarray,
                  rate_hz: float = 30.0) -> None:
    """Reference layout without image files: the names file, times and
    ground truth, plus the frames as one NISF pack (numpy only)."""
    from nislam_tpu.io.dataset import SyntheticDataset
    from nislam_tpu.io.trajectory import write_tum

    n = len(frames_u8)
    times = np.arange(n) / rate_hz
    with open(os.path.join(root, "image_names.txt"), "w") as f:
        f.write("".join(f"{i:06d}.png\n" for i in range(n)))
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("".join(f"{t:.6f}\n" for t in times))
    write_tum(os.path.join(root, "groundtruth.txt"), times, gt)
    SyntheticDataset(frames_u8, rate_hz=rate_hz).pack(os.path.join(root, "frames.nisf"))


def run_cli(argv) -> str:
    """``nislam_tpu.cli.main(argv)`` with its stdout captured (and echoed)."""
    from nislam_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    sys.stdout.write(out)
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}")
    return out


def _grab(pattern: str, text: str) -> float:
    m = re.search(pattern, text)
    if m is None:
        raise RuntimeError(f"CLI output lacks {pattern!r}")
    return float(m.group(1))


def flagship_phase(sz: Sizes, root: str, seed: int) -> dict:
    """Dataset + config on disk, CLI scan run with ATE, then step mode."""
    import jax

    t0 = time.time()
    frames, gt = render_loop(sz, seed)
    write_dataset(root, frames, gt)
    cfg = write_config(sz, root)
    log("flagship", f"{len(frames)} frames {sz.h}x{sz.w} written in {time.time() - t0:.1f}s")
    out = run_cli(["run", "--config", cfg, "--groundtruth",
                   os.path.join(root, "groundtruth.txt")])
    stats = {
        "frames": int(_grab(r"(\d+) frames in", out)),
        "tracked": int(_grab(r"tracked (\d+)", out)),
        "keyframes": int(_grab(r"keyframes (\d+)", out)),
        "loops": int(_grab(r"loops (\d+)", out)),
        "solves": int(_grab(r"optimized (\d+)x", out)),
        "ate_m": _grab(r"ATE RMSE \(optimized keyframes\): ([0-9.eE+-]+|nan) m", out),
    }
    stats["tracked_frac"] = stats["tracked"] / stats["frames"]
    log("flagship", f"scan: {stats} | peak device memory "
        f"{peak_memory(jax.devices()[0])}")
    checks = {
        "frames": stats["frames"] == sz.frames,
        "tracked_frac": stats["tracked_frac"] >= sz.min_tracked,
        "loops": stats["loops"] >= sz.min_loops,
        "solves": stats["solves"] >= sz.min_solves,
        "ate_m": stats["ate_m"] < sz.max_ate,
    }
    n_step = min(16, sz.frames)
    out = run_cli(["run", "--config", cfg, "--mode", "step",
                   "--max-frames", str(n_step)])
    stats["step_frames"] = out.count("processing for one frame")
    checks["step_frames"] = stats["step_frames"] == n_step
    log("flagship", f"step mode: {stats['step_frames']} frames")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"flagship checks failed: {failed} ({stats})")
    stats["config"] = cfg
    return stats


def _run_engine(config, frames, device):
    """The engine's chunked driver over ``frames`` with every array on
    ``device``; numpy outputs."""
    import jax

    from nislam_tpu.core.slam import make_engine

    with jax.default_device(device):
        eng = make_engine(config)
        state, outs = eng.run_sequence(eng.init_state(), frames,
                                       chunk_frames=len(frames))
        state, _ = eng.finalize(state)
    return outs


DECISIONS = ("tracked", "inserted", "loop_found", "keyframe_slot")


def compare_runs(a, b, atol: float, what: str) -> float:
    """Require equal per-frame decisions and poses within ``atol``;
    returns the largest pose difference."""
    for field in DECISIONS:
        x, y = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        if not np.array_equal(x, y):
            bad = np.flatnonzero(x != y)[:8]
            raise AssertionError(f"{what}: {field} differs at frames {bad.tolist()}")
    dpose = float(np.max(np.abs(np.asarray(a.pose) - np.asarray(b.pose))))
    if not dpose <= atol:
        raise AssertionError(f"{what}: pose differs by {dpose} > {atol}")
    return dpose


def parity_phase(config_path: str, n: int) -> dict:
    """First ``n`` frames of the flagship pack on the default device and
    on the CPU backend: decisions equal, poses within POSE_ATOL."""
    import jax

    from nislam_tpu.core.config import load_config
    from nislam_tpu.io.dataset import NisfDataset

    config = load_config(config_path)
    ds = NisfDataset(os.path.join(config.dataset.dataroot, "frames.nisf"))
    frames = np.asarray(ds.frames[:n])
    dev = jax.devices()[0]
    ref = _run_engine(config, frames, jax.devices("cpu")[0])
    got = _run_engine(config, frames, dev)
    dpose = compare_runs(got, ref, POSE_ATOL, f"{dev.platform} vs cpu")
    stats = {
        "frames": n,
        "inserted": int(np.sum(got.inserted)),
        "tracked": int(np.sum(got.tracked)),
        "max_pose_diff": dpose,
    }
    log("parity", f"{dev.platform} vs cpu decisions equal over {n} frames; {stats}")
    return stats


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def kernel_phase(fft_shapes, peak_shapes, seed: int) -> dict:
    """Each transform and reduction of the hot path, compiled for the
    default device, against numpy in float64."""
    import jax

    from nislam_tpu.ops.fft import irfft2, rfft2
    from nislam_tpu.ops.registration import peak_stats

    rng = np.random.default_rng(seed)
    res = {}
    fwd = jax.jit(rfft2)
    for h, w in fft_shapes:
        x = rng.standard_normal((h, w)).astype(np.float32)
        spec = np.fft.rfft2(x.astype(np.float64))
        e_fwd = _rel_l2(np.asarray(fwd(x)), spec)
        back = jax.jit(lambda s, hw=(h, w): irfft2(s, hw))(spec.astype(np.complex64))
        e_inv = _rel_l2(np.asarray(back), x)
        res[f"fft{h}x{w}"] = (e_fwd, e_inv)
        log("kernels", f"rfft2/irfft2 {h}x{w}: rel L2 err {e_fwd:.2e} / {e_inv:.2e} "
            f"(limit {FFT_RTOL:.0e})")
        if not (e_fwd <= FFT_RTOL and e_inv <= FFT_RTOL):
            raise AssertionError(f"FFT {h}x{w} outside tolerance")
    stats = jax.jit(peak_stats)
    for shape in peak_shapes:
        g = rng.standard_normal(shape).astype(np.float32)
        h, w = shape[-2:]
        peak, idx, s, ss = (np.asarray(v) for v in stats(g))
        g64 = g.astype(np.float64)
        flat = g64.reshape(*shape[:-2], h * w)
        icm = np.swapaxes(g64, -2, -1).reshape(*shape[:-2], h * w).argmax(-1)
        ok_peak = np.array_equal(peak, flat.max(-1).astype(np.float32))
        ok_idx = np.array_equal(idx, (icm % h) * w + icm // h)
        e_s = float(np.max(np.abs(s - flat.sum(-1)) / np.abs(flat).sum(-1)))
        e_ss = float(np.max(np.abs(ss - (flat * flat).sum(-1)) / (flat * flat).sum(-1)))
        res[f"peak{shape}"] = (ok_peak, ok_idx, e_s, e_ss)
        log("kernels", f"peak_stats {shape}: peak exact {ok_peak}, argmax exact "
            f"{ok_idx}, sum err {e_s:.2e}, sumsq err {e_ss:.2e} (limit {SUM_RTOL:.0e})")
        if not (ok_peak and ok_idx and e_s <= SUM_RTOL and e_ss <= SUM_RTOL):
            raise AssertionError(f"peak_stats {shape} outside tolerance")
    return res


def hd_phase(sz: Sizes, seed: int) -> dict:
    """HD configuration through make_engine: compile, run, one loop search."""
    import jax

    from nislam_tpu.core.config import load_config

    frames, _ = render_loop(sz, seed)
    with tempfile.TemporaryDirectory() as root:
        config = load_config(write_config(sz, root))
    t0 = time.time()
    outs = _run_engine(config, frames, jax.devices()[0])
    stats = {
        "frames": len(frames),
        "tracked_frac": float(np.mean(outs.tracked)),
        "keyframes": int(np.sum(outs.inserted)),
        "searches": int(np.sum(outs.loop_eligible > 0)),
        "loops": int(np.sum(outs.loop_found)),
        "seconds_incl_compile": round(time.time() - t0, 1),
    }
    log("hd", f"{sz.h}x{sz.w} coarse_scale {sz.coarse_scale}: {stats} | peak "
        f"device memory {peak_memory(jax.devices()[0])}")
    if stats["searches"] < 1 or stats["tracked_frac"] < sz.min_tracked:
        raise AssertionError(f"hd checks failed ({stats})")
    return stats


def four_card_phase(sz: Sizes, seed: int, n_cards: int = 4,
                    n_frames: int = FOUR_FRAMES) -> dict:
    """Sharded-bank and fleet engines over ``n_cards`` devices against the
    single-device engine on the same ``n_frames`` per sequence."""
    import jax
    import jax.numpy as jnp

    from nislam_tpu.core.config import load_config
    from nislam_tpu.parallel.engine import make_distributed_engine
    from nislam_tpu.parallel.fleet import make_fleet_engine
    from nislam_tpu.parallel.mesh import make_mesh

    devs = jax.devices()[:n_cards]
    if len(devs) < n_cards:
        raise RuntimeError(f"--four needs {n_cards} devices, JAX has {len(devs)}")
    # A candidate budget no search exhausts, on every shard: the sharded
    # search then sees every eligible keyframe the single engine sees
    # (checked below), so both must take the same decisions.
    sz = dataclasses.replace(sz, max_cand=FOUR_CANDIDATES,
                             cand_per_shard=FOUR_CANDIDATES)
    with tempfile.TemporaryDirectory() as root:
        config = load_config(write_config(sz, root))
    seqs = np.stack([render_loop(sz, seed + 10 * k, n_frames)[0]
                     for k in range(n_cards)])
    single = [_run_engine(config, seqs[k], devs[0]) for k in range(n_cards)]
    most = max(int(np.max(o.loop_eligible)) for o in single)
    if most > sz.max_cand:
        raise AssertionError(f"single-engine search truncated ({most} eligible)")
    chunk = n_frames // 2

    dist = make_distributed_engine(config, make_mesh({"bank": n_cards}, devices=devs))
    dstate = dist.init_state()
    n_dev = len(dstate.bank.fft.sharding.device_set)
    if n_dev != n_cards:
        raise AssertionError(f"bank spans {n_dev} devices, not {n_cards}")
    dstate, douts = dist.run_sequence(dstate, jnp.asarray(seqs[0]), chunk_frames=chunk)
    dist.finalize(dstate)
    # Dense LM (single) against GN-CG (sharded): equal up to solver tolerance.
    d_dist = compare_runs(douts, single[0], 5e-3, "sharded bank vs single")
    log("four", f"DistributedSlamEngine bank over {n_dev} devices: decisions equal, "
        f"max pose diff {d_dist:.2e}, loops {int(np.sum(douts.loop_found))}")

    fleet = make_fleet_engine(config, make_mesh({"data": n_cards}, devices=devs))
    fstates = fleet.init_states()
    n_dev = len(fstates.bank.fft.sharding.device_set)
    if n_dev != n_cards:
        raise AssertionError(f"fleet lanes span {n_dev} devices, not {n_cards}")
    fstates, fouts = fleet.run_sequences(fstates, jnp.asarray(seqs), chunk_frames=chunk)
    fleet.finalize(fstates)
    d_fleet = max(
        compare_runs(jax.tree.map(lambda x, k=k: x[k], fouts), single[k],
                     POSE_ATOL, f"fleet lane {k} vs single")
        for k in range(n_cards)
    )
    loops = [int(np.sum(o.loop_found)) for o in single]
    log("four", f"FleetSlamEngine {n_cards} lanes on {n_dev} devices: decisions "
        f"equal lane for lane, max pose diff {d_fleet:.2e}, loops per lane {loops}")
    if sum(loops) < 1:
        raise AssertionError("the four-card workload closed no loop")
    return {"dist_pose_diff": d_dist, "fleet_pose_diff": d_fleet, "loops": loops}


def card_info() -> str:
    """``nvidia-smi`` name and power limit, read by a child that stays off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths (needs 4 GPUs)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform} "
              f"({dev.device_kind})", file=sys.stderr)
        return 1
    from nislam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(f"device: {dev.device_kind} x{len(devices)}", flush=True)
    print(f"nvidia-smi: {card_info()}", flush=True)

    if args.four:
        four_card_phase(FLAGSHIP, args.seed)
    else:
        with tempfile.TemporaryDirectory() as root:
            fl = flagship_phase(FLAGSHIP, root, args.seed)
            parity_phase(fl["config"], PARITY_FRAMES)
        kernel_phase(FFT_SHAPES, PEAK_SHAPES, args.seed)
        hd_phase(HD, args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
