"""Rotation-recovery accuracy vs ``rotation_channel`` (VERDICT r3 #3).

The polar channel count is RADIAL resolution only — angle resolution is set
by the divisor (360/divisor °/bin; /root/reference/src/correlation_flow.cc:
103-106) — and the reference's own tuning note says channel 64 "may work
well" (/root/reference/configs/config_geekplus.yaml:10).  This script
measures what that costs: loop-mode (large-rotation, both ambiguity
branches) angle-recovery error and rotation-PSR acceptance margin across a
±180° sweep, at C ∈ {64, 128, 480}, on the flagship 640×480 image.

Usage: python scripts/rotstudy.py [--size H W] [--divisor D] [--out MD]
Writes a markdown table (default docs/ROTSTUDY_r4.md) and prints it.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# Study script: always CPU (an accuracy study, not a timing one).
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

import jax  # noqa: E402

import jax.numpy as jnp  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640), metavar=("H", "W"))
    ap.add_argument("--divisor", type=int, default=720)
    ap.add_argument("--channels", type=int, nargs="+", default=[64, 128, 480])
    ap.add_argument("--angles", type=int, default=49, help="sweep points over ±180°")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 7])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs", "ROTSTUDY_r4.md"))
    args = ap.parse_args()

    from nislam_tpu.core.config import CFConfig, derive_response_thresholds
    from nislam_tpu.ops.registration import (
        compute_intermedium,
        compute_pose,
        make_cf_ops,
    )
    from nislam_tpu.utils.synthetic import make_world, render_frame

    h, w = args.size
    d = args.divisor
    # off-grid angles (avoid exact bin centers — the honest case)
    sweep = np.linspace(-180.0, 180.0, args.angles, endpoint=False) + 0.217

    rows = []
    for c in args.channels:
        cfg = CFConfig(width=w, height=h, rotation_divisor=d, rotation_channel=c)
        ops = make_cf_ops(cfg)
        thr = derive_response_thresholds(w, h, d, c)
        errs, psrs, accepts = [], [], []
        for seed in args.seeds:
            world = make_world(2048, 3.0, seed=seed)
            base = render_frame(world, h, w, 1024.0, 1024.0, 0.0)
            kf_fft, kf_polar = compute_intermedium(jnp.asarray(base), ops)
            fn = jax.jit(
                lambda img, cp: compute_pose(
                    kf_fft, img, kf_polar, cp, ops, large_rotation=True
                )
            )
            for a in sweep:
                cur = render_frame(world, h, w, 1024.0, 1024.0, np.deg2rad(a))
                _, cur_polar = compute_intermedium(jnp.asarray(cur), ops)
                pose, info = fn(jnp.asarray(cur), cur_polar)
                got = np.degrees(float(pose[2]))
                e = abs(got - a) % 360.0
                errs.append(min(e, 360.0 - e))
                psrs.append(float(info[2]))
                accepts.append(float(info[2]) > thr["angle_response_thr"])
        errs = np.asarray(errs)
        bin_deg = 360.0 / d
        rows.append(dict(
            channel=c,
            mean_err=errs.mean(),
            p95_err=float(np.percentile(errs, 95)),
            max_err=errs.max(),
            within_1bin=float((errs <= bin_deg + 1e-6).mean()),
            within_2bin=float((errs <= 2 * bin_deg + 1e-6).mean()),
            median_psr=float(np.median(psrs)),
            thr=thr["angle_response_thr"],
            accept=float(np.mean(accepts)),
        ))
        print(f"C={c}: mean {rows[-1]['mean_err']:.3f}° p95 "
              f"{rows[-1]['p95_err']:.3f}° max {rows[-1]['max_err']:.3f}° "
              f"within1bin {rows[-1]['within_1bin']:.2%} "
              f"psr~{rows[-1]['median_psr']:.1f} (thr {rows[-1]['thr']:.1f}) "
              f"accept {rows[-1]['accept']:.2%}", flush=True)

    lines = [
        "# Rotation-channel study (round 4)",
        "",
        f"Loop-mode (large-rotation) angle recovery at {h}×{w}, divisor {d} "
        f"(bin = {360.0 / d:.3g}°), ±180° off-grid sweep × {len(args.seeds)} "
        f"textures ({args.angles} angles each), half-polar engine.  "
        "`accept` = fraction of sweep frames whose rotation PSR clears the "
        "derived `angle_response_thr` (every frame here is a TRUE revisit, "
        "so accept ≈ loop recall on perfect-position candidates).",
        "",
        "| channel | mean err ° | p95 ° | max ° | ≤1 bin | ≤2 bins | median rot-PSR | thr | accept |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['channel']} | {r['mean_err']:.3f} | {r['p95_err']:.3f} | "
            f"{r['max_err']:.3f} | {r['within_1bin']:.2%} | "
            f"{r['within_2bin']:.2%} | {r['median_psr']:.1f} | "
            f"{r['thr']:.1f} | {r['accept']:.2%} |"
        )
    lines += [
        "",
        "Command: `python scripts/rotstudy.py`.  The channel count is radial "
        "resolution of the polar map; the angle estimate quantizes at the "
        "divisor regardless.  See /root/reference/configs/config_geekplus."
        "yaml:10 for the reference's own channel-64 note.",
    ]
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
