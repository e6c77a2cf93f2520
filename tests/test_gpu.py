"""GPU-only checks (``gpu`` marker): the kernel comparisons of
chip_smoke.py at real widths, and a tiny engine run GPU against CPU.
They skip where JAX has no GPU; run them on a GPU machine with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``."""

import jax
import numpy as np
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


def test_kernels_at_real_widths(gpu_device):
    with jax.default_device(gpu_device):
        cs.kernel_phase(cs.FFT_SHAPES, cs.PEAK_SHAPES, seed=0)


def test_engine_decisions_match_cpu(gpu_device, tmp_path):
    tiny = cs.Sizes(h=120, w=160, rd=180, rc=96, frames=48, kf_cap=64,
                    edge_cap=256, max_cand=8, step_px=3.0, world_n=1024)
    from nislam_tpu.core.config import load_config

    frames, _ = cs.render_loop(tiny, seed=0)
    config = load_config(cs.write_config(tiny, str(tmp_path)))
    got = cs._run_engine(config, frames, gpu_device)
    ref = cs._run_engine(config, frames, jax.devices("cpu")[0])
    assert cs.compare_runs(got, ref, cs.POSE_ATOL, "gpu vs cpu") <= cs.POSE_ATOL
    assert np.asarray(got.tracked).all()
