"""chip_smoke.py's phases at a tiny size on the CPU backend, called
directly, and its refusal to run without a GPU."""

import tempfile

import numpy as np
import pytest

import chip_smoke as cs

TINY = cs.Sizes(h=120, w=160, rd=180, rc=96, frames=128, kf_cap=64,
                edge_cap=256, max_cand=8, step_px=3.0, world_n=1024)
TINY_HD = cs.Sizes(h=120, w=160, rd=180, rc=96, frames=48, kf_cap=32,
                   edge_cap=128, max_cand=4, step_px=4.0, world_n=1024,
                   frame_gap=20, coarse_scale=4, cache_filters=False,
                   store_images=False, min_tracked=0.9, max_ate=float("inf"),
                   min_loops=0, min_solves=0)


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) != 0
    out, err = capsys.readouterr()
    assert "needs a GPU" in err
    assert '"ok"' not in out


def test_flagship_and_parity_phases_tiny():
    """CLI scan + step runs pass the flagship checks, and the parity phase
    (here CPU against CPU) finds equal decisions."""
    with tempfile.TemporaryDirectory() as root:
        st = cs.flagship_phase(TINY, root, seed=0)
        assert st["frames"] == TINY.frames and st["step_frames"] == 16
        assert st["loops"] >= 1 and st["ate_m"] < 0.02
        par = cs.parity_phase(st["config"], 24)
    assert par["frames"] == 24 and par["max_pose_diff"] == 0.0


def test_kernel_phase_tiny():
    res = cs.kernel_phase(((48, 64), (37, 48)), ((48, 64), (3, 2, 48, 64)), seed=1)
    assert set(res) == {"fft48x64", "fft37x48", "peak(48, 64)", "peak(3, 2, 48, 64)"}
    assert all(e <= cs.FFT_RTOL for k, v in res.items() if k.startswith("fft") for e in v)


def test_hd_phase_tiny():
    st = cs.hd_phase(TINY_HD, seed=0)
    assert st["frames"] == 48 and st["searches"] >= 1


def test_four_card_phase_on_virtual_devices():
    st = cs.four_card_phase(TINY, seed=0, n_frames=64)
    assert st["fleet_pose_diff"] <= cs.POSE_ATOL and len(st["loops"]) == 4


def test_compare_runs_flags_a_changed_decision():
    from nislam_tpu.core.slam import dead_step_output

    a = dead_step_output((5,))
    b = a._replace(inserted=np.asarray(a.inserted).copy())
    b.inserted[3] = True
    assert cs.compare_runs(a, a, 0.0, "same") == 0.0
    with pytest.raises(AssertionError, match="inserted differs at frames \\[3\\]"):
        cs.compare_runs(a, b, 0.0, "changed")
