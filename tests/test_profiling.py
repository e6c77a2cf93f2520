"""Profiling utilities (SURVEY §5: the one aux subsystem without tests)."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from nislam_tpu.utils.profiling import StageTimer, device_fence, trace


class _FakeClock:
    """Deterministic clock: ``advance`` moves time, nothing sleeps."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def test_stage_timer_accumulates_and_summarizes():
    clock = _FakeClock()
    t = StageTimer(clock=clock)
    for _ in range(3):
        with t.stage("fast"):
            clock.advance(0.002)
    with t.stage("slow"):
        clock.advance(0.01)
    assert t.count["fast"] == 3 and t.count["slow"] == 1
    assert t.total["fast"] == pytest.approx(3 * 0.002)
    assert t.mean_ms("slow") == pytest.approx(10.0)
    s = t.summary()
    # Sorted by total descending; both stages present with counts.
    assert s.index("slow") < s.index("fast")
    assert "x3" in s and "x1" in s
    assert t.mean_ms("never") == 0.0  # unseen stage: no div-by-zero


def test_stage_timer_fence_includes_device_work():
    t = StageTimer()
    x = jnp.ones((256, 256))
    with t.stage("matmul", fence=x @ x):
        pass
    assert t.count["matmul"] == 1
    assert t.total["matmul"] > 0.0


def test_device_fence_returns_after_computation():
    y = jnp.arange(16.0) * 2.0
    device_fence(y)  # must not raise, must accept any pytree
    device_fence({"a": y, "b": jnp.zeros(3)})


def test_trace_writes_profile_dir(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d):
        np.asarray(jnp.ones((64, 64)) @ jnp.ones((64, 64)))
    # jax.profiler writes plugins/profile/<run>/... under the log dir.
    found = []
    for root, _dirs, files in os.walk(d):
        found.extend(files)
    assert found, "profiler trace produced no files"
