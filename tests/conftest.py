"""Test harness config: run on CPU with 8 virtual devices.

The tests check results on the CPU backend unless ``JAX_PLATFORMS`` says
otherwise; the standard JAX trick for exercising pjit/shard_map
collectives without several cards is to fake 8 host devices (SURVEY.md
§4d).  Must run before jax is imported anywhere.  Tests that need the GPU
carry the ``gpu`` marker and decide inside the ``gpu_device`` fixture, so
every worker collects the same tests; on a GPU machine run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

if not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip(
            "needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/"
        )
