"""The YAML-subset config reader, compile-cache placement and the numpy
NISF reader."""

import glob
import os

import numpy as np
import pytest

import jax

from nislam_tpu.core import yaml_subset

yaml = pytest.importorskip("yaml")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_matches_pyyaml_on_configs(path):
    with open(path) as f:
        text = f.read()
    assert yaml_subset.load(text) == yaml.safe_load(text)


def test_reader_matches_pyyaml_on_synth_output(tmp_path):
    from nislam_tpu.io.synth_dataset import generate_synthetic_dataset

    pytest.importorskip("cv2")
    cfg = generate_synthetic_dataset(str(tmp_path), n_frames=8, height=48, width=64)
    for p in (cfg, os.path.join(tmp_path, "camera.yaml")):
        with open(p) as f:
            text = f.read()
        assert yaml_subset.load(text) == yaml.safe_load(text)


def test_reader_scalars_lists_comments():
    text = (
        "# header\n"
        "a:\n"
        "  b: 1   # trailing\n"
        "  c: -2.5e+3\n"
        "  c2: 1e-5\n"
        "  d: [1, 2.0, x, 'q # not a comment', \"\"]\n"
        "  e: true\n"
        "  f:\n"
        "  g: ~\n"
        "h: /path/with#hash\n"
        "i: []\n"
    )
    assert yaml_subset.load(text) == yaml.safe_load(text)
    assert yaml_subset.load("") is None


@pytest.mark.parametrize(
    "text",
    ["a:\n  - 1\n", "a: &x 1\n", "a: !!str 1\n", "a: |\n  x\n", "%YAML 1.1\na: 1\n",
     "a: 1\n b: 2\n", "a: [1, 2\n"],
)
def test_reader_rejects_unsupported_yaml(text):
    with pytest.raises(ValueError):
        yaml_subset.load(text)


def _cache_dir_after(monkeypatch, env):
    from nislam_tpu.utils.compile_cache import enable_compile_cache

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = enable_compile_cache()
        return got, jax.config.jax_compilation_cache_dir, before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    got, configured, _ = _cache_dir_after(monkeypatch, None)
    assert got == configured == os.path.join(REPO, ".jax_cache")


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    got, configured, before = _cache_dir_after(monkeypatch, str(tmp_path))
    assert got == str(tmp_path)
    assert configured == before  # left to JAX, which reads the variable itself


def test_nisf_numpy_reader_roundtrip(tmp_path, rng):
    from nislam_tpu.io.dataset import NisfDataset, SyntheticDataset

    u8 = (rng.random((5, 12, 16)) * 255).astype(np.uint8)
    ds = SyntheticDataset(u8, rate_hz=10.0)
    p = ds.pack(str(tmp_path / "f.nisf"))
    assert os.path.getsize(p) == 20 + 5 * 8 + u8.size  # uint8 → NISF v2
    rd = NisfDataset(p)
    assert len(rd) == 5
    img, t = rd.get_raw(3)
    np.testing.assert_array_equal(img, u8[3])
    assert t == pytest.approx(0.3)
    np.testing.assert_allclose(rd.get(3)[0], u8[3] / 255.0, rtol=1e-6)
    chunks = list(rd.chunks(4, raw=True))
    np.testing.assert_array_equal(np.concatenate([c[0] for c in chunks]), u8)
    f32 = SyntheticDataset(u8.astype(np.float32) / 255.0)
    rd32 = NisfDataset(f32.pack(str(tmp_path / "g.nisf")))
    assert rd32.get_raw(0)[0].dtype == np.float32
