"""Peak/argmax/PSR reduction (ops.registration.peak_stats) against numpy
oracles, including the reference's column-major first-max tie-break."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nislam_tpu.ops.registration import peak_stats, psr, psr_from_stats


def _np_peak_stats(g):
    """Oracle: argmax over the column-major flattening (Eigen maxCoeff
    order), reported as a row-major flat index."""
    g = np.asarray(g, np.float64)
    h, w = g.shape[-2:]
    lead = g.shape[:-2]
    cm = np.swapaxes(g, -2, -1).reshape(*lead, h * w)
    icm = cm.argmax(-1)
    idx = (icm % h) * w + icm // h
    flat = g.reshape(*lead, h * w)
    return flat.max(-1), idx, flat.sum(-1), (flat * flat).sum(-1)


def test_peak_stats_matches_oracle(rng):
    g = jnp.asarray(rng.standard_normal((3, 24, 32)).astype(np.float32))
    peak, idx, s, ss = peak_stats(g)
    gn = np.asarray(g)
    flat = gn.reshape(3, -1)
    np.testing.assert_allclose(np.asarray(peak), flat.max(-1), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(idx), flat.argmax(-1))
    np.testing.assert_allclose(np.asarray(s), flat.sum(-1), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(ss), (flat * flat).sum(-1), rtol=1e-4)


def test_first_max_tiebreak(rng):
    """Column-major first-max wins on ties (Eigen maxCoeff traversal order,
    /root/reference/src/correlation_flow.cc:160-165): (5, 1) precedes (2, 3)
    when scanning down columns — eagerly and under jit."""
    g = np.zeros((8, 8), np.float32)
    g[2, 3] = 5.0  # column-major linear index 3*8+2 = 26
    g[5, 1] = 5.0  # column-major linear index 1*8+5 = 13 → first
    _, idx, _, _ = peak_stats(jnp.asarray(g))
    assert int(idx) == 5 * 8 + 1
    _, idx2, _, _ = jax.jit(peak_stats)(jnp.asarray(g))
    assert int(idx2) == 5 * 8 + 1


def test_psr_from_stats_matches_reference_psr(rng):
    g = jnp.asarray(rng.random((16, 20)).astype(np.float32))
    peak, idx, s, ss = peak_stats(g)
    got = psr_from_stats(peak, s, ss, 16 * 20)
    want = psr(g, peak)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


class TestBlockedPeakStats:
    """Batched responses, including sizes that are not powers of two."""

    @pytest.mark.parametrize("h,w,bh", [(32, 128, 8), (20, 128, 8), (24, 256, 24)])
    def test_matches_jnp_path(self, rng, h, w, bh):
        """A (bh, h, w) batch equals the numpy oracle: peak and index
        exactly, moments to float32 summation order."""
        g = rng.standard_normal((bh, h, w)).astype(np.float32)
        peak, idx, s, ss = jax.jit(peak_stats)(jnp.asarray(g))
        wpeak, widx, ws, wss = _np_peak_stats(g)
        np.testing.assert_array_equal(np.asarray(peak), wpeak.astype(np.float32))
        np.testing.assert_array_equal(np.asarray(idx), widx)
        np.testing.assert_allclose(np.asarray(s), ws, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(np.asarray(ss), wss, rtol=1e-5)

    def test_tiebreak_across_blocks(self, rng):
        """Equal maxima far apart in row order: (17, 0) has column-major
        index 0*24+17 = 17 < (5, 1)'s 1*24+5 = 29, so the LATER row wins."""
        h, w = 24, 128
        g = np.zeros((h, w), np.float32)
        g[5, 1] = 7.0
        g[17, 0] = 7.0
        peak, idx, s, ss = peak_stats(jnp.asarray(g))
        assert int(idx) == 17 * w + 0
        assert int(idx) == int(_np_peak_stats(g)[1])

    def test_single_batch_and_3d(self, rng):
        g = rng.standard_normal((16, 128)).astype(np.float32)
        peak, idx, s, ss = peak_stats(jnp.asarray(g))
        gn = g.ravel()
        assert float(peak) == pytest.approx(gn.max())
        assert int(idx) == int(gn.argmax())
        g3 = rng.standard_normal((2, 3, 16, 128)).astype(np.float32)
        peak3, idx3, _, _ = peak_stats(jnp.asarray(g3))
        assert peak3.shape == idx3.shape == (2, 3)
        np.testing.assert_array_equal(np.asarray(idx3), _np_peak_stats(g3)[1])
