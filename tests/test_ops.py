"""Oracle tests for the spectral/warp/registration primitives (SURVEY §4a-b).

Each op is checked against a NumPy or OpenCV oracle implementing the exact
reference semantics; the registration stack is then validated end-to-end by
recovering known synthetic transforms (build-plan gate #1).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nislam_tpu.core.config import CFConfig
from nislam_tpu.ops import (
    bilinear_sample,
    compute_intermedium,
    compute_pose,
    estimate_trans,
    fftshift2,
    impulse_spectrum,
    irfft2,
    make_cf_ops,
    polar_grid,
    remove_zero_component,
    rfft2,
    rotate_wrap,
    warp_polar,
)
from nislam_tpu.ops.registration import normalize_degree

cv2 = pytest.importorskip("cv2")

H, W = 96, 128
CFG = CFConfig(width=W, height=H, rotation_divisor=180, rotation_channel=96)


def _texture(rng, h=H, w=W):
    """Smooth random texture (filtered noise) — correlates well like ground texture."""
    big = rng.standard_normal((h, w)).astype(np.float32)
    big = cv2.GaussianBlur(big, (0, 0), 2.5)
    big -= big.min()
    big /= big.max()
    return big


# ---------------------------------------------------------------------------
# FFT conventions
# ---------------------------------------------------------------------------


def test_rfft2_roundtrip(rng):
    x = rng.standard_normal((H, W)).astype(np.float32)
    xf = rfft2(jnp.asarray(x))
    assert xf.shape == (H, W // 2 + 1)
    back = irfft2(xf, (H, W))
    np.testing.assert_allclose(np.asarray(back), x, atol=1e-4)


def test_ifft_of_magnitude_matches_full_spectrum_oracle(rng):
    # IFFT(|half spectrum|) must equal ifft2(|full spectrum|) regardless of
    # which axis is halved — the key invariance vs. the reference's layout.
    x = rng.standard_normal((H, W)).astype(np.float32)
    ours = np.asarray(irfft2(jnp.abs(rfft2(jnp.asarray(x))), (H, W)))
    oracle = np.fft.ifft2(np.abs(np.fft.fft2(x))).real
    np.testing.assert_allclose(ours, oracle, atol=1e-4)


def test_impulse_spectrum():
    got = np.asarray(impulse_spectrum(H, W))
    oracle = np.fft.rfft2(np.eye(1, H * W, (H // 2) * W + W // 2).reshape(H, W))
    np.testing.assert_allclose(got, oracle, atol=1e-5)


def test_remove_zero_component(rng):
    x = rng.standard_normal((H, W)).astype(np.float32)
    y = np.asarray(remove_zero_component(jnp.asarray(x)))
    oracle = x.copy()
    oracle[0, :] = (x[1, :] + x[-1, :]) / 2  # row rule from original x
    oracle[:, 0] = (x[:, 1] + x[:, -1]) / 2  # col rule wins at the corner
    np.testing.assert_allclose(y, oracle, atol=1e-6)


# ---------------------------------------------------------------------------
# Warps vs OpenCV
# ---------------------------------------------------------------------------


def test_warp_polar_matches_opencv(rng):
    img = _texture(rng)
    div, ch = CFG.rotation_divisor, CFG.rotation_channel
    gx, gy = polar_grid(H, W, div, ch)
    ours = np.asarray(warp_polar(jnp.asarray(img), jnp.asarray(gx), jnp.asarray(gy)))

    center = (W / 2.0, H / 2.0)
    radius = float(min(H // 2, W // 2))
    oracle = cv2.warpPolar(
        img, (ch, div), center, radius, cv2.INTER_LINEAR + cv2.WARP_FILL_OUTLIERS
    )
    # OpenCV uses 5-bit fixed-point bilinear weights; tolerate that.
    assert np.abs(ours - oracle).mean() < 2e-3
    assert np.abs(ours - oracle).max() < 0.1


def test_polar_resample_matches_literal_chain(rng):
    """The fused tap table == warp_polar(fftshift(remove_zero_component(x)))
    exactly (it is the same linear map, precomposed)."""
    from nislam_tpu.ops.fft import fftshift2
    from nislam_tpu.ops.warp import polar_resample, polar_tap_constants

    img = _texture(rng)
    div, ch = CFG.rotation_divisor, CFG.rotation_channel
    gx, gy = polar_grid(H, W, div, ch)
    want = np.asarray(
        warp_polar(
            fftshift2(remove_zero_component(jnp.asarray(img))),
            jnp.asarray(gx),
            jnp.asarray(gy),
        )
    )
    idx, wgt = polar_tap_constants(H, W, div, ch)
    got = np.asarray(
        polar_resample(jnp.asarray(img), jnp.asarray(idx), jnp.asarray(wgt))
    )
    np.testing.assert_allclose(got, want, atol=1e-5)
    # batched leading axis
    got2 = np.asarray(
        polar_resample(
            jnp.stack([jnp.asarray(img)] * 2), jnp.asarray(idx), jnp.asarray(wgt)
        )
    )
    np.testing.assert_allclose(got2[1], want, atol=1e-5)


def test_rotate_wrap_matches_opencv(rng):
    img = _texture(rng)
    for deg in [0.0, 10.0, -37.5, 90.0, 181.0]:
        ours = np.asarray(rotate_wrap(jnp.asarray(img), deg))
        m = cv2.getRotationMatrix2D((W / 2.0, H / 2.0), deg, 1.0)
        oracle = cv2.warpAffine(img, m, (W, H), flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_WRAP)
        assert np.abs(ours - oracle).mean() < 2e-3, deg


def test_bilinear_sample_batched_grids(rng):
    imgs = np.stack([_texture(rng), _texture(rng)])
    degs = jnp.asarray([15.0, -30.0])
    batched = np.asarray(rotate_wrap(jnp.asarray(imgs), degs))
    for i, d in enumerate([15.0, -30.0]):
        single = np.asarray(rotate_wrap(jnp.asarray(imgs[i]), d))
        np.testing.assert_allclose(batched[i], single, atol=1e-5)


def test_bilinear_sample_zero_border():
    img = jnp.ones((4, 4))
    x = jnp.array([[-1.0, 0.0], [3.5, 4.0]])
    y = jnp.array([[0.0, 0.0], [0.0, 0.0]])
    out = np.asarray(bilinear_sample(img, x, y))
    assert out[0, 0] == 0.0  # fully outside
    assert out[0, 1] == 1.0  # inside
    assert out[1, 0] == 0.5  # straddles the right edge: half weight in range
    assert out[1, 1] == 0.0  # fully outside


# ---------------------------------------------------------------------------
# Registration: synthetic-transform recovery (gate #1)
# ---------------------------------------------------------------------------


def _roll(img, dy, dx):
    return np.roll(np.roll(img, dy, axis=0), dx, axis=1)


@pytest.mark.parametrize("kernel", [0, 1])
def test_estimate_trans_recovers_circular_shift(rng, kernel):
    import dataclasses

    cfg = dataclasses.replace(CFG, kernel=kernel)
    img = _texture(rng)
    zf = rfft2(jnp.asarray(img))
    target = impulse_spectrum(H, W)
    for dy, dx in [(0, 0), (5, -9), (-17, 3), (40, 60)]:
        xf = rfft2(jnp.asarray(_roll(img, dy, dx)))
        trans, conf = estimate_trans(zf, xf, target, (H, W), cfg)
        trans = np.asarray(trans)
        # A +dy/+dx roll moves content down/right; the estimator reports the
        # shift with the reference's sign convention trans = -(peak - center).
        got_dy, got_dx = -trans[0], -trans[1]
        got_dy = (got_dy + H / 2) % H - H / 2
        got_dx = (got_dx + W / 2) % W - W / 2
        assert (got_dy, got_dx) == (pytest.approx(dy), pytest.approx(dx)), (dy, dx)
        assert float(conf) > 10.0


def test_estimate_trans_batched_matches_single(rng):
    img = _texture(rng)
    zf = rfft2(jnp.asarray(img))
    xfs = rfft2(jnp.asarray(np.stack([_roll(img, 3, 4), _roll(img, -7, 1)])))
    target = impulse_spectrum(H, W)
    tb, cb = estimate_trans(jnp.stack([zf, zf]), xfs, target, (H, W), CFG)
    for i in range(2):
        ts, cs = estimate_trans(zf, xfs[i], target, (H, W), CFG)
        np.testing.assert_allclose(np.asarray(tb[i]), np.asarray(ts), atol=1e-5)
        np.testing.assert_allclose(float(cb[i]), float(cs), rtol=1e-4)


def test_normalize_degree():
    d = jnp.array([0.0, 179.0, 180.0, 181.0, 360.0, -180.0, -541.0])
    np.testing.assert_allclose(
        np.asarray(normalize_degree(d)), [0.0, 179.0, -180.0, -179.0, 0.0, -180.0, 179.0]
    )


@pytest.mark.parametrize("angle_deg", [0.0, 8.0, -15.0, 30.0])
def test_compute_pose_recovers_rotation_and_shift(rng, angle_deg):
    """Gate #1: recover a known synthetic (tx, ty, θ) in tracking mode."""
    ops = make_cf_ops(CFG)
    base = _texture(rng)
    # Current frame: base rotated by angle and shifted: registration should
    # report the rotation and the translation of the *de-rotated* image.
    dy, dx = 6, -11
    rot = cv2.warpAffine(
        base,
        cv2.getRotationMatrix2D((W / 2.0, H / 2.0), angle_deg, 1.0),
        (W, H),
        flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_WRAP,
    )
    cur = _roll(rot, dy, dx)

    kf_fft, kf_polar = compute_intermedium(jnp.asarray(base), ops)
    cur_fft, cur_polar = compute_intermedium(jnp.asarray(cur), ops)
    pose, info = compute_pose(
        kf_fft, jnp.asarray(cur), kf_polar, cur_polar, ops, large_rotation=False
    )
    pose = np.asarray(pose)
    got_deg = math.degrees(pose[2])
    # Rotation resolution is one polar row (360/divisor); off-grid angles can
    # land up to ~2 bins away on this small synthetic texture.
    rot_res = 360.0 / CFG.rotation_divisor
    assert abs(got_deg - angle_deg) <= 2 * rot_res + 1e-3, (got_deg, angle_deg)
    # De-rotating the shifted image rotates the shift vector: the estimator
    # sees shift R(θ)·(dx, dy) (exactly what the reference observes too).
    a = math.radians(angle_deg)
    exp_dx = math.cos(a) * dx - math.sin(a) * dy
    exp_dy = math.sin(a) * dx + math.cos(a) * dy
    # x = column shift, y = row shift; sign convention: pose = -(peak-center).
    assert abs(-pose[0] - exp_dx) <= 1.5
    assert abs(-pose[1] - exp_dy) <= 1.5
    assert float(info[0]) > 10.0 and float(info[2]) > 5.0


def test_compute_pose_large_rotation_resolves_ambiguity(rng):
    """Loop mode must disambiguate rotations beyond ±90° (π-periodic polar)."""
    ops = make_cf_ops(CFG)
    base = _texture(rng)
    for angle in [150.0, -120.0]:
        cur = cv2.warpAffine(
            base,
            cv2.getRotationMatrix2D((W / 2.0, H / 2.0), angle, 1.0),
            (W, H),
            flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_WRAP,
        )
        kf_fft, kf_polar = compute_intermedium(jnp.asarray(base), ops)
        _, cur_polar = compute_intermedium(jnp.asarray(cur), ops)
        pose, info = compute_pose(
            kf_fft, jnp.asarray(cur), kf_polar, cur_polar, ops, large_rotation=True
        )
        got = math.degrees(float(pose[2]))
        err = abs((got - angle + 180) % 360 - 180)
        assert err <= 360.0 / CFG.rotation_divisor + 1e-3, (got, angle)


def test_compute_pose_jit_and_vmap(rng):
    ops = make_cf_ops(CFG)
    base = _texture(rng)
    cur = np.stack([_roll(base, 2, 3), _roll(base, -4, 5)])
    kf_fft, kf_polar = compute_intermedium(jnp.asarray(base), ops)
    cur_fft, cur_polar = compute_intermedium(jnp.asarray(cur), ops)

    f = jax.jit(
        lambda img, cp: compute_pose(kf_fft, img, kf_polar, cp, ops, large_rotation=True)
    )
    vpose, vinfo = jax.vmap(lambda img, cp: f(img, cp))(jnp.asarray(cur), cur_polar)
    assert vpose.shape == (2, 3)
    np.testing.assert_allclose(np.asarray(-vpose[0, :2]), [3, 2], atol=1.5)
    np.testing.assert_allclose(np.asarray(-vpose[1, :2]), [5, -4], atol=1.5)


def test_rotate_spectrum_fusion_matches_unfused(rng):
    """rotate_wrap_fft_spectrum == rfft2(rotate_wrap_fft)."""
    from nislam_tpu.ops.fft import rfft2
    from nislam_tpu.ops.warp import rotate_wrap_fft, rotate_wrap_fft_spectrum

    img = rng.random((24, 32), dtype=np.float32)
    for deg in (0.0, 17.3, -44.0, 135.0, -170.0):
        want = np.asarray(rfft2(rotate_wrap_fft(jnp.asarray(img), jnp.asarray(deg))))
        got = np.asarray(rotate_wrap_fft_spectrum(jnp.asarray(img), jnp.asarray(deg)))
        np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("sigma", [0.2, 0.5])
def test_gaussian_kernel_matches_literal_reference_formula(rng, sigma):
    """The gaussian kernel spectrum equals the literal reference formula
    (/root/reference/src/correlation_flow.cc:181-206) including the xx/zz
    energy terms this build drops algebraically: K_ref =
    exp(-(xx+zz-2*IFFT(xf conj(zf)))/(N*sigma^2)) / max K_ref must equal
    exp(e - max e) with e = 2*IFFT(xf conj(zf))/(N*sigma^2)."""
    import dataclasses

    cfg = dataclasses.replace(CFG, kernel=1, sigma=sigma)
    x = _texture(rng)
    z = _roll(_texture(rng), 7, -3)
    xf_np = np.fft.rfft2(x)
    zf_np = np.fft.rfft2(z)
    n = H * W
    # Literal reference formula in numpy (full-spectrum energies; real
    # signals make |x|^2 sums exact via the spatial domain).
    xx = float((x ** 2).sum())
    zz = float((z ** 2).sum())
    xz = np.fft.irfft2(xf_np * np.conj(zf_np), s=(H, W))
    k_ref = np.exp(-(xx + zz - 2.0 * xz) / (n * sigma * sigma))
    k_ref = k_ref / np.abs(k_ref).max()

    from nislam_tpu.ops.registration import _kernel_spectrum

    kf = _kernel_spectrum(
        rfft2(jnp.asarray(x)), rfft2(jnp.asarray(z)), (H, W), cfg
    )
    k_got = np.asarray(irfft2(kf, (H, W)))
    np.testing.assert_allclose(k_got, k_ref, atol=1e-5)


@pytest.mark.parametrize("angle_deg", [0.0, 12.0])
def test_compute_pose_gaussian_kernel(rng, angle_deg):
    """Full pose recovery also works under the gaussian kernel (cfg.kernel=1,
    correlation_flow.cc:157-169 selects it at runtime)."""
    import dataclasses

    cfg = dataclasses.replace(CFG, kernel=1)
    ops = make_cf_ops(cfg)
    img = _texture(rng)
    rot = cv2.warpAffine(
        img,
        cv2.getRotationMatrix2D((W / 2.0, H / 2.0), angle_deg, 1.0),
        (W, H),
        flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_WRAP,
    )
    moved = _roll(rot, 4, -6)
    zf, zp = compute_intermedium(jnp.asarray(img), ops)
    _, xp = compute_intermedium(jnp.asarray(moved), ops)
    pose, info = compute_pose(
        zf, jnp.asarray(moved), zp, xp, ops, large_rotation=False
    )
    pose = np.asarray(pose)
    rot_res = 360.0 / cfg.rotation_divisor
    assert abs(math.degrees(pose[2]) - angle_deg) <= 2 * rot_res + 1e-3
    assert float(info[0]) > 5.0 and float(info[2]) > 5.0


# ---------------------------------------------------------------------------
# half_polar: π-periodicity shortcut (CFConfig.half_polar)
# ---------------------------------------------------------------------------


def test_half_polar_shapes_and_pi_periodicity(rng):
    """The half polar map equals the top half of the full map exactly (same
    tap table rows), and the full map's two halves agree up to the float
    asymmetry of the power transform — the property that licenses the
    optimization."""
    import dataclasses

    from nislam_tpu.ops.fft import irfft2 as _irfft2
    from nislam_tpu.ops.registration import remove_zero_component
    from nislam_tpu.ops.warp import polar_resample, polar_tap_constants

    img = _texture(rng)
    f = rfft2(jnp.asarray(img))
    power = remove_zero_component(_irfft2(jnp.abs(f), (H, W)))
    d, c = CFG.rotation_divisor, CFG.rotation_channel
    idx, wgt = polar_tap_constants(H, W, d, c, fold_dc=False)
    pol = np.asarray(polar_resample(power, jnp.asarray(idx), jnp.asarray(wgt)))
    top, bot = pol[: d // 2], pol[d // 2 :]
    # centro-symmetry of the power transform → π-periodic polar map (border
    # zero-fill asymmetry at the outermost radii only; bulk is rounding-level)
    assert np.abs(top - bot).max() <= 0.1 * np.abs(top).max()
    assert np.abs(top - bot).mean() <= 1e-3 * np.abs(top).max()

    ops_half = make_cf_ops(CFG)  # half_polar defaults True
    assert CFG.half_polar_active and CFG.polar_shape == (d // 2, c)
    _, pol_fft_half = compute_intermedium(jnp.asarray(img), ops_half)
    assert pol_fft_half.shape == (d // 2, c // 2 + 1)

    ops_full = make_cf_ops(dataclasses.replace(CFG, half_polar=False))
    _, pol_fft_full = compute_intermedium(jnp.asarray(img), ops_full)
    assert pol_fft_full.shape == (d, c // 2 + 1)


@pytest.mark.parametrize("angle_deg", [-150.0, -95.0, -40.0, 0.0, 25.0, 110.0, 178.0])
def test_half_polar_matches_full(rng, angle_deg):
    """Half-size rotation registration recovers the same angle as full-size
    (including loop-mode 180° disambiguation) and its PSR, mapped by the
    per-config affine calibration, lands close to the full-grid value."""
    import dataclasses

    ops_half = make_cf_ops(CFG)
    ops_full = make_cf_ops(dataclasses.replace(CFG, half_polar=False))
    base = _texture(rng)
    cur = cv2.warpAffine(
        base,
        cv2.getRotationMatrix2D((W / 2.0, H / 2.0), angle_deg, 1.0),
        (W, H),
        flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_WRAP,
    )
    out = {}
    for name, ops in [("half", ops_half), ("full", ops_full)]:
        kf_fft, kf_polar = compute_intermedium(jnp.asarray(base), ops)
        _, cur_polar = compute_intermedium(jnp.asarray(cur), ops)
        pose, info = compute_pose(
            kf_fft, jnp.asarray(cur), kf_polar, cur_polar, ops,
            large_rotation=True,
        )
        out[name] = (np.asarray(pose), np.asarray(info))
    deg_h = math.degrees(out["half"][0][2])
    deg_f = math.degrees(out["full"][0][2])
    rot_res = 360.0 / CFG.rotation_divisor
    # same disambiguated angle to within one bin (not just mod 180)
    dd = abs(deg_h - deg_f) % 360.0
    assert min(dd, 360.0 - dd) <= rot_res + 1e-3, (deg_h, deg_f)
    # translation agreement (same de-rotation hypothesis won)
    np.testing.assert_allclose(out["half"][0][:2], out["full"][0][:2], atol=2.0)
    # the affine-calibrated half rotation PSR is already IN full-grid
    # units (ops.half_psr_a/b): it must land near the full-grid value
    ratio = out["half"][1][2] / out["full"][1][2]
    assert 0.80 <= ratio <= 1.20, ratio


@pytest.mark.parametrize("angle_deg", [-160.0, -45.0, 20.0, 95.0])
def test_rotation_channel_64_matches_full(rng, angle_deg):
    """Regression pin for the rotation_channel=64 knob (VERDICT r3 #3,
    docs/ROTSTUDY_r4.md): the channel count is radial resolution only —
    loop-mode angle recovery at C=64 must equal the full-channel result to
    within one divisor bin, including the 180° disambiguation."""
    import dataclasses

    got = {}
    for c in (64, CFG.rotation_channel):
        ops = make_cf_ops(dataclasses.replace(CFG, rotation_channel=c))
        base = _texture(rng)
        cur = cv2.warpAffine(
            base,
            cv2.getRotationMatrix2D((W / 2.0, H / 2.0), angle_deg, 1.0),
            (W, H),
            flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_WRAP,
        )
        kf_fft, kf_polar = compute_intermedium(jnp.asarray(base), ops)
        _, cur_polar = compute_intermedium(jnp.asarray(cur), ops)
        pose, info = compute_pose(
            kf_fft, jnp.asarray(cur), kf_polar, cur_polar, ops,
            large_rotation=True,
        )
        got[c] = math.degrees(float(np.asarray(pose)[2]))
    rot_res = 360.0 / CFG.rotation_divisor
    dd = abs(got[64] - got[CFG.rotation_channel]) % 360.0
    assert min(dd, 360.0 - dd) <= rot_res + 1e-3, got
    dd_true = abs(got[64] - angle_deg) % 360.0
    assert min(dd_true, 360.0 - dd_true) <= 2 * rot_res + 1e-3, got


# ---------------------------------------------------------------------------
# Spectral transforms (ops.fft) against numpy at composite and prime sizes
# ---------------------------------------------------------------------------


class TestFactoredDFT:
    """Every ``ops.fft`` transform is oracle-exact at composite, prime and
    mixed axis sizes, batched and under vmap."""

    @pytest.mark.parametrize("h,w", [(48, 64), (36, 100), (60, 45), (21, 33)])
    def test_rfft2_irfft2_oracle(self, rng, h, w):
        x = rng.standard_normal((h, w)).astype(np.float32)
        got = np.asarray(rfft2(jnp.asarray(x)))
        np.testing.assert_allclose(got, np.fft.rfft2(x), atol=2e-4)
        back = np.asarray(irfft2(jnp.asarray(np.fft.rfft2(x)), (h, w)))
        np.testing.assert_allclose(back, x, atol=2e-5)

    def test_mixed_axes(self, rng):
        """A prime axis beside a composite one."""
        x = rng.standard_normal((37, 48)).astype(np.float32)  # 37 prime
        np.testing.assert_allclose(
            np.asarray(rfft2(jnp.asarray(x))), np.fft.rfft2(x), atol=2e-4
        )
        xf = np.fft.rfft2(x)
        np.testing.assert_allclose(
            np.asarray(irfft2(jnp.asarray(xf), (37, 48))), x, atol=2e-5
        )

    def test_irfft2_of_real_magnitude(self, rng):
        x = rng.standard_normal((48, 64)).astype(np.float32)
        mag = np.abs(np.fft.rfft2(x)).astype(np.float32)
        got = np.asarray(irfft2(jnp.asarray(mag), (48, 64)))
        oracle = np.fft.irfft2(mag, s=(48, 64))
        np.testing.assert_allclose(got, oracle, atol=2e-5)

    def test_1d_transforms_oracle(self, rng):
        from nislam_tpu.ops.fft import (
            irfft_ax2,
            irfft_last,
            rfft_ax2,
            rfft_last,
        )

        x = rng.standard_normal((5, 48, 64)).astype(np.float32)
        np.testing.assert_allclose(
            np.asarray(rfft_last(jnp.asarray(x))),
            np.fft.rfft(x, axis=-1),
            atol=2e-4,
        )
        np.testing.assert_allclose(
            np.asarray(rfft_ax2(jnp.asarray(x))),
            np.fft.rfft(x, axis=-2),
            atol=2e-4,
        )
        fl = np.fft.rfft(x, axis=-1)
        np.testing.assert_allclose(
            np.asarray(irfft_last(jnp.asarray(fl), 64)), x, atol=2e-5
        )
        f2 = np.fft.rfft(x, axis=-2)
        np.testing.assert_allclose(
            np.asarray(irfft_ax2(jnp.asarray(f2), 48)), x, atol=2e-5
        )

    def test_rfft2_from_last_spectrum(self, rng):
        from nislam_tpu.ops.fft import rfft2_from_last_spectrum

        x = rng.standard_normal((48, 64)).astype(np.float32)
        g = np.fft.rfft(x, axis=-1)
        got = np.asarray(rfft2_from_last_spectrum(jnp.asarray(g)))
        np.testing.assert_allclose(got, np.fft.rfft2(x), atol=2e-4)

    def test_registration_recovers_transform_via_ct(self, rng):
        """End-to-end gate: compute_pose on the full polar grid recovers a
        known (tx, ty, θ) — these spectra feed the whole KCC chain."""
        import dataclasses

        cfg = dataclasses.replace(CFG, half_polar=False)
        ops = make_cf_ops(cfg)
        base = _texture(rng)
        angle, dx, dy = -9.0, 4, -3
        rot = cv2.warpAffine(
            base,
            cv2.getRotationMatrix2D((W / 2.0, H / 2.0), angle, 1.0),
            (W, H),
            flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_WRAP,
        )
        cur = np.roll(rot, (dy, dx), axis=(0, 1))
        kf_fft, kf_polar = compute_intermedium(jnp.asarray(base), ops)
        _, cur_polar = compute_intermedium(jnp.asarray(cur), ops)
        pose, info = compute_pose(
            kf_fft, jnp.asarray(cur), kf_polar, cur_polar, ops,
            large_rotation=False,
        )
        got_deg = math.degrees(float(pose[2]))
        rot_res = 360.0 / cfg.rotation_divisor
        assert abs(got_deg - angle) <= 2 * rot_res + 1e-3, (got_deg, angle)
        a = math.radians(angle)
        exp_dx = math.cos(a) * dx - math.sin(a) * dy
        exp_dy = math.sin(a) * dx + math.cos(a) * dy
        assert abs(-float(pose[0]) - exp_dx) <= 1.5
        assert abs(-float(pose[1]) - exp_dy) <= 1.5
        assert float(info[0]) > 10.0 and float(info[2]) > 5.0

    def test_batched_and_vmap(self, rng):
        x = rng.standard_normal((3, 48, 64)).astype(np.float32)
        got = np.asarray(rfft2(jnp.asarray(x)))
        np.testing.assert_allclose(got, np.fft.rfft2(x, axes=(-2, -1)), atol=2e-4)
        vgot = np.asarray(jax.vmap(rfft2)(jnp.asarray(x)))
        np.testing.assert_allclose(vgot, got, atol=1e-4)


def test_conj_spectrum_is_180_rotation(rng):
    """The loop-mode hypothesis-2 shortcut: conj of the rfft2 half spectrum
    == the spectrum of the 180°-reindexed image (exact), and ≈ the shear
    rotation by deg+180 (decision-level, boundary rows differ)."""
    from nislam_tpu.ops.fft import rfft2
    from nislam_tpu.ops.warp import _rot180, rotate_wrap_fft_spectrum

    img = jnp.asarray(_texture(rng, 64, 96))
    f = rfft2(img)
    np.testing.assert_allclose(
        np.asarray(jnp.conj(f)), np.asarray(rfft2(_rot180(img))), atol=1e-3
    )


@pytest.mark.parametrize("angle", [150.0, -120.0, 179.0])
def test_loop_mode_conj_hypothesis_matches_gather_path(rng, angle):
    """Loop-mode compute_pose via the conj-hypothesis shortcut (fft rotate
    path) decides like the explicit two-rotation gather path: same angle,
    same shift, comparable confidence."""
    import dataclasses

    base = _texture(rng)
    cur = cv2.warpAffine(
        base,
        cv2.getRotationMatrix2D((W / 2.0, H / 2.0), angle, 1.0),
        (W, H),
        flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_WRAP,
    )
    res = {}
    for method in ("fft", "gather"):
        cfg = dataclasses.replace(CFG, rotate_method=method)
        ops = make_cf_ops(cfg)
        kf_fft, kf_polar = compute_intermedium(jnp.asarray(base), ops)
        _, cur_polar = compute_intermedium(jnp.asarray(cur), ops)
        pose, info = compute_pose(
            kf_fft, jnp.asarray(cur), kf_polar, cur_polar, ops,
            large_rotation=True,
        )
        res[method] = (np.asarray(pose), np.asarray(info))
    pf, inf_f = res["fft"]
    pg, inf_g = res["gather"]
    err = abs((math.degrees(pf[2]) - math.degrees(pg[2]) + 180) % 360 - 180)
    assert err <= 360.0 / CFG.rotation_divisor + 1e-3
    np.testing.assert_allclose(pf[:2], pg[:2], atol=1.5)
    # PSR differs between sinc (fft) and bilinear (gather) interpolation —
    # a pre-existing, documented gap (SURVEY §7 hard part 2), not the conj
    # shortcut: vs the explicit two-rotation fft construction the conj
    # hypothesis is verified to ~0.1% below.
    np.testing.assert_allclose(inf_f[0], inf_g[0], rtol=0.5)


def test_conj_hypothesis_matches_explicit_fft_rotation(rng):
    """conj(rfft2(rotate_fft(img, -d))) registers identically (PSR ~0.1%)
    to the explicit rotate_fft(img, -d+180) spectrum it replaces."""
    from nislam_tpu.ops.fft import r2c
    from nislam_tpu.ops.warp import rotate_wrap_fft_spectrum

    base = _texture(rng)
    cur = cv2.warpAffine(
        base,
        cv2.getRotationMatrix2D((W / 2.0, H / 2.0), -120.0, 1.0),
        (W, H),
        flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_WRAP,
    )
    ops = make_cf_ops(CFG)
    kf_fft, _ = compute_intermedium(jnp.asarray(base), ops)
    img = jnp.asarray(cur)
    tgt = r2c(ops.target_fft)
    for degree, matched in ((60.0, True), (-33.0, False)):
        f_old = rotate_wrap_fft_spectrum(img, jnp.float32(-degree + 180.0))
        f_new = jnp.conj(rotate_wrap_fft_spectrum(img, jnp.float32(-degree)))
        tr_o, psr_o = estimate_trans(kf_fft, f_old, tgt, (H, W), CFG)
        tr_n, psr_n = estimate_trans(kf_fft, f_new, tgt, (H, W), CFG)
        if matched:  # a no-match response's argmax is noise — PSR only there
            np.testing.assert_allclose(np.asarray(tr_n), np.asarray(tr_o), atol=1.0)
            np.testing.assert_allclose(float(psr_n), float(psr_o), rtol=0.02)
        else:
            assert float(psr_n) < 12.0 and float(psr_o) < 12.0
            np.testing.assert_allclose(float(psr_n), float(psr_o), rtol=0.35)


def test_half_polar_affine_calibration_properties(rng):
    """The per-config affine (half_polar_psr_affine): matched confidences
    map into full-grid units, and — unlike the legacy global divide — the
    NO-match tail is not inflated (VERDICT r4 weak #4 / ADVICE #1)."""
    import dataclasses

    ops_half = make_cf_ops(CFG)
    ops_full = make_cf_ops(dataclasses.replace(CFG, half_polar=False))
    a, b = ops_half.half_psr_a, ops_half.half_psr_b
    assert 1.05 <= a <= 1.45 and b <= 0.5, (a, b)

    # no-match probes through the real pipeline: calibrated half PSR must
    # stay close to the full-grid garbage PSR (the legacy /0.84 blanket
    # divide read ~1.2x high here)
    for seed in (1, 2, 3):
        r2 = np.random.default_rng(seed)
        t1, t2 = _texture(r2), _texture(r2)
        ratios = {}
        for name, ops in [("half", ops_half), ("full", ops_full)]:
            _, p1 = compute_intermedium(jnp.asarray(t1), ops)
            _, p2 = compute_intermedium(jnp.asarray(t2), ops)
            kf_fft, _ = compute_intermedium(jnp.asarray(t1), ops)
            _, info = compute_pose(
                kf_fft, jnp.asarray(t2), p1, p2, ops, large_rotation=True
            )
            ratios[name] = float(info[2])
        # both are garbage-level; calibrated half must not exceed full by
        # the legacy ~1.2x inflation
        assert ratios["half"] <= ratios["full"] * 1.15 + 0.5, ratios


def test_half_polar_near_threshold_gating_matches_full(rng):
    """VERDICT r4 #5 'done' check: rotation gating just above/below a
    threshold decides the same under half_polar and full polar.  The
    threshold is set AT the full-grid confidence of each probe ±margin, so
    the decision is maximally sensitive to calibration error."""
    import dataclasses

    ops_half = make_cf_ops(CFG)
    ops_full = make_cf_ops(dataclasses.replace(CFG, half_polar=False))
    agree = 0
    total = 0
    for seed in range(5):
        r2 = np.random.default_rng(100 + seed)
        base = _texture(r2)
        cur = cv2.warpAffine(
            base,
            cv2.getRotationMatrix2D((W / 2.0, H / 2.0), 20.0 + 7 * seed, 1.0),
            (W, H),
            flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_WRAP,
        )
        infos = {}
        for name, ops in [("half", ops_half), ("full", ops_full)]:
            kf_fft, kf_polar = compute_intermedium(jnp.asarray(base), ops)
            _, cur_polar = compute_intermedium(jnp.asarray(cur), ops)
            _, info = compute_pose(
                kf_fft, jnp.asarray(cur), kf_polar, cur_polar, ops,
                large_rotation=True,
            )
            infos[name] = float(info[2])
        # thresholds bracketing the full-grid confidence by ±8%
        for thr in (infos["full"] * 0.92, infos["full"] * 1.08):
            total += 1
            agree += (infos["half"] > thr) == (infos["full"] > thr)
    # ±8% brackets with calibration noise: require strong (not perfect)
    # agreement — the pre-calibration global divide fails the garbage-side
    # analog of this by construction
    assert agree >= total - 2, (agree, total)


@pytest.mark.parametrize("h,w,div,ch", [(96, 128, 180, 96), (95, 127, 90, 48), (64, 64, 73, 31)])
def test_polar_resample_quad_matches_4tap(rng, h, w, div, ch):
    """ADVICE r4 #3: polar_resample_quad (the production path) is
    bit-identical to polar_tap_constants(fold_dc=False) + polar_resample
    on the SAME input, including odd sizes and border/wrap cases."""
    from nislam_tpu.ops.warp import (
        polar_quad_constants,
        polar_resample,
        polar_resample_quad,
        polar_tap_constants,
    )

    x = rng.standard_normal((h, w)).astype(np.float32)
    x = np.asarray(remove_zero_component(jnp.asarray(x)))
    idx4, w4t = polar_tap_constants(h, w, div, ch, fold_dc=False)
    want = np.asarray(
        polar_resample(jnp.asarray(x), jnp.asarray(idx4), jnp.asarray(w4t))
    )
    base, w4 = polar_quad_constants(h, w, div, ch)
    got = np.asarray(
        polar_resample_quad(jnp.asarray(x), jnp.asarray(base), jnp.asarray(w4))
    )
    np.testing.assert_allclose(got, want, atol=1e-6)
    # batched input
    xb = jnp.stack([jnp.asarray(x)] * 3)
    gotb = np.asarray(
        polar_resample_quad(xb, jnp.asarray(base), jnp.asarray(w4))
    )
    np.testing.assert_allclose(gotb[2], want, atol=1e-6)


def test_polar_taps_schemes_identical(rng):
    """The "quad" and "4tap" polar resamples agree to last-ulp (border
    cells sum their taps in different orders — the auto threshold is a
    pure perf choice, CFConfig.polar_taps).  Compared on the resampled
    polar MAP itself (the scheme-dependent tensor), not the image
    spectrum computed before the branch."""
    import dataclasses

    from nislam_tpu.ops.warp import polar_resample, polar_resample_quad

    img = jnp.asarray(_texture(rng))
    pols = {}
    for scheme in ("quad", "4tap"):
        ops = make_cf_ops(dataclasses.replace(CFG, polar_taps=scheme))
        assert ops.polar_scheme == scheme
        resample = polar_resample_quad if scheme == "quad" else polar_resample
        pols[scheme] = np.asarray(
            resample(remove_zero_component(img), ops.polar_idx, ops.polar_w)
        )
    np.testing.assert_allclose(pols["quad"], pols["4tap"], atol=1e-6)
