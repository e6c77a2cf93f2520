"""Gather-based image resampling: the JAX replacement for OpenCV warps.

The reference relies on three OpenCV resampling calls:

- ``cv::warpPolar`` for the log-free polar map of the power spectrum
  (/root/reference/src/correlation_flow.cc:228-236),
- ``cv::warpAffine`` with ``BORDER_WRAP`` for de-rotation
  (/root/reference/src/utils.cc:154-161),
- ``cv::remap`` for undistortion (/root/reference/src/camera.cc:92-103).

All three are bilinear gathers with different sampling grids and border
policies.  Here each becomes a vectorized gather over a precomputed (or
cheaply computed in-jit) coordinate grid — fully fused by XLA with the
surrounding spectral ops.  Everything here is batched over leading axes and
``vmap``-safe.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from nislam_tpu.ops.fft import (
    irfft_ax2,
    irfft_last,
    rfft2_from_last_spectrum,
    rfft_ax2,
    rfft_last,
)


def bilinear_sample(
    img: jnp.ndarray,
    x: jnp.ndarray,
    y: jnp.ndarray,
    *,
    wrap: bool = False,
) -> jnp.ndarray:
    """Bilinearly sample ``img[..., H, W]`` at float coords ``(x, y)``.

    ``x`` indexes columns, ``y`` rows (OpenCV convention).  With
    ``wrap=False`` out-of-range taps contribute zero, matching OpenCV
    ``BORDER_CONSTANT(0)`` / ``WARP_FILL_OUTLIERS``.  With ``wrap=True``
    coordinates wrap modulo the image size, matching ``BORDER_WRAP`` —
    the periodic boundary consistent with circular correlation.
    """
    h, w = img.shape[-2], img.shape[-1]
    out_hw = x.shape[-2:]
    # Broadcast leading (batch) dims of the image and the coordinate grids so
    # that a shared grid works on a batched image and vice versa, then gather
    # through a flattened spatial index (take_along_axis handles per-batch
    # indices, which plain advanced indexing does not).
    lead = jnp.broadcast_shapes(img.shape[:-2], x.shape[:-2])
    img_flat = jnp.broadcast_to(img, lead + (h, w)).reshape(lead + (h * w,))
    x = jnp.broadcast_to(x, lead + out_hw)
    y = jnp.broadcast_to(y, lead + out_hw)

    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    wx = (x - x0f).astype(img.dtype)
    wy = (y - y0f).astype(img.dtype)
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)
    x1 = x0 + 1
    y1 = y0 + 1

    def gather(yi, xi):
        idx = (yi * w + xi).reshape(lead + (-1,))
        return jnp.take_along_axis(img_flat, idx, axis=-1).reshape(lead + out_hw)

    if wrap:
        def tap(yi, xi):
            return gather(jnp.mod(yi, h), jnp.mod(xi, w))
    else:
        def tap(yi, xi):
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = gather(jnp.clip(yi, 0, h - 1), jnp.clip(xi, 0, w - 1))
            return jnp.where(valid, v, jnp.zeros((), img.dtype))

    v00 = tap(y0, x0)
    v01 = tap(y0, x1)
    v10 = tap(y1, x0)
    v11 = tap(y1, x1)

    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def polar_grid(
    h: int, w: int, divisor: int, channel: int
) -> tuple[np.ndarray, np.ndarray]:
    """Sampling grid reproducing ``cv::warpPolar`` (linear, forward map).

    Destination is ``(divisor, channel)`` = (angle rows, radius cols); for
    dest pixel ``(phi, rho)``: ``angle = phi * 2π/divisor``,
    ``mag = rho * maxRadius/channel`` with ``maxRadius = min(h//2, w//2)``
    and center ``(w/2, h/2)`` — exactly the parameters of
    /root/reference/src/correlation_flow.cc:230-234.  Returned as host
    numpy arrays so callers can bake them in as compile-time constants.
    """
    cx, cy = w / 2.0, h / 2.0
    max_radius = float(min(h // 2, w // 2))
    phi = np.arange(divisor, dtype=np.float32)[:, None]  # (divisor, 1)
    rho = np.arange(channel, dtype=np.float32)[None, :]  # (1, channel)
    angle = phi * (2.0 * math.pi / divisor)
    mag = rho * (max_radius / channel)
    x = cx + mag * np.cos(angle)
    y = cy + mag * np.sin(angle)
    return x.astype(np.float32), y.astype(np.float32)


def warp_polar(img: jnp.ndarray, grid_x: jnp.ndarray, grid_y: jnp.ndarray) -> jnp.ndarray:
    """Apply a precomputed :func:`polar_grid` to ``img`` (zero-filled border)."""
    return bilinear_sample(img, grid_x, grid_y, wrap=False)


def polar_tap_constants(
    h: int, w: int, divisor: int, channel: int, fold_dc: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Host-precomputed taps for the fused power→polar resample.

    The KCC polar feature chain ``warp_polar(fftshift(remove_zero_component(
    power)))`` (/root/reference/src/correlation_flow.cc:79-95,228-236) is a
    fixed linear map of ``power``: the fftshift is an index permutation, the
    DC suppression replaces row/col 0 with the mean of their ±1 neighbors,
    and the bilinear polar gather has 4 static taps per output.  Folding all
    three into one precomputed (index, weight) table removes two whole-array
    data-movement ops from the hot path and leaves a single static gather +
    weighted sum that XLA fuses.

    Returns ``(idx, wgt)`` of shape (divisor, channel, K): flat row-major
    indices into the UNSHIFTED ``power`` array and their weights (taps that
    fall outside the shifted frame, or redirection slots that are unused,
    carry weight 0 and index 0).  With ``fold_dc`` K = 8 (a bilinear tap
    landing on the suppressed row/col 0 redirects to its two mean-source
    pixels) and the input is the raw ``power``; without it K = 4 (only the
    fftshift is folded) and the caller applies the DC suppression
    elementwise first — fewer gather taps at the cost of one cheap
    whole-array select, the better trade on devices where gathers dominate.
    """
    gx, gy = polar_grid(h, w, divisor, channel)  # float coords, SHIFTED frame
    x0 = np.floor(gx).astype(np.int64)
    y0 = np.floor(gy).astype(np.int64)
    wx = (gx - x0).astype(np.float64)
    wy = (gy - y0).astype(np.float64)

    k = 8 if fold_dc else 4
    idx = np.zeros((divisor, channel, k), np.int64)
    wgt = np.zeros((divisor, channel, k), np.float64)
    slot = np.zeros((divisor, channel), np.int64)

    def emit(yi, xi, weight):
        """Accumulate one tap given integer coords in the SHIFTED frame."""
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w) & (weight > 0)
        # shifted[y, x] = orig[(y - h//2) % h, (x - w//2) % w]
        oy = np.mod(yi - h // 2, h)
        ox = np.mod(xi - w // 2, w)
        if not fold_dc:
            branches = ((oy, ox, weight),)
        else:
            # DC suppression redirects (corner: col rule wins — the col-0
            # means are computed from the original array and applied last).
            on_c0 = ox == 0
            on_r0 = (oy == 0) & ~on_c0
            branches = (
                # plain tap (neither suppressed row nor col)
                (oy, ox, np.where(on_c0 | on_r0, 0.0, weight)),
                # row-0 tap → mean of rows 1 and h-1
                (np.full_like(oy, 1), ox, np.where(on_r0, 0.5 * weight, 0.0)),
                (np.full_like(oy, h - 1), ox, np.where(on_r0, 0.5 * weight, 0.0)),
                # col-0 tap → mean of cols 1 and w-1
                (oy, np.full_like(ox, 1), np.where(on_c0, 0.5 * weight, 0.0)),
                (oy, np.full_like(ox, w - 1), np.where(on_c0, 0.5 * weight, 0.0)),
            )
        for sy, sx, sw in branches:
            sw = np.asarray(sw, np.float64)
            use = valid & (sw > 0)
            ii, jj = np.nonzero(use)
            s = slot[ii, jj]
            idx[ii, jj, s] = sy[ii, jj] * w + sx[ii, jj]
            wgt[ii, jj, s] = sw[ii, jj]
            slot[ii, jj] = s + 1

    emit(y0, x0, (1.0 - wx) * (1.0 - wy))
    emit(y0, x0 + 1, wx * (1.0 - wy))
    emit(y0 + 1, x0, (1.0 - wx) * wy)
    emit(y0 + 1, x0 + 1, wx * wy)
    assert slot.max() <= k
    return idx.astype(np.int32), wgt.astype(np.float32)


def polar_resample(power: jnp.ndarray, idx: jnp.ndarray, wgt: jnp.ndarray) -> jnp.ndarray:
    """Fused power→polar map: static gather + weighted sum over the tap
    table of :func:`polar_tap_constants`.  ``power`` is the UNSHIFTED
    (..., H, W) power transform; returns (..., divisor, channel)."""
    flat = power.reshape(*power.shape[:-2], -1)
    taps = jnp.take(flat, idx.reshape(-1), axis=-1).reshape(
        flat.shape[:-1] + idx.shape
    )
    return jnp.sum(taps * wgt, axis=-1)


def _shear_x_spectrum(img: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Row-wise half spectrum of the circular x-shear of ``img`` —
    the shear phase applied to ``rfft_last(img)``, inverse NOT taken."""
    h, w = img.shape[-2], img.shape[-1]
    f = rfft_last(img)  # (..., H, W//2+1)
    kx = jnp.arange(w // 2 + 1, dtype=jnp.float32)
    y = jnp.arange(h, dtype=jnp.float32) - h / 2.0
    d = s[..., None] * y  # (..., H) row shifts
    phase = jnp.exp(2j * jnp.pi / w * d[..., :, None] * kx)  # (..., H, W//2+1)
    return f * phase


def _shear_x(img: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Circular x-shear: dst(y, x) = src(y, x + s·(y − cy)) via the Fourier
    shift theorem along rows (no gathers, sinc interpolation, exact wrap)."""
    return irfft_last(_shear_x_spectrum(img, s), img.shape[-1])


def _shear_y(img: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Circular y-shear: dst(y, x) = src(y + s·(x − cx), x) along columns."""
    h, w = img.shape[-2], img.shape[-1]
    f = rfft_ax2(img)  # (..., H//2+1, W)
    ky = jnp.arange(h // 2 + 1, dtype=jnp.float32)
    x = jnp.arange(w, dtype=jnp.float32) - w / 2.0
    d = s[..., None] * x  # (..., W) column shifts
    phase = jnp.exp(2j * jnp.pi / h * ky[..., :, None] * d[..., None, :])
    return irfft_ax2(f * phase, h)


def _rot180(img: jnp.ndarray) -> jnp.ndarray:
    """Exact 180° rotation about the (W/2, H/2) center for even sizes:
    dst(y, x) = src((−y) mod H, (−x) mod W) — pure reindexing."""
    return jnp.roll(jnp.flip(img, axis=(-2, -1)), shift=(1, 1), axis=(-2, -1))


def rotate_wrap_fft(img: jnp.ndarray, degree: jnp.ndarray) -> jnp.ndarray:
    """Rotation about the image center with periodic wrap — three FFT
    shears instead of a bilinear gather.

    Same dst→src map as :func:`rotate_wrap` (``R(deg)`` about ``(W/2,
    H/2)``), decomposed as ``R(θ) = Sx(−tan(θ/2)) · Sy(sin θ) ·
    Sx(−tan(θ/2))`` with each shear applied in the Fourier domain (phase
    multiply — dense elementwise work, no gathers).  Angles beyond
    ±90° are folded through an exact 180° flip so the shear factors stay
    small (|tan(θ/2)| ≤ 1).  Interpolation is sinc (Fourier) rather than
    the reference's bilinear (/root/reference/src/utils.cc:154-161) —
    equivalent at the decision level (SURVEY §7 hard part 2) and usually
    sharper.  Requires even H and W (all supported configs; asserts).
    """
    h, w = img.shape[-2], img.shape[-1]
    if h % 2 or w % 2:
        raise ValueError(f"rotate_wrap_fft requires even sizes, got {h}x{w}")
    img, a, b = _fold_and_shears(img, degree)
    return _shear_x(_shear_y(_shear_x(img, a), b), a)


def _fold_and_shears(img, degree):
    """Fold the angle into (-90, 90] (+ exact 180° flip of the image) and
    return the two shear factors of R(θ) = Sx(-tan θ/2)·Sy(sin θ)·Sx(-tan θ/2)."""
    deg = jnp.asarray(degree, jnp.float32)
    d = deg - 360.0 * jnp.floor((deg + 180.0) / 360.0)  # (-180, 180]
    flip = jnp.abs(d) > 90.0
    d = jnp.where(flip, d - jnp.sign(d) * 180.0, d)
    img = jnp.where(flip[..., None, None], _rot180(img), img)
    rad = d * (math.pi / 180.0)
    return img, -jnp.tan(rad / 2.0), jnp.sin(rad)


def rotate_wrap_fft_spectrum(img: jnp.ndarray, degree: jnp.ndarray) -> jnp.ndarray:
    """``rfft2(rotate_wrap_fft(img, degree))`` with the final shear's
    inverse W-axis transform and the rfft2's forward W-axis transform
    cancelled — the KCC tracking path always FFTs the de-rotated image
    (/root/reference/src/correlation_flow.cc:110-114), so fusing saves one
    full W-axis roundtrip per registration."""
    h, w = img.shape[-2], img.shape[-1]
    if h % 2 or w % 2:
        raise ValueError(f"rotate_wrap_fft requires even sizes, got {h}x{w}")
    img, a, b = _fold_and_shears(img, degree)
    g = _shear_x_spectrum(_shear_y(_shear_x(img, a), b), a)
    # A real signal's DC and Nyquist bins are real; irfft silently drops
    # their imaginary parts (the shear phase at Nyquist is exp(iπd), complex
    # for fractional shifts).  Project so the fusion equals the roundtrip.
    im = jnp.imag(g)
    im = im.at[..., 0].set(0.0).at[..., -1].set(0.0)
    g = jax.lax.complex(jnp.real(g), im)
    return rfft2_from_last_spectrum(g)


def rotate_wrap(img: jnp.ndarray, degree: jnp.ndarray) -> jnp.ndarray:
    """Rotate ``img[..., H, W]`` by ``degree`` about the image center.

    Reproduces ``RotateArray`` (/root/reference/src/utils.cc:154-161):
    ``cv::warpAffine(getRotationMatrix2D(center, degree, 1), BORDER_WRAP)``.
    For each destination pixel ``p`` the source coordinate is
    ``R(-deg)·(p - c) + c`` with ``c = (W/2, H/2)`` (OpenCV inverts the
    forward matrix internally), sampled bilinearly with periodic wrap.

    ``degree`` may be a traced scalar or batched ``(...,)`` matching the
    leading axes of ``img``; the grid is built in-jit (cos/sin + FMA — elementwise
    work that XLA fuses with the gather).
    """
    h, w = img.shape[-2], img.shape[-1]
    cx, cy = w / 2.0, h / 2.0
    deg = jnp.asarray(degree, jnp.float32)
    rad = deg * (math.pi / 180.0)
    a = jnp.cos(rad)
    b = jnp.sin(rad)
    # dst→src map: src = [[a, -b], [b, a]] @ (p - c) + c
    xs = jnp.arange(w, dtype=jnp.float32)[None, :] - cx  # (1, W)
    ys = jnp.arange(h, dtype=jnp.float32)[:, None] - cy  # (H, 1)
    a_ = a[..., None, None]
    b_ = b[..., None, None]
    src_x = a_ * xs - b_ * ys + cx
    src_y = b_ * xs + a_ * ys + cy
    return bilinear_sample(img, src_x, src_y, wrap=True)


def warp_translate_rotate(
    img: jnp.ndarray, tx: jnp.ndarray, ty: jnp.ndarray, degree: jnp.ndarray
) -> jnp.ndarray:
    """Translate by ``(tx, ty)`` then rotate — ``WarpArray`` parity.

    Mirrors /root/reference/src/utils.cc:163-171: an affine translate with
    ``BORDER_WRAP`` followed by :func:`rotate_wrap`.  The translation's
    dst→src map is ``src = p - t`` (warpAffine inverts the forward matrix).
    Used by map rectification utilities; the reference's per-frame call at
    correlation_flow.cc:141 is dead compute and not replicated in the hot
    path.
    """
    h, w = img.shape[-2], img.shape[-1]
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    tx = jnp.asarray(tx, jnp.float32)[..., None, None]
    ty = jnp.asarray(ty, jnp.float32)[..., None, None]
    shifted = bilinear_sample(img, xs - tx, ys - ty, wrap=True)
    return rotate_wrap(shifted, degree)


def polar_quad_constants(
    h: int, w: int, divisor: int, channel: int
) -> tuple[np.ndarray, np.ndarray]:
    """Quad-packed taps for :func:`polar_resample_quad`.

    The 2×2 bilinear footprint of every polar output is contiguous in a
    quad-packed view of ``power`` (:func:`quad_pack`), so the resample
    needs ONE gather index per output instead of four — 4× fewer gather
    indices for the same bilinear result.

    Returns ``(base, w4)``: ``base`` (divisor, channel) i32 flat row-major
    indices of the top-left tap (coords taken mod (h, w) — the packed view
    wraps, and out-of-frame taps carry weight 0), and ``w4`` (divisor,
    channel, 4) f32 weights in slot order [(0,0), (0,1), (1,0), (1,1)]
    (dy, dx).  Semantics identical to ``polar_tap_constants(fold_dc=False)``:
    fftshift folded in, zero-fill outside the shifted frame, DC suppression
    applied by the caller beforehand.
    """
    gx, gy = polar_grid(h, w, divisor, channel)  # float coords, SHIFTED frame
    x0 = np.floor(gx).astype(np.int64)
    y0 = np.floor(gy).astype(np.int64)
    wx = (gx - x0).astype(np.float64)
    wy = (gy - y0).astype(np.float64)
    w4 = np.stack(
        [(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx], axis=-1
    )
    # zero-fill border: a tap outside the SHIFTED frame contributes nothing
    for k, (dy, dx) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        yi, xi = y0 + dy, x0 + dx
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        w4[..., k] = np.where(valid, w4[..., k], 0.0)
    # shifted → original frame (mod): shifted[y, x] = orig[(y-h//2)%h, (x-w//2)%w]
    oy = np.mod(y0 - h // 2, h)
    ox = np.mod(x0 - w // 2, w)
    return (oy * w + ox).astype(np.int32), w4.astype(np.float32)


def quad_pack(power: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) → (..., H*W, 4) with entry [y*W+x] = the 2×2 footprint
    [P[y,x], P[y,x+1], P[y+1,x], P[y+1,x+1]] (circular wrap).  Pure rolls —
    one cheap elementwise pass; XLA fuses it with the producer."""
    p01 = jnp.roll(power, -1, axis=-1)
    p10 = jnp.roll(power, -1, axis=-2)
    p11 = jnp.roll(p10, -1, axis=-1)
    q = jnp.stack([power, p01, p10, p11], axis=-1)
    return q.reshape(*power.shape[:-2], -1, 4)


def polar_resample_quad(
    power: jnp.ndarray, base: jnp.ndarray, w4: jnp.ndarray
) -> jnp.ndarray:
    """Fused power→polar map with one gather index per output — the
    quad-packed equivalent of :func:`polar_resample` (same semantics as the
    ``fold_dc=False`` tap table: caller applies DC suppression first)."""
    q = quad_pack(power)  # (..., HW, 4)
    taps = jnp.take(q, base.reshape(-1), axis=-2)  # (..., D*C, 4)
    taps = taps.reshape(*power.shape[:-2], *base.shape, 4)
    return jnp.sum(taps * w4, axis=-1)
