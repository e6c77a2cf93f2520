"""Spectral primitives with the reference FFT conventions.

The reference (``/root/reference/src/correlation_flow.cc:53-77``) uses FFTW's
single-precision r2c/c2r transforms over column-major Eigen arrays with the
axis order reversed in the FFTW call, storing the non-negative half of the
spectrum along the *row* axis, and normalizing the inverse by ``1/N``.

We use the ``rfft2``/``irfft2`` convention over row-major ``(..., H, W)``
arrays (half spectrum along the *last* axis).  Every consumer of these
spectra in the KCC pipeline is either an elementwise spectral product
followed by an inverse transform (circular correlation) or the magnitude
spectrum of a real image — both are invariant to which axis carries the
halved spectrum, so the spatial-domain results match the reference
bit-for-bit up to float rounding.

The inverse transform normalizes by ``1/(H*W)`` exactly like the reference's
``IFFT`` (``src/correlation_flow.cc:76``: ``x / x.size()``), which is also
numpy's default ``irfft2`` normalization.

Every transform is ``jnp.fft`` (the FFT HLO: cuFFT on the GPU, DUCC on
the CPU) in float32.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def c2r(x: jnp.ndarray) -> jnp.ndarray:
    """Complex (..., N) → float32 (..., N, 2) real view.

    Persistent state (keyframe banks, tracking carries, checkpoints) stores
    spectra in this form: float storage is portable across backends,
    checkpoints and reduced-precision banks (``MapConfig.bank_dtype``).
    Complex values exist only transiently inside a jitted program between
    :func:`rfft2` and its consumers; XLA fuses these view conversions into
    the neighboring ops.
    """
    return jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1)


def r2c(y: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`c2r`: float (..., N, 2) → complex64 (..., N).

    Upcasts reduced-precision storage (``MapConfig.bank_dtype="bf16"``) so
    every consumer computes in f32 regardless of how the pair was stored.
    """
    if y.dtype != jnp.float32:
        y = y.astype(jnp.float32)
    return jax.lax.complex(y[..., 0], y[..., 1])


def rfft2(x: jnp.ndarray) -> jnp.ndarray:
    """Real 2D FFT over the last two axes; spectrum shape ``(..., H, W//2+1)``.

    Matches ``CorrelationFlow::FFT`` (/root/reference/src/correlation_flow.cc:53-63)
    up to the (irrelevant) choice of halved axis.
    """
    return jnp.fft.rfft2(x.astype(jnp.float32))


def rfft2_from_last_spectrum(g: jnp.ndarray) -> jnp.ndarray:
    """Finish an rfft2 given the last-axis (row-wise) half spectrum ``g``
    of shape ``(..., H, W//2+1)`` — i.e. apply only the H-axis DFT.

    Lets callers that already hold a row spectrum (the final x-shear of the
    Fourier rotator) skip the inverse-then-forward W-axis roundtrip, which
    cancels exactly: ``rfft2(irfft_last(g)) == rfft2_from_last_spectrum(g)``.
    """
    return jnp.fft.fft(g, axis=-2)


def irfft2(xf: jnp.ndarray, shape: tuple[int, int]) -> jnp.ndarray:
    """Inverse of :func:`rfft2` with explicit spatial ``shape=(H, W)``.

    Includes the ``1/N`` normalization of ``CorrelationFlow::IFFT``
    (/root/reference/src/correlation_flow.cc:65-77).
    """
    return jnp.fft.irfft2(xf, s=shape)


def rfft_last(x: jnp.ndarray) -> jnp.ndarray:
    """1D real FFT along the last axis (shear resamplers, ops.warp)."""
    return jnp.fft.rfft(x.astype(jnp.float32), axis=-1)


def irfft_last(xf: jnp.ndarray, n: int) -> jnp.ndarray:
    return jnp.fft.irfft(xf, n=n, axis=-1)


def rfft_ax2(x: jnp.ndarray) -> jnp.ndarray:
    """1D real FFT along axis -2 (column shears)."""
    return jnp.fft.rfft(x.astype(jnp.float32), axis=-2)


def irfft_ax2(xf: jnp.ndarray, n: int) -> jnp.ndarray:
    return jnp.fft.irfft(xf, n=n, axis=-2)


def spectral_crop(
    xf: jnp.ndarray, shape: tuple[int, int], scale: int
) -> jnp.ndarray:
    """Low-pass crop of an rfft2 half spectrum: the spectrum of the
    sinc-downsampled image at ``(H/scale, W/scale)``, scaled by
    ``1/scale²`` so spatial values keep their magnitude.

    Rows kept: the ``Hs//2+1`` lowest positive and ``Hs//2-1`` highest
    (negative) frequencies; columns: the first ``Ws//2+1`` bins.  The
    coarse Nyquist row/column are zeroed (their full-spectrum mirrors are
    dropped by the crop, so keeping them would break Hermitian symmetry).
    Used by the coarse-to-fine loop search (core.loop_closure) — both
    sides of the coarse correlation go through THIS function, so the
    downsampling is consistent.  ``scale`` must divide both axes with
    even results.
    """
    h, w = shape
    hs, ws = h // scale, w // scale
    if hs * scale != h or ws * scale != w or hs % 2 or ws % 2:
        raise ValueError(f"spectral_crop: {h}x{w} not divisible into even {hs}x{ws}")
    ws2 = ws // 2 + 1
    top = xf[..., : hs // 2 + 1, :ws2]
    bot = xf[..., h - (hs // 2 - 1) :, :ws2]
    top = top.at[..., hs // 2, :].set(0)
    top = top.at[..., :, ws2 - 1].set(0)
    bot = bot.at[..., :, ws2 - 1].set(0)
    return jnp.concatenate([top, bot], axis=-2) * (1.0 / (scale * scale))


def fftshift2(x: jnp.ndarray) -> jnp.ndarray:
    """fftshift over the last two axes.

    Replaces the reference's Eigen expression-template ``fftshift``
    (/root/reference/include/circ_shift.h:238-252).
    """
    return jnp.fft.fftshift(x, axes=(-2, -1))


def impulse_spectrum_pair(h: int, w: int) -> np.ndarray:
    """Float-pair spectrum of a centered unit impulse — the KCC target ``g``.

    Matches ``CorrelationFlow::GetTargetFFT`` (/root/reference/src/
    correlation_flow.cc:46-51): a delta at ``(h//2, w//2)``.  Computed in
    closed form on the host — the DFT of ``delta[h//2, w//2]`` is
    ``exp(-2πi (k·h/2/H + l·w/2/W))`` restricted to the stored half
    spectrum — and returned as a host ``(h, w//2+1, 2)`` float array, so
    engine construction dispatches no eager FFT.
    """
    ky = np.arange(h)
    kx = np.arange(w // 2 + 1)
    phase = -2.0 * math.pi * (
        ky[:, None] * ((h // 2) / h) + kx[None, :] * ((w // 2) / w)
    )
    return np.stack(
        [np.cos(phase), np.sin(phase)], axis=-1
    ).astype(np.float32)


def impulse_spectrum(h: int, w: int) -> jnp.ndarray:
    """Complex view of :func:`impulse_spectrum_pair` (CPU/test convenience —
    materializes complex64 on the default device)."""
    return r2c(jnp.asarray(impulse_spectrum_pair(h, w)))
