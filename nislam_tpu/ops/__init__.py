"""Compute-path primitives: FFTs, warps, and KCC registration."""

from nislam_tpu.ops.fft import (  # noqa: F401
    fftshift2,
    impulse_spectrum,
    irfft2,
    rfft2,
)
from nislam_tpu.ops.warp import (  # noqa: F401
    bilinear_sample,
    polar_grid,
    rotate_wrap,
    warp_polar,
    warp_translate_rotate,
)
from nislam_tpu.ops.registration import (  # noqa: F401
    CFOps,
    compute_intermedium,
    compute_pose,
    estimate_trans,
    make_cf_ops,
    psr,
    remove_zero_component,
)
