"""Jitted device compute kernels (the reference's scipy/numpy hot loops).

Everything in this package is shape-static, functional JAX intended to run
under ``jax.jit`` / ``vmap`` / ``pjit``.  Host-side precomputation (taper
design, FIR design, window grids) lives in plain numpy and is constant-folded
into the compiled kernels.
"""
from mba_tpu.ops.dpss import dpss_windows  # noqa: F401
from mba_tpu.ops.framing import (  # noqa: F401
    frame_signal, window_grid, resample_linear,
)
from mba_tpu.ops.spectral import (  # noqa: F401
    multitaper_psd, welch_psd, spectral_snr, amplitude_spectrum,
)
from mba_tpu.ops.coherence import (  # noqa: F401
    multitaper_msc, fisher_atanh, inverse_fisher_atanh,
    cmc_independence_threshold,
)
