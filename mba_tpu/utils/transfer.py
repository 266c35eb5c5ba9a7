"""Bandwidth-compressed device→host downloads.

A study-scale f32 result tensor (a 28-min 64-ch log-PSD spectrogram is
~0.9 GB) costs host↔device bandwidth to download.  Whether that cost
matters on a given host link is measured per cell (ROADMAP speed item 6);
these transfers stay as user options.

:func:`download_quantized` halves (int16) or quarters (int8) those
bytes: the tensor is affinely quantized **on device** per channel
(lane-wise min/max, one fused jitted program), the integer payload plus
two tiny f32 scale/offset vectors are downloaded, and the host
dequantizes back to float32.  Per-channel worst-case error is
``(max−min)/(2^bits − 1)`` — for log10-scaled PSD (range ≈ 30 log
units) int16 gives ≤ 5e-4 log units ≈ 0.1 % linear power, far below
inter-window statistical noise; for coherence values in [0, 1] the
error is ≤ 1.6e-5.

:func:`upload_quantized` is the value-preserving upload-side mirror:
per-channel peak int16/int8 on the host (native SIMD quantizer from
``mba_tpu/native``), integer payload over the host link, and an on-device
dequant multiply that restores the original units (unlike the
scale-cancelling MSC transfer legs in cohort_null.py, the restored
values feed stages with absolute thresholds — e.g. the preprocessor's
3 mV amplitude annotation — so the scales ride along).  Rounding error
is ≤ 2^-15 (int16) of each channel's peak.  No reference counterpart:
the reference (`src/pipeline/signal_features.py:1033-1100`) saves f32
arrays from host RAM and never transfers to a device.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


_INT_INFO = {
    np.dtype(np.int16): (np.int16, 65535.0),
    np.dtype(np.int8): (np.int8, 255.0),
}


@functools.partial(jax.jit,
                   static_argnames=("int_dtype", "levels", "lane_ndim"))
def _quantize_on_device(x, int_dtype, levels, lane_ndim=1):
    """Affine per-lane quantization over the leading axes.

    x : (..., C) float array — statistics are taken over all axes but
    the trailing ``lane_ndim``, so each trailing lane (channel, or
    (freq, channel) cell at ``lane_ndim=2``) gets its own scale/offset
    and one pathological lane cannot destroy the precision of the
    others.  Finer lanes shrink the per-lane span — e.g. a log-PSD
    spectrogram's per-channel span is ~10 log units but its
    per-(freq, channel) span over windows is ~1-3, which is what makes
    the int8 payload (quarter bytes) usable for artifacts.
    """
    xf = x.astype(jnp.float32)
    reduce_axes = tuple(range(xf.ndim - lane_ndim))
    lo = jnp.min(xf, axis=reduce_axes)
    hi = jnp.max(xf, axis=reduce_axes)
    span = jnp.maximum(hi - lo, jnp.finfo(jnp.float32).tiny)
    scale = span / levels
    half = (levels + 1.0) / 2.0           # 32768 (int16) / 128 (int8)
    q = jnp.round((xf - lo) / scale - half)
    q = jnp.clip(q, -half, half - 1.0).astype(int_dtype)
    return q, scale, lo


def download_quantized(x_dev, transfer_dtype=np.int16, lane_ndim: int = 1):
    """Download a float device array as per-lane-quantized integers.

    Returns ``(host_f32, n_bytes_downloaded, max_abs_err_bound)`` where
    ``host_f32`` is the dequantized float32 array with the same shape as
    ``x_dev``, ``n_bytes_downloaded`` counts the integer payload plus
    the scale/offset sidecars, and ``max_abs_err_bound`` is the
    worst-case per-element absolute error (half a quantization step,
    maxed over lanes; exact-arithmetic bound — f32 rounding in the
    quantize/dequantize chain can add a few percent of a step on top).

    ``lane_ndim`` trailing axes form the lane grid; min/max reduce over
    the leading axes only.  ``lane_ndim=1`` (default) matches the
    ``(n_windows, n_freqs, n_channels)`` spectrogram layout with one
    scale per channel; ``lane_ndim=x_dev.ndim-1`` reduces over the
    window axis only — per-(freq, channel) scales cost a sidecar of
    ``2·F·C`` floats (~0.5 MB at study scale, vs a ~0.9 GB payload) and
    cut the per-lane span ~5×, which is what makes the int8 payload
    accurate enough for saved artifacts (measured ≤ ~0.004 log10 units
    ≈ 1 % linear power worst case on a study-scale log-PSD, vs ~4 %
    with per-channel lanes).  Pass ``transfer_dtype=None`` to fall
    through to a plain f32 download (same return contract) so callers
    can keep one code path.
    """
    if transfer_dtype is None:
        host = np.asarray(x_dev, dtype=np.float32)
        return host, host.nbytes, 0.0
    td = np.dtype(transfer_dtype)
    if td not in _INT_INFO:
        raise ValueError(f"transfer_dtype must be int16/int8/None, got {td}")
    if lane_ndim < 1:
        raise ValueError(f"lane_ndim must be >= 1, got {lane_ndim}")
    if lane_ndim >= np.ndim(x_dev):
        raise ValueError(
            f"lane_ndim={lane_ndim} must be < array ndim "
            f"{np.ndim(x_dev)} (at least one axis must reduce)")
    int_dtype, levels = _INT_INFO[td]
    q, scale, lo = _quantize_on_device(jnp.asarray(x_dev), int_dtype, levels,
                                       lane_ndim)
    # one bulk integer download + two tiny vectors
    q_host = np.asarray(q)
    scale_host = np.asarray(scale)
    lo_host = np.asarray(lo)
    n_bytes = q_host.nbytes + scale_host.nbytes + lo_host.nbytes
    half = (levels + 1.0) / 2.0
    host = (q_host.astype(np.float32) + np.float32(half)) * scale_host \
        + lo_host
    err_bound = 0.5 * float(scale_host.max())
    return host, n_bytes, err_bound


@jax.jit
def _dequant_on_device(q, scale):
    return q.astype(jnp.float32) * scale


def upload_quantized(x: np.ndarray, transfer_dtype=np.int16):
    """Upload a host float array as per-channel peak-scaled integers.

    Returns ``(x_dev_f32, n_bytes_uploaded, max_abs_err_bound)`` where
    ``x_dev_f32`` is a device ``jax.Array`` restored to the input's
    units (the per-channel scales upload alongside and the dequant
    multiply runs on device), ``n_bytes_uploaded`` counts the integer
    payload plus the scale sidecar, and ``max_abs_err_bound`` is half a
    quantization step (≤ 2^-16 of the channel peak for int16), maxed
    over channels.

    Layout: ``(..., n_samples, n_channels)`` — per-(leading-dims,
    channel) peaks, matching the native quantizer.  Symmetric peak
    scaling (not affine) because biosignals are zero-centred; it keeps
    the native SIMD path bit-compatible.  ``transfer_dtype=None``
    falls through to a plain f32 ``device_put``.
    """
    x = np.asarray(x)
    if transfer_dtype is None:
        x = x.astype(np.float32, copy=False)
        return jnp.asarray(x), x.nbytes, 0.0
    if np.issubdtype(x.dtype, np.integer):
        raise TypeError(
            "upload_quantized expects float data; integer ADC counts "
            "should go through upload_counts (exact, no re-quantization)")
    td = np.dtype(transfer_dtype)
    if td not in _INT_INFO:
        raise ValueError(f"transfer_dtype must be int16/int8/None, got {td}")
    full = 32767.0 if td == np.dtype(np.int16) else 127.0
    from mba_tpu.native import (quantize_int16_per_channel,
                                quantize_int8_per_channel)
    quant = (quantize_int16_per_channel if td == np.dtype(np.int16)
             else quantize_int8_per_channel)
    xf = np.ascontiguousarray(x, dtype=np.float32)
    peak = np.maximum(np.abs(xf).max(axis=-2, keepdims=True),
                      np.float32(1e-30)).astype(np.float32)
    q = quant(xf)
    scale = peak / np.float32(full)
    x_dev = _dequant_on_device(jnp.asarray(q), jnp.asarray(scale))
    n_bytes = q.nbytes + scale.nbytes
    # round-half-even ⇒ ≤ half a step; steps are peak/full per channel
    err_bound = 0.5 * float(scale.max())
    return x_dev, n_bytes, err_bound


def upload_counts(counts: np.ndarray, scale) -> tuple[jax.Array, int]:
    """Upload integer ADC counts verbatim and scale to float ON DEVICE.

    The EXACT transfer leg for data that is born integer — OTB4 ``.sig``
    streams are int16/int32 ADC counts (io/otb4.py,
    reference otb_file_handling.py:337-425) — so unlike
    :func:`upload_quantized` there is no quantization step and no error
    bound: ``result == counts * scale`` in float32, bit-exact.

    counts : integer array, channels on the trailing axis (any leading
        shape; a C-contiguous ``(n_samples, n_channels)`` view of the
        tar member bytes uploads with zero host copies).  NOTE:
        ``read_otb4(raw_counts=True)`` returns channel-major
        ``(n_channels, n_samples)`` — pass ``counts.T`` here, e.g.
        ``upload_counts(counts.T, mv_per_count)``.
    scale : scalar or broadcastable array (e.g. the per-channel
        ``mv_per_count`` factors from ``read_otb4(raw_counts=True)``,
        times 1e-3 for volts).  A 1-D per-channel ``scale`` must match
        ``counts.shape[-1]`` — enforced, because a transposed ``counts``
        would otherwise broadcast silently over the wrong (sample) axis
        whenever the sample count happens to match.

    Returns ``(x_dev_f32, n_bytes_uploaded)``.
    """
    counts = np.asarray(counts)
    if not np.issubdtype(counts.dtype, np.integer):
        raise TypeError(f"counts must be integer, got {counts.dtype}")
    scale = np.asarray(scale, np.float32)
    if scale.ndim == 1 and scale.shape[0] != 1 \
            and scale.shape[0] != counts.shape[-1]:
        raise ValueError(
            f"per-channel scale has {scale.shape[0]} entries but the "
            f"trailing (channel) axis of counts is {counts.shape[-1]}; "
            f"read_otb4 output is channel-major — pass counts.T")
    x_dev = _dequant_on_device(jnp.asarray(counts), jnp.asarray(scale))
    return x_dev, counts.nbytes + scale.nbytes
