"""Multitaper / Welch spectral estimation as jitted device kernels.

Numerical parity targets (float32 tolerance):

- ``multitaper_psd``  ↔ reference signal_features.py:80-454 — DPSS tapers
  (k = 2·nw − 1), sliding windows, per-taper periodogram averaged over
  tapers, output (n_windows, n_freqs, n_channels), optional log10.
- ``welch_psd``       ↔ scipy.signal.welch defaults (hann window, 50 %
  overlap, constant detrend), used by the reference for SNR validation
  (preprocessing.py:1113-1155, signal_features.py:2069-2130).
- ``spectral_snr``    ↔ reference signal_features.py:2069-2130.
- ``amplitude_spectrum`` ↔ reference signal_features.py:2133-2185.

Design: windows are a batch axis (one gather), tapering is a broadcast
multiply fused by XLA into the rFFT pipeline, and the taper average is a
small contraction.  Long recordings are processed in fixed-size window
chunks via ``lax.map`` so peak memory stays bounded while every chunk is a
single fused XLA program.
"""
from __future__ import annotations

import functools
from typing import Literal

import numpy as np
import jax
import jax.numpy as jnp

from mba_tpu.ops.dpss import dpss_windows
from mba_tpu.ops.framing import frame_signal, window_grid


def _chunked_map(fn, xs, chunk: int):
    """Apply ``fn`` over the leading axis of each array in ``xs`` in chunks.

    Pads the leading axis up to a multiple of ``chunk`` (results for padded
    rows are discarded), reshapes to (n_chunks, chunk, ...) and scans with
    ``lax.map`` so the compiled program is independent of the number of
    windows.
    """
    n = xs[0].shape[0]
    n_pad = (-n) % chunk
    padded = [jnp.pad(x, [(0, n_pad)] + [(0, 0)] * (x.ndim - 1)) for x in xs]
    stacked = [x.reshape((-1, chunk) + x.shape[1:]) for x in padded]
    out = jax.lax.map(lambda args: fn(*args), tuple(stacked))
    out = jax.tree_util.tree_map(
        lambda o: o.reshape((-1,) + o.shape[2:])[:n], out)
    return out


def _onesided_scale(n_freqs: int, window_samples: int) -> np.ndarray:
    """Periodogram one-sided doubling: x2 everywhere except DC (and Nyquist
    when the window length is even), matching scipy.signal.periodogram."""
    scale = np.full(n_freqs, 2.0, dtype=np.float32)
    scale[0] = 1.0
    if window_samples % 2 == 0:
        scale[-1] = 1.0
    return scale


@functools.partial(jax.jit, static_argnames=("apply_log_scale",))
def _mt_psd_kernel(frames, tapers, onesided, inv_fs_n, apply_log_scale):
    """(chunk, S, C) frames → (chunk, F, C) taper-averaged PSD."""
    # (chunk, K, S, C): taper broadcast; XLA fuses this into the FFT input
    tapered = frames[:, None, :, :] * tapers[None, :, :, None]
    # scipy.signal.periodogram detrends (constant) by default and the
    # reference does not override it (signal_features.py:419) — match that.
    tapered = tapered - tapered.mean(axis=2, keepdims=True)
    fft = jnp.fft.rfft(tapered, axis=2)
    pxx = (fft.real ** 2 + fft.imag ** 2) * inv_fs_n
    pxx = pxx * onesided[None, None, :, None]
    pxx = pxx.mean(axis=1)  # average over tapers → (chunk, F, C)
    if apply_log_scale:
        pxx = jnp.log10(jnp.abs(pxx) + 1e-10)
    return pxx


def multitaper_psd(input_array,
                   sampling_freq: float,
                   nw: float = 3,
                   window_length_sec: float = 1.0,
                   overlap_frac: float = 0.5,
                   axis: Literal[0, 1] | None = None,
                   apply_log_scale: bool = True,
                   window_chunk: int = 128,
                   device_output: bool = False,
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sliding-window DPSS multitaper PSD.

    Returns ``(spectrograms, time_centers, freqs)`` with
    ``spectrograms.shape == (n_windows, n_freqs, n_channels)`` exactly as the
    reference (signal_features.py:433).

    ``device_output=True`` leaves the spectrogram on the accelerator as a
    ``jax.Array`` (time_centers/freqs stay host numpy) — at study scale
    the (windows, freqs, channels) tensor is ~0.9 GB, so consumers that
    reduce on device (band power, task masks) should not pay the
    host download.
    """
    x = jnp.asarray(input_array, dtype=jnp.float32)
    if x.ndim == 1:
        x = x[:, None]
        axis = 0
    elif axis is None:
        raise AttributeError("For 2D signal arrays, axis needs to be defined!")
    if axis == 1:
        x = x.T

    n_samples = x.shape[0]
    window_samples = int(window_length_sec * sampling_freq)
    hop_samples = int(window_samples * (1 - overlap_frac))
    k = int(2 * nw - 1)

    tapers = jnp.asarray(dpss_windows(window_samples, nw, k),
                         dtype=jnp.float32)
    starts, time_centers = window_grid(n_samples, window_samples, hop_samples,
                                       sampling_freq, convention="psd")
    freqs = np.fft.rfftfreq(window_samples, d=1.0 / sampling_freq)
    onesided = jnp.asarray(_onesided_scale(len(freqs), window_samples))
    inv_fs_n = np.float32(1.0 / (sampling_freq * window_samples))

    frames = frame_signal(x, starts, window_samples)
    spectrograms = _chunked_map(
        lambda f: _mt_psd_kernel(f, tapers, onesided, inv_fs_n,
                                 apply_log_scale),
        [frames], chunk=min(window_chunk, max(1, frames.shape[0])))
    if device_output:
        return spectrograms, time_centers, freqs
    return np.asarray(spectrograms), time_centers, freqs


@functools.partial(jax.jit, static_argnames=("nperseg", "noverlap"))
def _welch_kernel(x, win, nperseg, noverlap, inv_fs_wsq, onesided):
    hop = nperseg - noverlap
    n_seg = (x.shape[0] - nperseg) // hop + 1
    starts = jnp.arange(n_seg, dtype=jnp.int32) * hop
    idx = starts[:, None] + jnp.arange(nperseg, dtype=jnp.int32)[None, :]
    segs = x[idx]                                   # (n_seg, nperseg, C)
    segs = segs - segs.mean(axis=1, keepdims=True)  # detrend='constant'
    fft = jnp.fft.rfft(segs * win[None, :, None], axis=1)
    pxx = (fft.real ** 2 + fft.imag ** 2) * inv_fs_wsq
    pxx = pxx * onesided[None, :, None]
    return pxx.mean(axis=0)                          # (F, C)


def welch_psd(input_array, sampling_freq: float, nperseg: int,
              axis: Literal[0, 1] = 0
              ) -> tuple[np.ndarray, np.ndarray]:
    """Welch PSD with scipy defaults (hann, 50 % overlap, constant detrend).

    Returns (freqs, psd) with psd shaped (n_freqs, n_channels).
    """
    x = jnp.asarray(input_array, dtype=jnp.float32)
    if x.ndim == 1:
        x = x[:, None]
    elif axis == 1:
        x = x.T
    nperseg = int(min(nperseg, x.shape[0]))
    noverlap = nperseg // 2

    # periodic hann window, as scipy.signal.get_window('hann', n)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nperseg) / nperseg)
    win = win.astype(np.float32)
    inv_fs_wsq = np.float32(1.0 / (sampling_freq * (win ** 2).sum()))
    onesided = jnp.asarray(_onesided_scale(nperseg // 2 + 1, nperseg))
    freqs = np.fft.rfftfreq(nperseg, d=1.0 / sampling_freq)

    psd = _welch_kernel(x, jnp.asarray(win), nperseg, noverlap, inv_fs_wsq,
                        onesided)
    return freqs, np.asarray(psd)


def spectral_snr(input_array, sampling_freq: float,
                 target_freq: float = 21.5, freq_window: float = 8.5,
                 target_band_ratio: float = 0.5,
                 axis: Literal[0, 1] = 0,
                 return_psd: bool = False):
    """Spectral SNR (dB) at a target frequency using Welch 4-s segments.

    Parity: reference signal_features.py:2069-2130 (target band = mean power
    in ±freq_window·ratio around target; noise band = ±freq_window).
    """
    freqs, psd = welch_psd(input_array, sampling_freq,
                           nperseg=int(sampling_freq * 4), axis=axis)
    target_freq_window = freq_window * target_band_ratio
    target_band = ((freqs < target_freq + target_freq_window)
                   & (freqs > target_freq - target_freq_window))
    noise_band = ((freqs >= target_freq - freq_window)
                  & (freqs <= target_freq + freq_window))
    snr_linear = psd[target_band].mean() / psd[noise_band].mean()
    snr_db = float(10 * np.log10(snr_linear))
    return snr_db if not return_psd else (snr_db, freqs, psd)


def amplitude_spectrum(input_array, sampling_freq: float,
                       axis: Literal[0, 1] = 0
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Positive-frequency DFT amplitude, normalised by 2/n.

    Parity: reference signal_features.py:2133-2185.
    """
    x = jnp.asarray(input_array, dtype=jnp.float32)
    if x.ndim == 1:
        x = x[:, None]
        axis = 0
    n_samples = x.shape[axis]
    fft = jnp.fft.fft(x, axis=axis)
    freqs = np.fft.fftfreq(n_samples, d=1.0 / sampling_freq)
    pos = freqs >= 0
    fft_pos = fft[pos, :] if axis == 0 else fft[:, pos]
    amp = np.asarray(jnp.abs(fft_pos) * (2.0 / n_samples))
    return amp, freqs[pos]
