"""Zero-phase FIR band-pass / notch filtering as jitted overlap-save kernels.

The reference delegates filtering to MNE (preprocessing.py:581-599,946-958):
zero-phase FIR ``firwin`` band-pass with modality-specific auto bands and a
harmonic notch bank.  MNE is not a dependency here — the same design rules
are implemented directly:

- transition bandwidths (MNE 'auto'): ``l_trans = min(max(0.25·l_freq, 2),
  l_freq)``, ``h_trans = min(max(0.25·h_freq, 2), fs/2 − h_freq)``;
- filter length (hamming): ``3.3 / min(trans) · fs``, forced odd;
- firwin (hamming) with −6 dB points at the transition-band midpoints;
- zero-phase single-pass application of the linear-phase kernel with
  'reflect_limited' edge padding (MNE's default pad mode);
- notch bank: band-stop firwin at ``notch_freq·i, i=1..harmonics`` with
  MNE's default notch width ``freq/200`` and 1 Hz transitions.

Application is FFT overlap-save under ``lax.scan`` — static shapes, bounded
HBM, one compiled program regardless of recording length.
"""
from __future__ import annotations

import functools

import numpy as np
import scipy.signal
import jax
import jax.numpy as jnp


# --------------------------------------------------------------------------
# Host-side FIR design (constant-folded into the kernels)
# --------------------------------------------------------------------------
def _auto_trans(edge_freq: float, other_limit: float) -> float:
    return min(max(edge_freq * 0.25, 2.0), other_limit)


def design_bandpass_fir(sampling_freq: float,
                        l_freq: float | None,
                        h_freq: float | None,
                        filter_length: int | None = None) -> np.ndarray:
    """Hamming-window FIR band-pass following MNE's 'firwin' auto rules."""
    nyq = sampling_freq / 2.0
    if h_freq is not None and h_freq >= nyq:
        h_freq = None  # low-pass edge at/above Nyquist → no high cut
    trans = []
    cutoffs = []
    pass_zero = True
    if l_freq is not None and l_freq > 0:
        l_trans = _auto_trans(l_freq, l_freq)
        trans.append(l_trans)
        cutoffs.append(l_freq - l_trans / 2)
        pass_zero = False
    if h_freq is not None and h_freq < nyq:
        h_trans = _auto_trans(h_freq, nyq - h_freq)
        trans.append(h_trans)
        cutoffs.append(h_freq + h_trans / 2)
    if not cutoffs:
        return np.array([1.0])
    if filter_length is None:
        filter_length = int(round(3.3 / min(trans) * sampling_freq))
    filter_length += (filter_length % 2 == 0)  # force odd (type-I FIR)
    if len(cutoffs) == 2:
        h = scipy.signal.firwin(filter_length, cutoffs, window='hamming',
                                pass_zero=False, fs=sampling_freq)
    elif pass_zero:  # lowpass
        h = scipy.signal.firwin(filter_length, cutoffs, window='hamming',
                                pass_zero=True, fs=sampling_freq)
    else:  # highpass
        h = scipy.signal.firwin(filter_length, cutoffs, window='hamming',
                                pass_zero=False, fs=sampling_freq)
    return h.astype(np.float64)


def design_notch_fir(sampling_freq: float, freqs,
                     notch_widths=None,
                     trans_bandwidth: float = 1.0) -> np.ndarray:
    """Multi-band-stop FIR (the harmonic notch bank).

    Mirrors MNE notch defaults: width = freq/200, 1 Hz transitions
    (preprocessing.py:946-958 filters ``notch_frequency·i, i=1..harmonics``).
    """
    freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
    nyq = sampling_freq / 2.0
    in_range = freqs < nyq - trans_bandwidth
    if not in_range.all():
        dropped = freqs[~in_range]
        print(f"[notch design] dropping frequencies at/above Nyquist "
              f"({nyq:g} Hz): {dropped.tolist()}")
    freqs = freqs[in_range]
    if freqs.size == 0:
        return np.array([1.0])
    if notch_widths is None:
        notch_widths = freqs / 200.0
    else:
        notch_widths = np.broadcast_to(
            np.atleast_1d(np.asarray(notch_widths, float)),
            freqs.shape).copy()
    filter_length = int(round(3.3 / trans_bandwidth * sampling_freq))
    filter_length += (filter_length % 2 == 0)
    cutoffs = []
    for f, w in zip(freqs, notch_widths):
        cutoffs.extend([f - w / 2 - trans_bandwidth / 2,
                        f + w / 2 + trans_bandwidth / 2])
    h = scipy.signal.firwin(filter_length, cutoffs, window='hamming',
                            pass_zero=True, fs=sampling_freq)
    return h.astype(np.float64)


# --------------------------------------------------------------------------
# Jitted zero-phase application (overlap-save)
# --------------------------------------------------------------------------
def _reflect_limited_pad(x: jnp.ndarray, pad: int) -> jnp.ndarray:
    """MNE 'reflect_limited': 2·edge − reflected interior, zeros beyond."""
    n = x.shape[0]
    k = min(pad, n - 1)
    left = 2 * x[0:1] - x[1:k + 1][::-1]
    right = 2 * x[-1:] - x[-k - 1:-1][::-1]
    parts = [left, x, right]
    if k < pad:
        zshape = (pad - k,) + x.shape[1:]
        parts = [jnp.zeros(zshape, x.dtype), left, x, right,
                 jnp.zeros(zshape, x.dtype)]
    return jnp.concatenate(parts, axis=0)


@functools.partial(jax.jit, static_argnames=("n_taps_m1", "chunk", "n_out"))
def _overlap_save(x_padded, h_fft_re, h_fft_im, n_taps_m1, chunk, n_out):
    """FFT overlap-save convolution, valid part only.

    x_padded: (n_out + n_taps_m1, C) — signal pre-padded left by the filter
    group delay context; the kernel rfft arrives as separate real/imag
    arrays because complex host→device transfers are unimplemented on the
    device backend.  Returns (n_out, C).
    """
    h_fft = jax.lax.complex(h_fft_re, h_fft_im)
    nfft = chunk + n_taps_m1
    n_chunks = -(-n_out // chunk)
    total = n_chunks * chunk + n_taps_m1
    x_padded = jnp.pad(x_padded,
                       [(0, total - x_padded.shape[0])] + [(0, 0)])

    def body(_, i):
        seg = jax.lax.dynamic_slice_in_dim(x_padded, i * chunk, nfft, axis=0)
        y = jnp.fft.irfft(jnp.fft.rfft(seg, axis=0) * h_fft[:, None],
                          n=nfft, axis=0)
        return _, y[n_taps_m1:]

    _, ys = jax.lax.scan(body, None, jnp.arange(n_chunks))
    return ys.reshape((-1,) + x_padded.shape[1:])[:n_out]


def fir_filter(x, h: np.ndarray, zero_phase: bool = True,
               chunk: int = 1 << 16):
    """Apply FIR kernel ``h`` along axis 0 of (n_samples, n_channels).

    ``zero_phase`` centres the symmetric kernel (single-pass linear-phase
    compensation — MNE phase='zero') with reflect_limited edge padding.
    """
    x = jnp.asarray(x, jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n = x.shape[0]
    n_taps = len(h)
    if n_taps == 1:
        out = x * float(h[0])
        return out[:, 0] if squeeze else out

    half = (n_taps - 1) // 2
    if zero_phase:
        xp = _reflect_limited_pad(x, half)
        if n_taps % 2 == 0:
            xp = jnp.concatenate([xp, jnp.zeros((1,) + x.shape[1:],
                                                x.dtype)], axis=0)
    else:
        xp = jnp.concatenate([jnp.zeros((n_taps - 1,) + x.shape[1:],
                                        x.dtype), x], axis=0)

    # power-of-2 FFT sizes only (Bluestein sizes are slow/unsupported on
    # the device); make the FFT at least 4x the kernel so overlap-save is efficient
    nfft = 1 << int(np.ceil(np.log2(max(4 * n_taps, chunk, 2))))
    chunk = nfft - (n_taps - 1)
    h_fft = np.fft.rfft(h[::-1], n=nfft)
    # overlap-save computes correlation with reversed kernel = convolution
    out = _overlap_save(xp,
                        jnp.asarray(h_fft.real, jnp.float32),
                        jnp.asarray(h_fft.imag, jnp.float32),
                        n_taps - 1, chunk, n)
    return out[:, 0] if squeeze else out


def bandpass_filter(x, sampling_freq: float, l_freq: float | None,
                    h_freq: float | None, **kwargs):
    """Zero-phase FIR band-pass (MNE-equivalent defaults)."""
    h = design_bandpass_fir(sampling_freq, l_freq, h_freq)
    return fir_filter(x, h, zero_phase=True, **kwargs)


def notch_filter(x, sampling_freq: float, freqs, notch_widths=None,
                 **kwargs):
    """Zero-phase harmonic notch bank."""
    h = design_notch_fir(sampling_freq, freqs, notch_widths)
    return fir_filter(x, h, zero_phase=True, **kwargs)
