"""Spectral kernels vs scipy golden models.

Mirrors the reference's numerical conventions (signal_features.py:80-454,
2069-2185): per-taper periodogram averaged over DPSS tapers, scipy Welch
defaults, 2/n-normalised amplitude spectrum.
"""
import numpy as np
import pytest
import scipy.signal

from mba_tpu.ops.dpss import dpss_windows, filtered_tapers
from mba_tpu.ops.spectral import (multitaper_psd, welch_psd, spectral_snr,
                                  amplitude_spectrum)


def _synthetic(fs=256, seconds=8, n_ch=3, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    x = np.stack([
        np.sin(2 * np.pi * 21.5 * t) + 0.5 * rng.standard_normal(len(t))
        for _ in range(n_ch)], axis=1)
    return x.astype(np.float64)


class TestDpss:
    def test_matches_scipy(self):
        for n, nw, k in [(256, 3, 5), (512, 4, 7), (100, 2.5, 4)]:
            ours = dpss_windows(n, nw, k)
            ref = scipy.signal.windows.dpss(M=n, NW=nw, Kmax=k)
            ref = ref / np.sqrt((ref ** 2).sum(axis=1, keepdims=True))
            for i in range(k):
                # sign is a convention; compare up to sign
                d = min(np.abs(ours[i] - ref[i]).max(),
                        np.abs(ours[i] + ref[i]).max())
                assert d < 1e-8, f"taper {i} mismatch (n={n}, nw={nw})"

    def test_eigenvalue_ratios_match_scipy(self):
        _, ratios = dpss_windows(256, 3, 5, return_ratios=True)
        _, ref_ratios = scipy.signal.windows.dpss(M=256, NW=3, Kmax=5,
                                                  return_ratios=True)
        np.testing.assert_allclose(ratios, ref_ratios, atol=1e-7)

    def test_filtered_tapers_threshold(self):
        tapers = filtered_tapers(512, nw=3, eigenvalue_threshold=0.9)
        _, ratios = scipy.signal.windows.dpss(M=512, NW=3, Kmax=5,
                                              return_ratios=True)
        assert tapers.shape[0] == int((ratios > 0.9).sum())
        np.testing.assert_allclose((tapers ** 2).sum(axis=1), 1.0, atol=1e-9)


def _reference_mt_psd(x, fs, nw, window_length_sec, overlap_frac, log_scale):
    """Golden model of reference signal_features.py:385-437 in plain scipy."""
    n_samples, n_channels = x.shape
    ws = int(window_length_sec * fs)
    hop = int(ws * (1 - overlap_frac))
    k = int(2 * nw - 1)
    tapers = scipy.signal.windows.dpss(M=ws, NW=nw, Kmax=k)
    starts = np.arange(0, n_samples - ws, hop)
    specs = []
    for ch in range(n_channels):
        windows = np.array([x[s:s + ws, ch] for s in starts])
        psd_list = []
        for taper in tapers:
            freqs, pxx = scipy.signal.periodogram(
                windows * taper[None, :], fs=fs, axis=1, window=None)
            psd_list.append(pxx)
        specs.append(np.mean(psd_list, axis=0))
    specs = np.transpose(np.array(specs), [1, 2, 0])
    if log_scale:
        specs = np.log10(np.abs(specs) + 1e-10)
    times = (starts + ws / 2) / fs
    return specs, times, freqs


class TestMultitaperPsd:
    @pytest.mark.parametrize("log_scale", [False, True])
    def test_matches_reference_formula(self, log_scale):
        x = _synthetic()
        fs = 256
        ours, t_ours, f_ours = multitaper_psd(
            x, fs, nw=3, window_length_sec=0.5, overlap_frac=0.5, axis=0,
            apply_log_scale=log_scale)
        ref, t_ref, f_ref = _reference_mt_psd(
            x, fs, 3, 0.5, 0.5, log_scale)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(t_ours, t_ref)
        np.testing.assert_allclose(f_ours, f_ref)
        atol = 2e-3 if log_scale else 1e-6
        np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=atol)

    def test_transposed_input(self):
        x = _synthetic()
        a = multitaper_psd(x, 256, axis=0, window_length_sec=0.5,
                           apply_log_scale=False)[0]
        b = multitaper_psd(x.T, 256, axis=1, window_length_sec=0.5,
                           apply_log_scale=False)[0]
        np.testing.assert_allclose(a, b)

    def test_chunking_invariance(self):
        x = _synthetic(seconds=4)
        a = multitaper_psd(x, 256, axis=0, window_length_sec=0.5,
                           apply_log_scale=False, window_chunk=3)[0]
        b = multitaper_psd(x, 256, axis=0, window_length_sec=0.5,
                           apply_log_scale=False, window_chunk=128)[0]
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


    def test_study_window_length_matches_reference(self):
        """1-s windows at 2048 Hz (n = 2048), the study's PSD setting."""
        x = _synthetic(fs=2048, seconds=4, n_ch=2)
        ours = multitaper_psd(x, 2048, nw=3, window_length_sec=1.0,
                              overlap_frac=0.5, axis=0,
                              apply_log_scale=False)[0]
        ref = _reference_mt_psd(x, 2048, 3, 1.0, 0.5, False)[0]
        np.testing.assert_allclose(ours, ref, rtol=2e-4,
                                   atol=1e-5 * np.abs(ref).max())


class TestWelch:
    def test_matches_scipy(self):
        x = _synthetic()
        fs = 256
        f_ours, p_ours = welch_psd(x, fs, nperseg=fs * 4)
        f_ref, p_ref = scipy.signal.welch(x, fs=fs, nperseg=fs * 4, axis=0)
        np.testing.assert_allclose(f_ours, f_ref)
        np.testing.assert_allclose(p_ours, p_ref, rtol=5e-4, atol=1e-8)

    def test_snr_scale_invariance(self):
        # reference test pattern: SNR unchanged under amplitude scaling
        x = _synthetic(n_ch=1)
        snr1 = spectral_snr(x, 256)
        snr2 = spectral_snr(x * 7.3, 256)
        assert abs(snr1 - snr2) < 1e-3
        assert snr1 > 3.0  # 21.5 Hz tone must be detected


class TestAmplitudeSpectrum:
    def test_sine_amplitude(self):
        fs = 128
        t = np.arange(fs * 4) / fs
        x = 2.5 * np.sin(2 * np.pi * 16 * t)
        amp, freqs = amplitude_spectrum(x, fs)
        peak = freqs[np.argmax(amp[:, 0])]
        assert peak == pytest.approx(16.0, abs=0.3)
        assert amp.max() == pytest.approx(2.5, rel=1e-3)


class TestDeviceOutput:
    def test_psd_device_output_matches_host(self):
        import jax
        rng = np.random.default_rng(0)
        x = rng.standard_normal((1024, 3)).astype(np.float32)
        host, tc_h, fr_h = multitaper_psd(x, 256.0, axis=0)
        dev, tc_d, fr_d = multitaper_psd(x, 256.0, axis=0,
                                         device_output=True)
        assert isinstance(dev, jax.Array)
        np.testing.assert_allclose(np.asarray(dev), host, rtol=1e-6)
        np.testing.assert_allclose(tc_d, tc_h)
