"""Coherence kernel vs an independent numpy golden model.

The golden model re-implements the mathematical contract of reference
signal_features.py:619-839 (window loop, taper accumulation of PSD/CSD,
MSC, leave-one-out jackknife with Fisher-z CIs) directly from the formulas.
"""
import numpy as np
import pytest
import scipy.signal
from scipy.stats import beta, t as t_dist

from mba_tpu.ops.coherence import (multitaper_msc, max_cmc_over_channels,
                                   cmc_independence_threshold)


def _golden_msc(eeg, emg, fs, nw=3, window_length_sec=1.0, overlap_frac=0.5,
                eig_thresh=0.9, jackknife_alpha=0.05, window_mask=None):
    """Plain numpy multitaper MSC + jackknife (formulas of the reference)."""
    n, n_eeg = eeg.shape
    _, n_emg = emg.shape
    ws = int(window_length_sec * fs)
    hop = int(ws * (1 - overlap_frac))
    k = int(2 * nw - 1)
    tapers, ratios = scipy.signal.windows.dpss(M=ws, NW=nw, Kmax=k,
                                               return_ratios=True)
    tapers = tapers[ratios > eig_thresh]
    tapers = tapers / np.sqrt((tapers ** 2).sum(axis=1, keepdims=True))
    K = len(tapers)
    n_windows = (n - ws) // hop + 1
    n_freqs = ws // 2 + 1
    scale = 1.0 / (fs * ws)

    coh = np.zeros((n_windows, n_freqs, n_eeg, n_emg))
    lo = np.zeros_like(coh)
    hi = np.zeros_like(coh)
    t_crit = t_dist.ppf(1 - jackknife_alpha / 2, K - 1)

    def fisher(c):
        c = np.clip(c, 1e-10, 1 - 1e-10)
        return 0.5 * np.log((1 + c) / (1 - c))

    for w in range(n_windows):
        if window_mask is not None and not window_mask[w]:
            continue
        s = w * hop
        ew, mw = eeg[s:s + ws], emg[s:s + ws]
        E = np.stack([np.fft.rfft(ew * tp[:, None], axis=0) for tp in tapers])
        M = np.stack([np.fft.rfft(mw * tp[:, None], axis=0) for tp in tapers])
        pe_k = np.abs(E) ** 2 * scale            # (K,F,E)
        pm_k = np.abs(M) ** 2 * scale
        cs_k = np.conj(E)[:, :, :, None] * M[:, :, None, :] * scale

        # leave-one-out replicates
        reps = np.zeros((K, n_freqs, n_eeg, n_emg))
        for j in range(K):
            keep = [i for i in range(K) if i != j]
            pe = pe_k[keep].mean(axis=0)
            pm = pm_k[keep].mean(axis=0)
            cs = cs_k[keep].mean(axis=0)
            num = np.abs(cs) ** 2
            den = np.maximum(pe[:, :, None] * pm[:, None, :],
                             np.finfo(np.float64).tiny)
            reps[j] = np.clip(num / den, 0, 1)
        cmean = np.clip(reps.mean(axis=0), 0, 1)
        z = fisher(reps)
        zv = (K - 1) / K * ((z - z.mean(axis=0)) ** 2).sum(axis=0)
        zc = fisher(cmean)
        lo_w = np.tanh(zc - t_crit * np.sqrt(zv)) ** 2
        hi_w = np.tanh(zc + t_crit * np.sqrt(zv)) ** 2
        coh[w] = cmean
        lo[w] = np.minimum(lo_w, cmean)
        hi[w] = np.maximum(hi_w, cmean)
    return coh, lo, hi


def _coupled_signals(fs=256, seconds=6, n_eeg=2, n_emg=3, seed=1):
    """EEG/EMG pairs with genuine 20 Hz coherence plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    shared = np.sin(2 * np.pi * 20 * t + rng.uniform(0, 2 * np.pi))
    eeg = np.stack([shared + 0.8 * rng.standard_normal(len(t))
                    for _ in range(n_eeg)], axis=1)
    emg = np.stack([shared + 0.8 * rng.standard_normal(len(t))
                    for _ in range(n_emg)], axis=1)
    return eeg, emg


class TestMultitaperMsc:
    def test_matches_golden_model(self):
        eeg, emg = _coupled_signals()
        res = multitaper_msc(eeg, emg, 256, window_length_sec=1.0,
                             use_jackknife=True)
        g_coh, g_lo, g_hi = _golden_msc(eeg, emg, 256)
        assert res["coherence_raw"].shape == g_coh.shape
        np.testing.assert_allclose(res["coherence_raw"], g_coh,
                                   rtol=1e-3, atol=2e-4)
        np.testing.assert_allclose(res["coherence_ci_lower"], g_lo,
                                   rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(res["coherence_ci_upper"], g_hi,
                                   rtol=1e-3, atol=2e-3)

    def test_study_window_length_matches_golden_model(self):
        """2-s windows at 2048 Hz (n = 4096), the study's CMC setting."""
        eeg, emg = _coupled_signals(fs=2048, seconds=4, n_eeg=2, n_emg=2)
        res = multitaper_msc(eeg, emg, 2048, window_length_sec=2.0,
                             use_jackknife=True,
                             apply_independence_threshold=False)
        g_coh, g_lo, g_hi = _golden_msc(eeg, emg, 2048,
                                        window_length_sec=2.0)
        np.testing.assert_allclose(res["coherence_raw"], g_coh, atol=1e-5)
        np.testing.assert_allclose(res["coherence_ci_lower"], g_lo,
                                   atol=5e-4)
        np.testing.assert_allclose(res["coherence_ci_upper"], g_hi,
                                   atol=5e-4)

    def test_detects_coupling_frequency(self):
        eeg, emg = _coupled_signals(seconds=10)
        res = multitaper_msc(eeg, emg, 256, window_length_sec=2.0,
                             use_jackknife=False,
                             apply_independence_threshold=False)
        spec = res["coherence_raw"].mean(axis=(0, 2, 3))
        peak_freq = res["freqs"][np.argmax(spec)]
        assert abs(peak_freq - 20.0) <= 1.0

    def test_ci_bounds_contain_mean(self):
        eeg, emg = _coupled_signals()
        res = multitaper_msc(eeg, emg, 256, use_jackknife=True)
        assert np.all(res["coherence_raw"] >= res["coherence_ci_lower"])
        assert np.all(res["coherence_raw"] <= res["coherence_ci_upper"])
        assert np.all(res["coherence_raw"] >= 0)
        assert np.all(res["coherence_raw"] <= 1)

    def test_window_mask_zeros_and_grid(self):
        eeg, emg = _coupled_signals()
        n = eeg.shape[0]
        ws, hop = 256, 128
        n_windows = (n - ws) // hop + 1
        mask = np.zeros(n_windows, dtype=bool)
        mask[3:7] = True
        res = multitaper_msc(eeg, emg, 256, window_length_sec=1.0,
                             window_mask=mask, use_jackknife=True)
        # masked-out windows are exact zeros; time grid fully populated
        assert np.all(res["coherence_raw"][~mask] == 0)
        assert np.any(res["coherence_raw"][mask] > 0)
        expected_tc = (np.arange(n_windows) * hop + ws / 2) / 256
        np.testing.assert_allclose(res["time_centers"], expected_tc)
        assert res["metadata"]["n_active_windows"] == 4

    def test_mask_shape_validation(self):
        eeg, emg = _coupled_signals()
        with pytest.raises(ValueError, match="window_mask"):
            multitaper_msc(eeg, emg, 256, window_mask=np.ones(3, dtype=bool))

    def test_sample_mismatch_raises(self):
        eeg, emg = _coupled_signals()
        with pytest.raises(ValueError, match="same number of samples"):
            multitaper_msc(eeg[:-10], emg, 256)

    def test_fused_emg_max_aggregation(self):
        eeg, emg = _coupled_signals()
        full = multitaper_msc(eeg, emg, 256, use_jackknife=True,
                              apply_independence_threshold=False)
        fused = multitaper_msc(eeg, emg, 256, use_jackknife=True,
                               aggregate_emg_max=True,
                               apply_independence_threshold=False)
        m, l, u = max_cmc_over_channels(full["coherence_raw"],
                                        full["coherence_ci_lower"],
                                        full["coherence_ci_upper"])
        np.testing.assert_allclose(fused["coherence_raw"], m, atol=1e-6)
        np.testing.assert_allclose(fused["coherence_ci_lower"], l, atol=1e-6)
        np.testing.assert_allclose(fused["coherence_ci_upper"], u, atol=1e-6)

    def test_chunking_invariance(self):
        eeg, emg = _coupled_signals(seconds=4)
        a = multitaper_msc(eeg, emg, 256, window_chunk=1)["coherence_raw"]
        b = multitaper_msc(eeg, emg, 256, window_chunk=64)["coherence_raw"]
        np.testing.assert_allclose(a, b, atol=1e-6)

    def test_independence_threshold(self):
        assert cmc_independence_threshold(5, 0.05) == pytest.approx(
            beta.ppf(0.95, 3, 3))
        eeg, emg = _coupled_signals()
        res = multitaper_msc(eeg, emg, 256, use_jackknife=False,
                             apply_independence_threshold=True,
                             significance_level=0.2)
        it = res["metadata"]["IT_unadjusted"]
        it02 = cmc_independence_threshold(res["metadata"]["K_tapers"], 0.2)
        np.testing.assert_allclose(
            res["coherence_significant"],
            res["coherence_raw"] > it02)
        assert it == pytest.approx(
            cmc_independence_threshold(res["metadata"]["K_tapers"], 0.2))


def _spectra_case(ws, nw, n_eeg, n_emg, n_win, seed):
    """Coupled frames + tapers for the epilogue parity cases."""
    from scipy.stats import t as t_dist
    from mba_tpu.ops.dpss import filtered_tapers
    rng = np.random.default_rng(seed)
    shared = rng.standard_normal((n_win, ws, 1))
    eegf = (0.3 * shared + rng.standard_normal((n_win, ws, n_eeg))
            ).astype(np.float32)
    emgf = (0.3 * shared + rng.standard_normal((n_win, ws, n_emg))
            ).astype(np.float32)
    tapers = np.asarray(filtered_tapers(ws, nw, 0.9), np.float32)
    K = tapers.shape[0]
    return eegf, emgf, tapers, np.float32(t_dist.ppf(0.975, K - 1)), K


class TestJackknifeEpilogue:
    """The jackknife epilogue (``_msc_chunk_kernel``) against the float64
    numpy jackknife of chip_smoke.py, over taper counts, bin counts that
    are not a power of two and 1/3/64-channel montages."""

    @staticmethod
    def _both(ws, nw, n_eeg, n_emg, emg_max, n_win=2, seed=0):
        import sys
        from pathlib import Path
        import jax.numpy as jnp
        from mba_tpu.ops import coherence as C
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        import chip_smoke
        eegf, emgf, tapers, t_crit, K = _spectra_case(
            ws, nw, n_eeg, n_emg, n_win, seed)
        out = C._msc_chunk_kernel(
            jnp.asarray(eegf), jnp.asarray(emgf), jnp.asarray(tapers),
            np.float32(1.0 / (256.0 * ws)), t_crit, use_jackknife=True,
            aggregate_emg_max=emg_max)
        refs = [chip_smoke.reference_msc_window(
            eegf[w], emgf[w], tapers.astype(np.float64), float(t_crit))
            for w in range(n_win)]
        if emg_max:
            refs = [chip_smoke.reference_emg_max(*r) for r in refs]
        ref = {k: np.stack([r[i] for r in refs])
               for i, k in enumerate(("coherence", "ci_lower", "ci_upper",
                                      "margin")[:len(refs[0])])}
        out = {k: np.asarray(v) for k, v in out.items()}
        if emg_max:
            # CIs of EMG near-ties (top two coherences within f32
            # round-off) may come from either channel: not compared
            tie = ref.pop("margin") <= chip_smoke.TIE_MARGIN
            for key in ("ci_lower", "ci_upper"):
                out[key] = np.where(tie, ref[key], out[key])
        return out, ref, K

    @pytest.mark.parametrize("nw,k_expected", [(1.5, 2), (2, 3), (3, 5)])
    @pytest.mark.parametrize("n_ch", [1, 3, 64])
    def test_matches_xla_kernel(self, nw, k_expected, n_ch):
        # ws=66 → F=34 bins
        out, ref, K = self._both(66, nw, n_ch, n_ch, emg_max=True,
                                 n_win=1 if n_ch == 64 else 2)
        assert K == k_expected
        assert out["coherence"].shape == ref["coherence"].shape
        np.testing.assert_allclose(out["coherence"], ref["coherence"],
                                   atol=1e-4)
        if K > 2:   # one-taper replicates have undefined (nan) CIs
            # the real-valued DC bin saturates near coherence 1, where the
            # f32 Fisher-z CI is ill-conditioned: compare from bin 1 on
            for key in ("ci_lower", "ci_upper"):
                np.testing.assert_allclose(out[key][:, 1:], ref[key][:, 1:],
                                           atol=2e-3, err_msg=key)

    def test_nonaligned_freq_padding(self):
        # F = 65 (ws=128): odd bin count, 5 EEG × 3 EMG channels
        out, ref, _ = self._both(128, 2, 5, 3, emg_max=True, n_win=1,
                                 seed=1)
        assert out["coherence"].shape == (1, 65, 5)
        np.testing.assert_allclose(out["coherence"], ref["coherence"],
                                   atol=1e-4)

    @pytest.mark.parametrize("nw", [2, 3])
    def test_full_grid_mode_matches_xla(self, nw):
        out, ref, _ = self._both(64, nw, 6, 3, emg_max=False, seed=2)
        assert out["coherence"].shape == (2, 33, 6, 3)
        np.testing.assert_allclose(out["coherence"], ref["coherence"],
                                   atol=1e-5)
        for key in ("ci_lower", "ci_upper"):
            np.testing.assert_allclose(out[key], ref[key], atol=2e-3,
                                       err_msg=key)

    def test_transfer_dtype_halves_payload_precision_ok(self):
        import jax.numpy as jnp
        from mba_tpu.ops.coherence import multitaper_msc
        rng = np.random.default_rng(0)
        fs, n = 256.0, 256 * 6
        eeg = rng.standard_normal((n, 4)).astype(np.float32)
        emg = rng.standard_normal((n, 2)).astype(np.float32)
        kw = dict(nw=3, window_length_sec=1.0, use_jackknife=True,
                  apply_independence_threshold=False)
        full = multitaper_msc(eeg, emg, fs, **kw)
        half = multitaper_msc(eeg, emg, fs, transfer_dtype=jnp.float16,
                              **kw)
        # public contract stays float32 on the host
        assert half["coherence_raw"].dtype == np.float32
        np.testing.assert_allclose(half["coherence_raw"],
                                   full["coherence_raw"], atol=6e-4)
        np.testing.assert_allclose(half["coherence_ci_upper"],
                                   full["coherence_ci_upper"],
                                   atol=6e-4)

    def test_transfer_dtype_int16_quantized_download(self):
        """int16 transfer_dtype = affine per-lane quantized download:
        half the f16 bytes' error budget at the same byte count (the
        grid is fitted to the per-lane range) and masked windows stay
        exact zeros through the dequant."""
        from mba_tpu.ops.coherence import multitaper_msc
        rng = np.random.default_rng(2)
        fs, n = 256.0, 256 * 6
        eeg = rng.standard_normal((n, 4)).astype(np.float32)
        emg = rng.standard_normal((n, 2)).astype(np.float32)
        mask = np.array([1, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1], bool)
        kw = dict(nw=3, window_length_sec=1.0, use_jackknife=True,
                  apply_independence_threshold=False, window_mask=mask,
                  collect_timings=True)
        full = multitaper_msc(eeg, emg, fs, **kw)
        q16 = multitaper_msc(eeg, emg, fs, transfer_dtype=np.int16, **kw)
        assert q16["coherence_raw"].dtype == np.float32
        for key in ("coherence_raw", "coherence_ci_lower",
                    "coherence_ci_upper"):
            np.testing.assert_allclose(q16[key], full[key], atol=1e-4,
                                       err_msg=key)
        # masked windows exact zeros (scattered on host after dequant)
        assert np.all(q16["coherence_raw"][~mask] == 0.0)
        # the link payload halves (plus tiny per-lane sidecars)
        assert q16["timings"]["download_bytes"] \
            < 0.52 * full["timings"]["download_bytes"]

    def test_input_transfer_int16_quantization(self):
        """Per-channel int16 upload: coherence is scale-invariant per
        channel, so quantization (≤2^-15 of each channel's peak) must
        leave the result essentially unchanged."""
        from mba_tpu.ops.coherence import multitaper_msc
        rng = np.random.default_rng(1)
        fs, n = 256.0, 256 * 6
        # wildly different channel scales to stress per-channel peaks
        eeg = (rng.standard_normal((n, 4))
               * np.array([1e-3, 1.0, 50.0, 1e3], np.float32)
               ).astype(np.float32)
        emg = rng.standard_normal((n, 2)).astype(np.float32)
        kw = dict(nw=3, window_length_sec=1.0, use_jackknife=True,
                  apply_independence_threshold=False)
        full = multitaper_msc(eeg, emg, fs, **kw)
        i16 = multitaper_msc(eeg, emg, fs, input_transfer="int16", **kw)
        assert i16["coherence_raw"].dtype == np.float32
        np.testing.assert_allclose(i16["coherence_raw"],
                                   full["coherence_raw"], atol=2e-3)
        np.testing.assert_allclose(i16["coherence_ci_lower"],
                                   full["coherence_ci_lower"], atol=2e-3)

    def test_input_transfer_int16_adc_counts_verbatim(self):
        """Arrays already in int16 ADC counts upload verbatim and give
        the same answer as their float32 conversion."""
        from mba_tpu.ops.coherence import multitaper_msc
        rng = np.random.default_rng(2)
        fs, n = 256.0, 256 * 4
        eeg_i = (rng.standard_normal((n, 3)) * 2000).astype(np.int16)
        emg_i = (rng.standard_normal((n, 2)) * 2000).astype(np.int16)
        kw = dict(nw=3, window_length_sec=1.0, use_jackknife=True,
                  apply_independence_threshold=False)
        full = multitaper_msc(eeg_i.astype(np.float32),
                              emg_i.astype(np.float32), fs, **kw)
        raw = multitaper_msc(eeg_i, emg_i, fs, input_transfer="int16",
                             **kw)
        np.testing.assert_allclose(raw["coherence_raw"],
                                   full["coherence_raw"], atol=1e-5)


class TestDeviceInputsAndTimings:
    def test_device_inputs_match_host_inputs(self):
        """jax.Array inputs stay on device (no host round-trip) and give
        identical results to numpy inputs."""
        import jax.numpy as jnp
        eeg, emg = _coupled_signals()
        host = multitaper_msc(eeg, emg, 256, window_length_sec=1.0)
        dev = multitaper_msc(jnp.asarray(eeg, jnp.float32),
                             jnp.asarray(emg, jnp.float32), 256,
                             window_length_sec=1.0)
        np.testing.assert_allclose(dev["coherence_raw"],
                                   host["coherence_raw"],
                                   rtol=1e-5, atol=1e-6)

    def test_collect_timings(self):
        eeg, emg = _coupled_signals()
        res = multitaper_msc(eeg, emg, 256, collect_timings=True)
        tm = res["timings"]
        for key in ("upload_sec", "upload_bytes", "compute_sec",
                    "download_sec", "download_bytes"):
            assert key in tm, key
        assert tm["download_bytes"] > 0
        # off by default
        assert "timings" not in multitaper_msc(eeg, emg, 256)


class TestFreqRange:
    """Device-side frequency slicing of the download (freq_range)."""

    def test_slice_matches_full_grid(self):
        eeg, emg = _coupled_signals()
        kw = dict(window_length_sec=1.0, use_jackknife=True,
                  apply_independence_threshold=False)
        full = multitaper_msc(eeg, emg, 256, **kw)
        part = multitaper_msc(eeg, emg, 256, freq_range=(8.0, 40.0), **kw)
        freqs = full["freqs"]
        sel = (freqs >= 8.0) & (freqs <= 40.0)
        np.testing.assert_array_equal(part["freqs"], freqs[sel])
        for key in ("coherence_raw", "coherence_ci_lower",
                    "coherence_ci_upper"):
            np.testing.assert_array_equal(part[key], full[key][:, sel])
        assert part["metadata"]["freq_range"] == (8.0, 40.0)

    def test_slice_with_quantized_download_and_mask(self):
        eeg, emg = _coupled_signals(seconds=8)
        mask = np.zeros(15, dtype=bool)   # 8s @ 1s windows, 50% overlap
        mask[3:9] = True
        kw = dict(window_length_sec=1.0, use_jackknife=True,
                  aggregate_emg_max=True, window_mask=mask,
                  apply_independence_threshold=False,
                  transfer_dtype=np.int16)
        full = multitaper_msc(eeg, emg, 256, **kw)
        part = multitaper_msc(eeg, emg, 256, freq_range=(0.0, 60.0), **kw)
        sel = full["freqs"] <= 60.0
        # quantization lanes may differ (coarse per-channel lanes span
        # the freq axis), so compare at the int16 error bound
        np.testing.assert_allclose(part["coherence_raw"],
                                   full["coherence_raw"][:, sel],
                                   atol=2e-4)
        # masked-out windows stay exact zeros on the sliced grid too
        assert np.all(part["coherence_raw"][~mask] == 0.0)

    def test_empty_range_raises(self):
        eeg, emg = _coupled_signals()
        with np.testing.assert_raises(ValueError):
            multitaper_msc(eeg, emg, 256, window_length_sec=1.0,
                           freq_range=(500.0, 600.0))

    def test_task_wise_wrapper_forwards(self):
        from mba_tpu.pipeline import signal_features as sf
        rng = np.random.default_rng(7)
        n = 256 * 8
        eeg = rng.standard_normal((n, 3)).astype(np.float32)
        emg = rng.standard_normal((n, 2)).astype(np.float32)
        out = sf.compute_task_wise_aggregated_cmc(
            eeg, emg, 256, muscle_group="flexor",
            window_size_sec=1.0, use_jackknife=False,
            freq_range=(0.0, 100.0))
        values, tc, fr = out
        assert fr.max() <= 100.0 and fr.min() >= 0.0
        assert values.shape[1] == len(fr)
