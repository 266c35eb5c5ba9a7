"""Parity of the gram coefficient engine vs the scan baseline.

The gram engine (ops/gram_coeffs.py) re-derives the rotation-null
coefficients as window-contraction matmuls after factorizing the
normalized taper product into EEG-only × EMG-only parts, and replaces
the rfft with a taper-folded band DFT matmul.  These tests pin it —
coefficient tensors, observed statistic, and full-null agreement —
against `cohort_null._rotation_coeffs_body`'s loop engine on CPU
(where matmul precision is exact f32).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from mba_tpu.ops.cohort_null import (_rotation_coeffs_body,
                                     cohort_msc_rotation_null)
from mba_tpu.ops.dpss import filtered_tapers
from mba_tpu.ops.framing import window_grid
from mba_tpu.ops.gram_coeffs import gram_coeffs_subject

FS = 256.0


def _subject(seed, n_sec=24.0, nE=3, nM=4, couple=0.4):
    rng = np.random.default_rng(seed)
    n = int(FS * n_sec)
    t = np.arange(n) / FS
    drive = np.convolve(rng.standard_normal(n), np.ones(12) / 12.0,
                        "same")
    carrier = np.sin(2 * np.pi * 21.0 * t) * drive
    eeg = (couple * carrier[:, None]
           + rng.standard_normal((n, nE))).astype(np.float32)
    emg = (couple * carrier[:, None]
           + rng.standard_normal((n, nM))).astype(np.float32)
    return eeg, emg


def _grid(n, window_samples, hop):
    starts, _ = window_grid(n, window_samples, hop, FS, convention="cmc")
    return starts.astype(np.int32)


@pytest.mark.parametrize("spectra", ["dft", "fft"])
def test_gram_matches_scan_engine(spectra):
    eeg, emg = _subject(0)
    ws = int(2.0 * FS)
    tapers = filtered_tapers(ws, 3, 0.9)
    starts = _grid(eeg.shape[0], ws, ws // 2)
    weights = np.ones(starts.shape[0], np.float32)
    lo, hi = 8, 60

    base_ref, coef_ref = _rotation_coeffs_body(
        jnp.asarray(eeg), jnp.asarray(emg), jnp.asarray(starts),
        jnp.asarray(weights), jnp.asarray(tapers, jnp.float32),
        ws, lo, hi, window_chunk=4)
    base_g, coef_g = gram_coeffs_subject(
        jnp.asarray(eeg), jnp.asarray(emg), jnp.asarray(starts),
        jnp.asarray(weights), jnp.asarray(tapers, jnp.float32),
        ws, lo, hi, spectra=spectra)

    assert base_g.shape == base_ref.shape
    assert coef_g.shape == coef_ref.shape
    sc = float(np.abs(np.asarray(coef_ref)).max())
    np.testing.assert_allclose(np.asarray(base_g), np.asarray(base_ref),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(coef_g), np.asarray(coef_ref),
                               rtol=2e-3, atol=2e-4 * sc)


def test_gram_weighted_and_padded_windows():
    """Zero-weight (masked) windows and chunk padding are exact no-ops,
    and non-uniform weights match the scan engine."""
    eeg, emg = _subject(1)
    ws = int(2.0 * FS)
    tapers = filtered_tapers(ws, 3, 0.9)
    starts = _grid(eeg.shape[0], ws, ws // 2)
    rng = np.random.default_rng(2)
    weights = rng.uniform(0.2, 1.5, starts.shape[0]).astype(np.float32)
    weights[::3] = 0.0                       # masked windows
    lo, hi = 8, 60

    base_ref, coef_ref = _rotation_coeffs_body(
        jnp.asarray(eeg), jnp.asarray(emg), jnp.asarray(starts),
        jnp.asarray(weights), jnp.asarray(tapers, jnp.float32),
        ws, lo, hi, window_chunk=4)
    # gram_chunk=5 does not divide the window count → exercises padding
    base_g, coef_g = gram_coeffs_subject(
        jnp.asarray(eeg), jnp.asarray(emg), jnp.asarray(starts),
        jnp.asarray(weights), jnp.asarray(tapers, jnp.float32),
        ws, lo, hi, gram_chunk=5)
    sc = float(np.abs(np.asarray(coef_ref)).max())
    np.testing.assert_allclose(np.asarray(base_g), np.asarray(base_ref),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(coef_g), np.asarray(coef_ref),
                               rtol=2e-3, atol=2e-4 * sc)


def test_gram_int_transfer_dtypes():
    """int16 ADC-count inputs (the study-scale transfer leg) produce the
    same coefficients as their f32 dequantized counterparts, both
    engines — per-channel scaling cancels exactly in MSC."""
    eeg, emg = _subject(3)
    q = 2.0 ** 12
    eeg_i = np.clip(np.round(eeg * q / np.abs(eeg).max(0)), -q, q
                    ).astype(np.int16)
    emg_i = np.clip(np.round(emg * q / np.abs(emg).max(0)), -q, q
                    ).astype(np.int16)
    ws = int(2.0 * FS)
    tapers = filtered_tapers(ws, 3, 0.9)
    starts = _grid(eeg.shape[0], ws, ws // 2)
    weights = np.ones(starts.shape[0], np.float32)
    lo, hi = 8, 60

    base_ref, coef_ref = _rotation_coeffs_body(
        jnp.asarray(eeg_i), jnp.asarray(emg_i), jnp.asarray(starts),
        jnp.asarray(weights), jnp.asarray(tapers, jnp.float32),
        ws, lo, hi, window_chunk=4)
    base_g, coef_g = gram_coeffs_subject(
        jnp.asarray(eeg_i), jnp.asarray(emg_i), jnp.asarray(starts),
        jnp.asarray(weights), jnp.asarray(tapers, jnp.float32),
        ws, lo, hi)
    sc = float(np.abs(np.asarray(coef_ref)).max())
    np.testing.assert_allclose(np.asarray(base_g), np.asarray(base_ref),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(coef_g), np.asarray(coef_ref),
                               rtol=2e-3, atol=2e-4 * sc)


def test_full_null_gram_vs_xla_engines():
    """End to end: the production entry point with coeff_engine='gram'
    agrees with 'xla' on observed map, thresholds and p-values (same
    seed → same φ draws; coefficients agree to f32 tolerance)."""
    rng = np.random.default_rng(4)
    J, n, nE, nM = 3, int(FS * 16), 2, 3
    eeg = rng.standard_normal((J, n, nE)).astype(np.float32)
    emg = rng.standard_normal((J, n, nM)).astype(np.float32)

    kw = dict(sampling_freq=FS, n_surrogates=64, window_length_sec=1.0,
              band=(8.0, 30.0), seed=11, surrogate_chunk=32,
              compute_dtype=jnp.float32)
    res_g = cohort_msc_rotation_null(eeg, emg, coeff_engine="gram", **kw)
    res_x = cohort_msc_rotation_null(eeg, emg, coeff_engine="xla", **kw)

    assert res_g["metadata"]["timings"]["coeff_engine"] == "gram"
    assert res_x["metadata"]["timings"]["coeff_engine"] == "xla"
    np.testing.assert_allclose(res_g["observed"], res_x["observed"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(res_g["max_stat"], res_x["max_stat"],
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(
        res_g["p_uncorrected"], res_x["p_uncorrected"], atol=1.5 / 64)


def test_auto_engine_is_gram():
    rng = np.random.default_rng(5)
    J, n = 2, int(FS * 8)
    eeg = rng.standard_normal((J, n, 2)).astype(np.float32)
    emg = rng.standard_normal((J, n, 2)).astype(np.float32)
    res = cohort_msc_rotation_null(
        eeg, emg, sampling_freq=FS, window_length_sec=1.0,
        band=(8.0, 30.0), precompute_only=True)
    assert res["metadata"]["timings"]["coeff_engine"] == "gram"


def test_cohort_msc_null_auto_dispatch():
    """cohort_msc_null: method='auto' picks the exact fft engine at
    small scale and the rotation engine when the fft cost model blows
    the budget; both results carry the choice in metadata."""
    from mba_tpu.ops.cohort_null import cohort_msc_null

    rng = np.random.default_rng(6)
    J, n = 2, int(FS * 6)
    eeg = rng.standard_normal((J, n, 1)).astype(np.float32)
    emg = rng.standard_normal((J, n, 1)).astype(np.float32)
    kw = dict(sampling_freq=FS, n_surrogates=32, window_length_sec=1.0,
              band=(8.0, 30.0), seed=3)

    res = cohort_msc_null(eeg, emg, **kw)
    ch = res["metadata"]["engine_choice"]
    assert ch["method_run"] == "fft"
    assert res["metadata"]["method"] == "fft_phase_randomization" \
        or "fft" in res["metadata"]["method"]

    res_rot = cohort_msc_null(eeg, emg, fft_flop_budget=1.0, **kw)
    assert res_rot["metadata"]["engine_choice"]["method_run"] == "rotation"
    assert res_rot["metadata"]["method"] == "taper_rotation"
    # the measured detection limit travels with every rotation result
    # (BENCH_NULL_POWER.json detection_limit; VERDICT r4 #1)
    assert "detectable-coupling floor" in \
        res_rot["metadata"]["sensitivity_note"]
    assert "sensitivity_note" not in res["metadata"]

    # forced engines and kwarg forwarding/dropping
    res_f = cohort_msc_null(eeg, emg, method="fft",
                            compute_dtype=jnp.float32, **kw)
    assert "compute_dtype" in res_f["metadata"].get(
        "dropped_rotation_kwargs", [])


def _coupled_problem(seed, n_sec=8.0, E=3, M=4):
    rng = np.random.default_rng(seed)
    n = int(n_sec * FS)
    t = np.arange(n) / FS
    eeg = rng.standard_normal((n, E)).astype(np.float32)
    emg = rng.standard_normal((n, M)).astype(np.float32)
    shared = np.sin(2 * np.pi * 21.0 * t
                    + 0.1 * rng.standard_normal(n).cumsum())
    eeg[:, 0] += shared
    emg[:, 1] += shared
    return eeg, emg


@pytest.mark.parametrize("case", ["full_band_uniform_weights",
                                  "band_slice_odd_nF",
                                  "nonuniform_weights_and_padding",
                                  "int16_transfer_dtype_inputs",
                                  "observed_statistic"])
def test_gram_vs_xla_engine_cases(case):
    """The gram engine against the chunked-scan (``xla``) engine, its
    reference, over full and odd band slices, masked/padded windows,
    integer inputs and the observed statistic at φ = 0."""
    seed = ["full_band_uniform_weights", "band_slice_odd_nF",
            "nonuniform_weights_and_padding", "int16_transfer_dtype_inputs",
            "observed_statistic"].index(case)
    eeg, emg = _coupled_problem(seed)
    if case == "int16_transfer_dtype_inputs":
        eeg, emg = (eeg * 1000).astype(np.int16), (emg * 1000).astype(np.int16)
    ws, W = 256, 10
    tapers = jnp.asarray(filtered_tapers(ws, 3, 0.9), jnp.float32)
    lo, hi = (5, 100) if case == "band_slice_odd_nF" else (1, ws // 2)
    starts = jnp.asarray(np.linspace(0, eeg.shape[0] - ws, W).astype(np.int32))
    w = (np.array([1, 0, 2, 0.5, 1, 1, 0, 3, 1, 0.25], np.float32)
         if case == "nonuniform_weights_and_padding"
         else np.ones(W, np.float32))
    args = (jnp.asarray(eeg), jnp.asarray(emg), starts, jnp.asarray(w),
            tapers, ws, lo, hi)
    b0, c0 = (np.asarray(a) for a in _rotation_coeffs_body(
        *args, window_chunk=4))
    b1, c1 = (np.asarray(a) for a in gram_coeffs_subject(*args,
                                                         gram_chunk=4))
    assert b1.shape == (hi - lo, 3, 4) and c1.shape == c0.shape
    sc = float(np.abs(c0).max())
    np.testing.assert_allclose(b1, b0, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(c1, c0, rtol=2e-3, atol=2e-4 * sc)
    if case == "observed_statistic":
        P = c0.shape[-1]
        obs0 = b0 + c0[..., :P // 2].sum(axis=-1)
        obs1 = b1 + c1[..., :P // 2].sum(axis=-1)
        np.testing.assert_allclose(obs1, obs0, rtol=2e-4, atol=2e-5)
        assert np.all(obs0 > -1e-5) and np.all(obs0 < 1 + 1e-5)
