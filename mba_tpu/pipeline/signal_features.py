"""High-level biostatistical feature extraction (the reference's public API).

Parity target: reference ``src/pipeline/signal_features.py`` — every public
symbol is preserved with the same semantics; the dense numerics are the
device kernels from :mod:`mba_tpu.ops`:

- ``FREQUENCY_BANDS``                         ↔ :17-26
- :func:`resample_data`                       ↔ :40-56
- :func:`mirror_eeg_channel_list`             ↔ :59-76
- :func:`multitaper_psd`                      ↔ :80-454 (ops.spectral)
- Fisher transforms / Beta threshold          ↔ :459-481
- :func:`multitaper_magnitude_squared_coherence` ↔ :619-839 (ops.coherence)
- :func:`_build_task_window_mask`             ↔ :842-895
- :func:`compute_task_wise_aggregated_cmc`    ↔ :898-1026
- spectrogram save/fetch                      ↔ :1033-1100
- :func:`max_cmc_spectrograms_over_channels`  ↔ :1132-1171
- :func:`aggregate_spectrogram_over_frequency_band` ↔ :1174-1371
- :func:`aggregate_psd_spectrogram`           ↔ :1374-1502
- :func:`compute_heart_rate_and_variability`  ↔ :1506-1720
- :func:`compute_task_wise_scaled_force`      ↔ :1723-1816
- :func:`compute_feature_mi_importance`       ↔ :1820-2065
- :func:`compute_spectral_snr`                ↔ :2069-2130 (ops.spectral)
- :func:`discrete_fourier_transform`          ↔ :2133-2185 (ops.spectral)
"""
from __future__ import annotations

from pathlib import Path
from typing import Literal

import numpy as np
import pandas as pd

from mba_tpu.channel_layout import (EEG_CHANNEL_IND_DICT,
                                    mirror_eeg_channel_list)  # noqa: F401
from mba_tpu.ops.coherence import (multitaper_msc,
                                   cmc_independence_threshold,
                                   max_cmc_over_channels,
                                   fisher_atanh as _fisher_jnp,
                                   inverse_fisher_atanh as _inv_fisher_jnp)
from mba_tpu.ops.framing import resample_linear
from mba_tpu.ops.spectral import (multitaper_psd as _multitaper_psd_op,
                                  spectral_snr, amplitude_spectrum)
from mba_tpu.utils import file_management as filemgmt

FREQUENCY_BANDS = {
    'delta': (0.5, 4),
    'theta': (4, 8),
    'alpha': (8, 12),
    'beta': (13, 30),
    'gamma': (30, 100),  # EEG gamma range
}


# --------------------------------------------------------------------------
# thin wrappers over ops kernels (reference-identical signatures)
# --------------------------------------------------------------------------
def check_2d_numpy_array(input_array: np.ndarray,
                         axis: Literal[0, 1] | None = None
                         ) -> tuple[np.ndarray, Literal[0, 1]]:
    """Promote 1-D input to a (n, 1) column and resolve ``axis``.

    Drop-in for the reference's public helper (signal_features.py:29-37):
    1-D arrays get a channel axis and ``axis=0``; 2-D arrays require an
    explicit ``axis``.
    """
    input_array = np.asarray(input_array)
    if input_array.ndim == 1:
        input_array = input_array[:, np.newaxis]
        if axis is None:
            axis = 0
    elif axis is None:
        raise AttributeError("For 2D signal arrays, axis needs to be "
                             "defined!")
    return input_array, axis


def resample_data(data: np.ndarray, original_sampling_freq,
                  new_sampling_freq, axis: Literal[0, 1] | None = None):
    """Linear-interpolation resampling (reference signal_features.py:40)."""
    data = np.asarray(data)
    if data.ndim == 1:
        return np.asarray(resample_linear(data, original_sampling_freq,
                                          new_sampling_freq))
    data, axis = check_2d_numpy_array(data, axis)
    x = data.T if axis == 1 else data
    out = np.asarray(resample_linear(x, original_sampling_freq,
                                     new_sampling_freq))
    return out.T if axis == 1 else out


def jackknife_coherence_and_ci(tapers_filtered: np.ndarray,
                               eeg_window: np.ndarray,
                               emg_window: np.ndarray,
                               sampling_freq: float,
                               window_samples: int,
                               jackknife_alpha: float = 0.05) -> tuple:
    """Leave-one-taper-out jackknife for one window (reference
    signal_features.py:484-578): mean in coherence space, variance in
    Fisher-z space, Student-t CI clamped to contain the mean.

    Same signature and outputs as the reference, computed by the device
    kernel's algebraic O(K) formulation instead of the reference's
    O(K^2) per-taper re-accumulation.
    """
    import jax.numpy as jnp
    from scipy.stats import t as t_dist
    from mba_tpu.ops.coherence import _msc_chunk_kernel

    tapers = np.asarray(tapers_filtered, np.float32)
    K = tapers.shape[0]
    t_crit = np.float32(t_dist.ppf(1 - jackknife_alpha / 2, K - 1))
    inv_fs_n = np.float32(1.0 / (sampling_freq * window_samples))
    out = _msc_chunk_kernel(
        jnp.asarray(eeg_window, jnp.float32)[None],
        jnp.asarray(emg_window, jnp.float32)[None],
        jnp.asarray(tapers), inv_fs_n, t_crit,
        use_jackknife=True, aggregate_emg_max=False)
    return (np.asarray(out["coherence"])[0],
            np.asarray(out["ci_lower"])[0],
            np.asarray(out["ci_upper"])[0])


def fisher_atanh_transform(coherence: np.ndarray,
                           eps: float = 1e-10) -> np.ndarray:
    """Forward Fisher atanh: C² → z (reference :459-462)."""
    c = np.clip(coherence, eps, 1 - eps)
    return 0.5 * np.log((1 + c) / (1 - c))


def inverse_fisher_atanh(z: np.ndarray) -> np.ndarray:
    """Inverse Fisher atanh: z → C² (reference :465-467)."""
    return np.tanh(z) ** 2


def compute_cmc_independence_threshold(K: int, alpha: float = 0.05) -> float:
    """Beta(K−2, K−2) (1−alpha) quantile (reference :470-481)."""
    return cmc_independence_threshold(K, alpha)


def apply_threshold_filtering(coherence_values: np.ndarray, K: int,
                              alpha: float = 0.05,
                              n_comparisons: int | None = None,
                              apply_bonferroni: bool = False):
    """Independence-threshold mask with optional Bonferroni (ref :581-604)."""
    if apply_bonferroni and n_comparisons is not None:
        alpha = max(alpha / n_comparisons, 1e-10)
    it = compute_cmc_independence_threshold(K, alpha=alpha)
    return coherence_values > it, it


def multitaper_psd(input_array, sampling_freq: float, nw: float = 3,
                   window_length_sec: float = 1.0, overlap_frac: float = 0.5,
                   axis: Literal[0, 1] | None = None,
                   apply_log_scale: bool = True,
                   psd_save_dir: str | Path | None = None,
                   psd_file_suffix: str = "", device_output: bool = False,
                   **_ignored):
    """DPSS multitaper sliding-window PSD (device kernel, reference :80-454).

    ``device_output=True`` keeps the spectrogram on the accelerator (the
    save path, if requested, still downloads it once)."""
    spectrograms, time_centers, freqs = _multitaper_psd_op(
        input_array, sampling_freq, nw=nw,
        window_length_sec=window_length_sec, overlap_frac=overlap_frac,
        axis=axis, apply_log_scale=apply_log_scale,
        device_output=device_output)
    if psd_save_dir is not None:
        save_spectrograms(spectrograms, time_centers, freqs, "PSD",
                          save_dir=psd_save_dir,
                          identifier_suffix=psd_file_suffix)
    return spectrograms, time_centers, freqs


def multitaper_magnitude_squared_coherence(eeg_array, emg_array,
                                           sampling_freq, **kwargs) -> dict:
    """Full EEG×EMG multitaper MSC (device kernel, reference :619-839)."""
    return multitaper_msc(eeg_array, emg_array, sampling_freq, **kwargs)


def compute_spectral_snr(input_array, sampling_freq,
                         target_freq: float = 21.5,
                         freq_window: float = 8.5,
                         target_band_ratio: float = 0.5,
                         axis: Literal[0, 1] = 0,
                         return_psd: bool = False):
    """Welch-based SNR at a target frequency (reference :2069-2130)."""
    return spectral_snr(input_array, sampling_freq, target_freq,
                        freq_window, target_band_ratio, axis, return_psd)


def discrete_fourier_transform(input_array, sampling_freq,
                               axis: Literal[0, 1] = 0,
                               plot_result: bool = False, **_plot_kwargs):
    """Positive-frequency amplitude spectrum (reference :2133-2185)."""
    return amplitude_spectrum(input_array, sampling_freq, axis)


# --------------------------------------------------------------------------
# task-selective CMC
# --------------------------------------------------------------------------
def _build_task_window_mask(time_centers_sec: np.ndarray,
                            log_frame: pd.DataFrame,
                            pre_buffer_sec: float,
                            post_buffer_sec: float,
                            verbose: bool = True,
                            task_latency_assumption_sec: float = 3.25,
                            task_end_cutoff_sec: float = 2.0
                            ) -> np.ndarray:
    """Boolean mask of windows whose centre falls inside a buffered task.

    Parity: reference :842-895 — trial spans and measurement start come
    from the experiment log; everything is compared in float seconds from
    recording start.
    """
    from mba_tpu.pipeline import data_integration
    from mba_tpu.pipeline.data_analysis import make_timezone_aware

    measurement_start, _ = data_integration.get_qtc_measurement_start_end(
        log_frame)
    measurement_start = make_timezone_aware(pd.Timestamp(measurement_start))
    trial_start_ends = data_integration.get_all_task_start_ends(
        log_frame, output_type='list',
        assumed_latency_sec=task_latency_assumption_sec,
        cut_off_sec_to_prevent_transients=task_end_cutoff_sec)
    return task_window_mask_from_spans(
        time_centers_sec, trial_start_ends, measurement_start,
        pre_buffer_sec, post_buffer_sec, verbose=verbose)


def task_window_mask_from_spans(time_centers_sec: np.ndarray,
                                trial_start_ends: list[tuple],
                                measurement_start: pd.Timestamp,
                                pre_buffer_sec: float,
                                post_buffer_sec: float,
                                verbose: bool = True) -> np.ndarray:
    """Mask construction from explicit trial spans (testable core)."""
    mask = np.zeros(len(time_centers_sec), dtype=bool)
    for trial_start, trial_end in trial_start_ends:
        t0 = ((trial_start - measurement_start).total_seconds()
              - pre_buffer_sec)
        t1 = ((trial_end - measurement_start).total_seconds()
              + post_buffer_sec)
        mask |= (time_centers_sec >= t0) & (time_centers_sec <= t1)
    if verbose:
        n_active = int(mask.sum())
        print(f"Task window mask: {n_active}/{len(mask)} windows selected "
              f"({100 * n_active / max(len(mask), 1):.1f}%) across "
              f"{len(trial_start_ends)} trials "
              f"[±{pre_buffer_sec}s / +{post_buffer_sec}s buffers]")
    return mask


def compute_task_wise_aggregated_cmc(
        eeg_array: np.ndarray,
        emg_array: np.ndarray,
        sampling_freq: int,
        muscle_group: str,
        log_frame: pd.DataFrame | None = None,
        eeg_channel_subset: list[str] | None = None,
        window_size_sec: float = 2.0,
        window_overlap_ratio: float = 0.5,
        enforce_independence_threshold: bool = False,
        independence_threshold_alpha: float = 0.2,
        use_jackknife: bool = True,
        jackknife_alpha: float = 0.05,
        save_dir: str | Path | None = None,
        pre_trial_computation_buffer_sec: float = 3.0,
        post_trial_computation_buffer_sec: float = 3.0,
        window_mask: np.ndarray | None = None,
        task_latency_assumption_sec: float = 3.25,
        task_end_cutoff_sec: float = 2.0,
        timings_out: dict | None = None,
        transfer_dtype=None,
        freq_range: tuple | None = None,
) -> tuple:
    """EMG-max-aggregated task-selective CMC (reference :898-1026).

    One global sliding-window grid; windows outside buffered task periods
    are skipped (zeros).  The EMG-channel max with CI-aligned indices is
    fused into the device kernel unless the independence-threshold masking is
    requested (which the reference applies to the un-aggregated tensor).

    ``transfer_dtype`` forwards to :func:`multitaper_msc` — ``np.int16``
    downloads the coherence/CI tensors as per-lane quantized integers
    (≤ ~8e-6 abs error on [0, 1] values) at half the downloaded bytes.
    ``freq_range=(lo, hi)`` forwards likewise: the coherence grid is
    sliced to the band ON DEVICE before download (values inside the
    range bit-identical; freqs vector sliced to match) — cap at 250 Hz
    (the top edge of ``AGGREGATE_BANDS``) to cut the downloaded bytes ~4× at
    fs=2048 without changing any downstream band consumer.
    """
    if eeg_channel_subset:
        inds = [EEG_CHANNEL_IND_DICT[ch] for ch in eeg_channel_subset]
        print(f"Reducing EEG to {len(eeg_channel_subset)} channels: "
              f"{eeg_channel_subset}")
        eeg_array = eeg_array[:, inds]

    n_samples_eeg, _ = eeg_array.shape
    n_samples_emg, _ = emg_array.shape
    if n_samples_eeg != n_samples_emg:
        raise ValueError(
            f"EEG and EMG must have same number of samples. "
            f"Got EEG: {n_samples_eeg}, EMG: {n_samples_emg}")

    if log_frame is not None and window_mask is None:
        window_samples = int(window_size_sec * sampling_freq)
        hop_samples = int(window_samples * (1 - window_overlap_ratio))
        if hop_samples <= 0:
            raise ValueError(
                "window_overlap_ratio too high: hop_samples becomes <= 0")
        n_windows = (n_samples_eeg - window_samples) // hop_samples + 1
        time_centers_preview = ((np.arange(n_windows) * hop_samples
                                 + window_samples / 2) / sampling_freq)
        window_mask = _build_task_window_mask(
            time_centers_preview, log_frame,
            pre_buffer_sec=pre_trial_computation_buffer_sec,
            post_buffer_sec=post_trial_computation_buffer_sec,
            task_latency_assumption_sec=task_latency_assumption_sec,
            task_end_cutoff_sec=task_end_cutoff_sec)

    # reference applies the significance mask BEFORE the EMG max, so the
    # fused on-chip aggregation is only used when thresholding is off
    fuse = not enforce_independence_threshold
    output = multitaper_msc(
        eeg_array, emg_array, sampling_freq=sampling_freq,
        window_length_sec=window_size_sec,
        overlap_frac=window_overlap_ratio,
        significance_level=independence_threshold_alpha,
        apply_independence_threshold=enforce_independence_threshold,
        use_jackknife=use_jackknife, jackknife_alpha=jackknife_alpha,
        window_mask=window_mask, aggregate_emg_max=fuse, verbose=True,
        collect_timings=timings_out is not None,
        transfer_dtype=transfer_dtype, freq_range=freq_range)
    if timings_out is not None:
        timings_out.update(output.get('timings', {}))
        # expose the kept taper count: the Beta(K−2, K−2) independence
        # threshold (reference :470-481) needs it downstream
        timings_out['K_tapers'] = output['metadata']['K_tapers']

    time_centers = output['time_centers']
    freqs = output['freqs']

    if fuse:
        values = output['coherence_raw']
        if use_jackknife:
            values_lower = output['coherence_ci_lower']
            values_upper = output['coherence_ci_upper']
    else:
        masked = np.where(output['coherence_significant'],
                          output['coherence_raw'], 0.0)
        if use_jackknife:
            values, values_lower, values_upper = \
                max_cmc_over_channels(masked,
                                      output['coherence_ci_lower'],
                                      output['coherence_ci_upper'])
        else:
            values = max_cmc_over_channels(masked)

    if save_dir is not None:
        channel_suffix = (f"Channels_{'_'.join(eeg_channel_subset)}"
                          if eeg_channel_subset else "All_Channels")
        label = (f"{muscle_group.capitalize()} CMC"
                 f"{' Trial-wise' if window_mask is not None else ''}")
        save_spectrograms(values, time_centers, freqs, save_dir=save_dir,
                          modality=label, identifier_suffix=channel_suffix)

    if use_jackknife:
        return values, values_lower, values_upper, time_centers, freqs
    return values, time_centers, freqs


# --------------------------------------------------------------------------
# spectrogram persistence (timestamped artifact store)
# --------------------------------------------------------------------------
def save_spectrograms(spectrograms: np.ndarray, time_centers: np.ndarray,
                      frequencies: np.ndarray, modality: str,
                      save_dir: str | Path, identifier_suffix: str = "",
                      save_dtype=None):
    """Persist (spectrograms, timecenters, frequencies) triplet (ref :1033).

    ``save_dtype`` (e.g. ``np.float16``) casts the big spectrogram array
    before writing — halves the disk bytes and write time for log10 PSD
    artifacts whose values fit comfortably in f16 (|log10 PSD| < 20 ⇒
    abs error ≤ ~0.01 log units); ``np.load`` consumers upcast
    transparently.  Default ``None`` keeps the input dtype (float32,
    the reference's on-disk format, signal_features.py:710-713).
    """
    save_dir = Path(save_dir)
    if save_dtype is not None:
        spectrograms = np.asarray(spectrograms, dtype=save_dtype)
    diffs = np.diff(time_centers)
    step = np.nanmin(np.where(diffs > 0, diffs, np.nan)) if len(diffs) \
        else 0.0
    sfx = f" {identifier_suffix}" if identifier_suffix else ""
    for obj, title in [
        (spectrograms,
         f"{modality} Spectrograms {spectrograms.shape[2]}ch "
         f"{step:.2f}sec_step{sfx}"),
        (time_centers, f"{modality} Timecenters {len(time_centers)}windows"
                       f"{sfx}"),
        (frequencies, f"{modality} Frequencies {len(frequencies)}freqs"
                      f"{sfx}"),
    ]:
        np.save(save_dir / filemgmt.file_title(title, ".npy"), obj)
    print(f"Saved {modality} spectrograms of shape {spectrograms.shape} "
          f"to {save_dir}")


def fetch_stored_spectrograms(dir: Path | str, modality: str,
                              file_identifier=None,
                              expected_n_channels: int | None = None):
    """Load the most recent (spectrograms, timecenters, frequencies)
    triplet matching keywords (reference :1050-1100)."""
    ids = ([file_identifier] if isinstance(file_identifier, str)
           else file_identifier if file_identifier is not None else [])
    spectrograms = np.load(filemgmt.most_recent_file(
        dir, ".npy", [modality, "Spectrograms"] + ids))
    if spectrograms.dtype == np.float16:
        # storage-only dtype (save_spectrograms save_dtype=f16):
        # upcast so downstream reductions accumulate in f32
        spectrograms = spectrograms.astype(np.float32)
    if expected_n_channels is not None and spectrograms.ndim >= 3:
        if spectrograms.shape[2] != expected_n_channels:
            raise ValueError(
                f"fetch_stored_spectrograms: expected {expected_n_channels} "
                f"channels on axis 2 but loaded "
                f"{spectrograms.shape[2]} "
                f"(modality={modality!r}, "
                f"file_identifier={file_identifier!r}).")
    timecenters = np.load(filemgmt.most_recent_file(
        dir, ".npy", [modality, "Timecenters"] + ids))
    frequencies = np.load(filemgmt.most_recent_file(
        dir, ".npy", [modality, "Frequencies"] + ids))
    return spectrograms, timecenters, frequencies


def max_cmc_spectrograms_over_channels(cmc_array, cmc_array_lower_ci=None,
                                       cmc_array_upper_ci=None,
                                       channel_ax: int = 3,
                                       verbose: bool = True):
    """Joint EMG-channel max with CI-aligned indices (reference :1132)."""
    if verbose:
        print("Maxing CMC values over EMG channels (aligned)...")
    return max_cmc_over_channels(cmc_array, cmc_array_lower_ci,
                                 cmc_array_upper_ci, channel_ax=channel_ax)


# --------------------------------------------------------------------------
# aggregators
# --------------------------------------------------------------------------
def aggregate_spectrogram_over_frequency_band(
        spectrograms: np.ndarray,
        freqs: np.ndarray,
        behaviour: Literal['max', 'mean'] = 'mean',
        frequency_bands: dict | None = None,
        log_transform: bool = False,
        log_epsilon: float = 1e-10,
        frequency_axis: int = 1,
        pre_aggregate_axis: tuple[int, str] | None = None,
        lower_array: np.ndarray | None = None,
        upper_array: np.ndarray | None = None) -> dict:
    """Per-band aggregation with CI-coherent argmax (reference :1174-1371).

    DELIBERATE DEVIATION from the reference: the reference selects band
    bins with ``np.take(spectrograms, boolean_mask, axis=...)``
    (signal_features.py:1292), but NumPy interprets a boolean array
    passed to ``np.take`` as integer indices 0/1 — so the reference
    aggregates a mixture of frequency bins 0 and 1 for EVERY band
    instead of the bins inside the band.  This implementation uses
    ``np.compress`` (true boolean selection).  The discrepancy is pinned
    by tests/test_reference_parity.py::TestAggregatorParity.
    """
    if frequency_bands is None:
        frequency_bands = FREQUENCY_BANDS
    min_ndim = 2 + int(pre_aggregate_axis is not None)
    if spectrograms.ndim < min_ndim:
        raise ValueError(
            f"spectrograms must have at least {min_ndim} dimensions, got "
            f"shape {spectrograms.shape}")
    if (lower_array is None) != (upper_array is None):
        raise ValueError(
            "lower_array and upper_array must both be provided or both be "
            "None")
    has_bounds = lower_array is not None
    if has_bounds and (lower_array.shape != spectrograms.shape
                       or upper_array.shape != spectrograms.shape):
        raise ValueError("bounds arrays must match spectrograms shape")
    if len(freqs) != spectrograms.shape[frequency_axis]:
        raise ValueError(
            f"freqs length ({len(freqs)}) must match spectrograms frequency "
            f"axis ({spectrograms.shape[frequency_axis]})")
    if not frequency_bands:
        raise ValueError("frequency_bands dict cannot be empty")

    if pre_aggregate_axis is not None:
        ax, beh = pre_aggregate_axis
        red = {'max': np.max, 'mean': np.mean}.get(beh)
        if red is None:
            raise ValueError(
                f"Unknown behavior for pre_aggregate_axis '{beh}'")
        spectrograms = red(spectrograms, axis=ax, keepdims=True)
        if has_bounds:
            lower_array = red(lower_array, axis=ax, keepdims=True)
            upper_array = red(upper_array, axis=ax, keepdims=True)

    out = {}
    for band_label, (min_freq, max_freq) in frequency_bands.items():
        if min_freq < freqs.min() or max_freq > freqs.max():
            raise ValueError(
                f"Band '{band_label}' range ({min_freq}, {max_freq}) "
                f"exceeds available frequencies "
                f"({freqs.min():.2f}, {freqs.max():.2f})")
        band_sel = (freqs >= min_freq) & (freqs < max_freq)
        subset = np.compress(band_sel, spectrograms, axis=frequency_axis)
        if log_transform:
            subset = np.log10(subset + log_epsilon)
        if has_bounds:
            lo_sub = np.compress(band_sel, lower_array, axis=frequency_axis)
            hi_sub = np.compress(band_sel, upper_array, axis=frequency_axis)

        if behaviour == 'max':
            idx = np.argmax(subset, axis=frequency_axis, keepdims=True)
            condensed = np.take_along_axis(subset, idx, axis=frequency_axis)
            if has_bounds:
                c_lo = np.take_along_axis(lo_sub, idx, axis=frequency_axis)
                c_hi = np.take_along_axis(hi_sub, idx, axis=frequency_axis)
        elif behaviour == 'mean':
            condensed = np.mean(subset, axis=frequency_axis, keepdims=True)
            if has_bounds:
                c_lo = np.mean(lo_sub, axis=frequency_axis, keepdims=True)
                c_hi = np.mean(hi_sub, axis=frequency_axis, keepdims=True)
        else:
            raise ValueError(f"Unknown behaviour '{behaviour}'")

        squeeze_axes = ((frequency_axis, pre_aggregate_axis[0])
                        if pre_aggregate_axis is not None
                        else frequency_axis)
        condensed = np.squeeze(condensed, axis=squeeze_axes)
        if has_bounds:
            out[band_label] = (condensed,
                               np.squeeze(c_lo, axis=squeeze_axes),
                               np.squeeze(c_hi, axis=squeeze_axes))
        else:
            out[band_label] = condensed
    return out


# named frequency slices of the PSD aggregator (reference :1374-1502's
# inline band table); shared with the band-aggregate artifact layer below
# so both code paths select the SAME inclusive [low, high] bins
AGGREGATE_BANDS = {'all': (0, 250), 'slow': (0, 40), 'fast': (60, 250),
                   'delta': (0.5, 4), 'theta': (4, 8), 'alpha': (8, 12),
                   'beta': (13, 30), 'gamma': (30, 100)}


def aggregate_psd_spectrogram(psd_spectrograms: np.ndarray,
                              psd_freqs: np.ndarray = None,
                              normalize_mvc: bool = False,
                              is_log_scaled: bool = False,
                              freq_slice=None,
                              channel_indices: list[int] = None,
                              aggregation_ops: list[tuple] = None
                              ) -> np.ndarray:
    """Multi-stage PSD aggregation (reference :1374-1502).

    Order: MVC normalisation → frequency slice → channel slice →
    sequential mean/max reductions.
    """
    bands = AGGREGATE_BANDS
    result = psd_spectrograms.copy()
    if normalize_mvc and not is_log_scaled:
        mvc = np.max(np.max(result, axis=0, keepdims=True), axis=1,
                     keepdims=True)
        result = result / mvc * 100
    if freq_slice is not None:
        if psd_freqs is None:
            raise ValueError(
                "psd_freqs must be provided when using freq_slice")
        if isinstance(freq_slice, str):
            if freq_slice not in bands:
                raise ValueError(
                    f"Unknown frequency band '{freq_slice}'. Available "
                    f"bands: {', '.join(bands)}")
            low, high = bands[freq_slice]
        else:
            low, high = freq_slice
        result = result[:, (psd_freqs >= low) & (psd_freqs <= high), :]
    if channel_indices is not None:
        result = result[:, :, channel_indices]
    if aggregation_ops is not None:
        for operator, axis in aggregation_ops:
            if operator == 'mean':
                result = np.nanmean(result, axis=axis)
            elif operator == 'max':
                result = np.nanmax(result, axis=axis)
            else:
                raise ValueError(
                    f"Unknown operator '{operator}'. Supported operators: "
                    f"'mean', 'max'")
    return result


# --------------------------------------------------------------------------
# band-aggregate artifacts (device-first lean feature store)
# --------------------------------------------------------------------------
class BandAggregates:
    """Per-band {mean, max}-over-frequency reduction of a spectrogram.

    The device-first answer to the reference's full-grid artifact chain
    (reference signal_features.py:1033-1100 saves the complete
    ``(windows, freqs, channels)`` spectrogram; every downstream
    consumer — the statistics-frame builder's hypothesis aggregates
    (reference statistics_data_preparation_workflow.py:252-336) and the
    CBPA band-power extraction (reference cbpa.py:564-649) — immediately
    reduces it to one named band).  Computing the reduction on-device
    and persisting only ``(windows, n_bands, channels, 2[mean|max])``
    cuts the device→host transfer and the disk artifact by ~2-3 orders
    of magnitude while remaining EXACTLY sufficient for every band-level
    consumer: band selection uses the same inclusive ``[low, high]``
    bins as :func:`aggregate_psd_spectrogram` (``AGGREGATE_BANDS``), and
    the stored per-(window, channel) band mean/max commutes with the
    channel-axis reductions applied downstream.  The full grid stays
    recomputable on demand on the device.
    """

    STAT_INDEX = {'mean': 0, 'max': 1}

    def __init__(self, payload: np.ndarray, time_centers: np.ndarray,
                 band_names: list[str], band_edges: np.ndarray,
                 modality: str = ""):
        payload = np.asarray(payload)
        if payload.ndim != 4 or payload.shape[3] != 2:
            raise ValueError(
                f"BandAggregates payload must be (windows, bands, "
                f"channels, 2), got {payload.shape}")
        if payload.shape[1] != len(band_names):
            raise ValueError(
                f"payload has {payload.shape[1]} bands but "
                f"{len(band_names)} band names given")
        self.payload = payload
        self.time_centers = np.asarray(time_centers)
        self.band_names = list(band_names)
        self.band_edges = np.asarray(band_edges, dtype=np.float64)
        self.modality = modality

    @property
    def n_windows(self) -> int:
        return self.payload.shape[0]

    @property
    def n_channels(self) -> int:
        return self.payload.shape[2]

    def select(self, band: str, stat: Literal['mean', 'max'],
               channel_indices: list[int] | None = None) -> np.ndarray:
        """(windows, channels) band values — the downstream working set."""
        if band not in self.band_names:
            raise ValueError(
                f"Band '{band}' not stored in this artifact "
                f"(available: {self.band_names})")
        if stat not in self.STAT_INDEX:
            raise ValueError(f"Unknown stat '{stat}' (mean|max)")
        out = self.payload[:, self.band_names.index(band), :,
                           self.STAT_INDEX[stat]]
        if channel_indices is not None:
            out = out[:, channel_indices]
        return out


def _band_agg_device(spec, spans: tuple):
    """Jitted (windows, freqs, channels) → (windows, bands, channels, 2)
    band reduction over static contiguous frequency spans.  NaN-aware:
    matches the host path's nanmean / nanmax (all-NaN bins → NaN)."""
    import functools
    import jax

    @functools.partial(jax.jit, static_argnums=(1,))
    def kernel(s, spans_):
        import jax.numpy as jnp
        cols = []
        for lo, hi in spans_:
            sub = jax.lax.slice_in_dim(s, lo, hi, axis=1)
            all_nan = jnp.isnan(sub).all(axis=1)
            mean = jnp.nanmean(sub, axis=1)
            mx = jnp.where(all_nan, jnp.nan, jnp.nanmax(
                jnp.where(jnp.isnan(sub), -jnp.inf, sub), axis=1))
            cols.append(jnp.stack([mean, mx], axis=-1))
        return jnp.stack(cols, axis=1)

    return kernel(spec, spans)


def band_aggregate_spectrogram(spectrogram, freqs,
                               bands: dict | None = None):
    """Reduce (windows, freqs, channels) → (windows, bands, channels, 2).

    Stat axis is ``[mean, max]`` over the band's frequency bins, selected
    with the same inclusive ``(freqs >= low) & (freqs <= high)`` rule as
    :func:`aggregate_psd_spectrogram` so downstream band consumers get
    bit-compatible values.  Accepts a device (jax) array — the reduction
    then runs on the device and only the tiny aggregate is downloaded — or
    a host numpy array (NaN-aware, matching the aggregator's
    nanmean/nanmax).  Bands whose range exceeds the available frequency
    axis are dropped (a 'fast' 60-250 Hz band cannot be represented at
    fs=100); empty-bin bands are dropped likewise.
    """
    if bands is None:
        bands = AGGREGATE_BANDS
    freqs = np.asarray(freqs)
    names, edges, masks = [], [], []
    for name, (low, high) in bands.items():
        sel = (freqs >= low) & (freqs <= high)
        if not sel.any():
            continue
        names.append(name)
        edges.append((low, high))
        masks.append(sel)
    if not names:
        raise ValueError("No requested band overlaps the frequency axis")

    is_device = not isinstance(spectrogram, np.ndarray)
    if is_device:
        # one fused jit over STATIC contiguous band spans instead of
        # ~5 separate XLA programs per band; bands are contiguous on a
        # monotone frequency axis, so static slice_in_dim bounds compile
        # as a single cheap program
        spans = tuple((int(np.flatnonzero(sel)[0]),
                       int(np.flatnonzero(sel)[-1]) + 1)
                      for sel in masks)
        payload = _band_agg_device(spectrogram, spans)
    else:
        spectrogram = np.asarray(spectrogram)
        cols = []
        with np.errstate(all='ignore'):
            import warnings as _warnings
            with _warnings.catch_warnings():
                _warnings.simplefilter("ignore", RuntimeWarning)
                for sel in masks:
                    sub = np.compress(sel, spectrogram, axis=1)
                    cols.append(np.stack([np.nanmean(sub, axis=1),
                                          np.nanmax(sub, axis=1)],
                                         axis=-1))
        payload = np.stack(cols, axis=1)
    return payload, names, np.asarray(edges, dtype=np.float64)


def save_band_aggregates(payload, time_centers: np.ndarray,
                         band_names: list[str], band_edges: np.ndarray,
                         modality: str, save_dir: str | Path,
                         identifier_suffix: str = "") -> Path:
    """Persist a :class:`BandAggregates` artifact (single ``.npz``)."""
    save_dir = Path(save_dir)
    payload = np.asarray(payload, dtype=np.float32)
    sfx = f" {identifier_suffix}" if identifier_suffix else ""
    title = (f"{modality} Band Aggregates {payload.shape[2]}ch "
             f"{payload.shape[1]}bands{sfx}")
    path = save_dir / filemgmt.file_title(title, ".npz")
    np.savez(path, payload=payload,
             time_centers=np.asarray(time_centers),
             band_names=np.asarray(band_names),
             band_edges=np.asarray(band_edges, dtype=np.float64))
    print(f"Saved {modality} band aggregates of shape {payload.shape} "
          f"to {path}")
    return path


def fetch_band_aggregates(dir: Path | str, modality: str,
                          file_identifier=None) -> BandAggregates:
    """Load the most recent band-aggregate artifact matching keywords."""
    ids = ([file_identifier] if isinstance(file_identifier, str)
           else file_identifier if file_identifier is not None else [])
    path = filemgmt.most_recent_file(
        dir, ".npz", [modality, "Band Aggregates"] + ids)
    with np.load(path, allow_pickle=False) as z:
        return BandAggregates(
            z["payload"].astype(np.float32), z["time_centers"],
            [str(s) for s in z["band_names"]], z["band_edges"],
            modality=modality)


# --------------------------------------------------------------------------
# serial-sensor features
# --------------------------------------------------------------------------
def compute_heart_rate_and_variability(
        ecg_series: pd.Series,
        heart_beat_threshold_quantile: float = 0.8,
        rolling_window: str = "15s",
        refractory_period: str = "300ms",
        output_smoothing_window_sec: float = 2.5,
        min_bpm: float = 30.0, max_bpm: float = 200.0,
        max_hrv_seconds: float = 0.3,
        verbose: bool = True):
    """BPM + RMSSD-style HRV from ECG (reference :1506-1720).

    Adaptive rolling-quantile beat detection, refractory filtering,
    physiological interval filtering, forward-fill + rolling-mean smoothing.
    Returns (bpm_series, hrv_series) or (None, None).
    """
    assert isinstance(ecg_series.index, pd.DatetimeIndex), \
        "ecg_series index is not a datetime index!"
    scaled = ((ecg_series - ecg_series.min())
              / (ecg_series.max() - ecg_series.min()))
    threshold = scaled.rolling(window=rolling_window, min_periods=1
                               ).quantile(heart_beat_threshold_quantile)
    above = scaled > threshold
    onsets = (above != above.shift()) & above
    onset_ts = ecg_series.loc[onsets].index.tolist()
    if len(onset_ts) < 2:
        if verbose:
            print(f"ERROR: Only {len(onset_ts)} beat(s) detected.")
        return None, None

    refractory = pd.Timedelta(refractory_period)
    filtered = []
    for t in onset_ts:
        if not filtered or (t - filtered[-1]) >= refractory:
            filtered.append(t)
    onset_ts = filtered
    if len(onset_ts) < 2:
        if verbose:
            print("ERROR: fewer than 2 beats after refractory filtering.")
        return None, None

    intervals = np.array([(b - a).total_seconds()
                          for a, b in zip(onset_ts[:-1], onset_ts[1:])])
    nz = intervals > 0
    if not nz.all():
        onset_ts = [onset_ts[0]] + [onset_ts[i + 1]
                                    for i in range(len(intervals)) if nz[i]]
        intervals = intervals[nz]
    bpm = 60.0 / intervals
    valid = ((intervals >= 60.0 / max_bpm)
             & (intervals <= 60.0 / min_bpm))
    if valid.sum() == 0:
        if verbose:
            print("ERROR: all intervals filtered as physiological outliers.")
        return None, None
    intervals_f = intervals[valid]
    bpm_f = bpm[valid]
    valid_pairs = [(onset_ts[i], onset_ts[i + 1])
                   for i in range(len(onset_ts) - 1) if valid[i]]

    hrv_raw = np.abs(np.diff(intervals_f))
    if verbose and len(hrv_raw) > 0:
        kept = hrv_raw[hrv_raw <= max_hrv_seconds]
        rmssd = np.sqrt(np.mean(kept ** 2)) if len(kept) else np.nan
        print(f"Detected {len(onset_ts)} beats; RMSSD "
              f"{rmssd * 1000:.1f} ms over {len(kept)} intervals")

    bpm_series = pd.Series(index=[p[1] for p in valid_pairs], data=bpm_f)
    if len(valid_pairs) >= 2 and len(hrv_raw) > 0:
        hrv_series = pd.Series(
            index=[valid_pairs[i + 1][1] for i in range(len(hrv_raw))],
            data=hrv_raw)
    else:
        hrv_series = pd.Series(dtype=float)

    merged = ecg_series.to_frame('ecg').join(
        bpm_series.to_frame('bpm'), how='left').join(
        hrv_series.to_frame('hrv'), how='left')
    win = f"{output_smoothing_window_sec}s"
    bpm_out = merged['bpm'].ffill().rolling(window=win, min_periods=1).mean()
    hrv_out = merged['hrv'].ffill().rolling(window=win, min_periods=1).mean()
    return bpm_out, hrv_out


def compute_task_wise_scaled_force(fsr_series: pd.Series,
                                   enriched_log_df: pd.DataFrame,
                                   min_samples: int = 10,
                                   min_percentile: float = .01,
                                   max_percentile: float = .99,
                                   verbose: bool = True,
                                   trial_start_ends: list | None = None
                                   ) -> pd.Series:
    """Per-trial robust (1–99 pct) min-max force scaling (ref :1723-1816).

    NaN outside trials; constant trials map to 0.5.  ``trial_start_ends``
    may be passed directly (testing) instead of deriving from the log.
    """
    from mba_tpu.pipeline.data_analysis import make_timezone_aware

    assert isinstance(fsr_series.index, pd.DatetimeIndex), \
        "fsr_series.index is not a datetime index!"
    fsr_series = fsr_series.copy()
    fsr_series.index = make_timezone_aware(fsr_series.index)

    if trial_start_ends is None:
        from mba_tpu.pipeline import data_integration
        trial_start_ends = data_integration.get_all_task_start_ends(
            enriched_log_df, output_type='list')

    out = pd.Series(index=fsr_series.index, data=np.nan, dtype=float,
                    name='Task-wise Scaled Force')
    skipped = 0
    for trial_idx, (start, end) in enumerate(trial_start_ends):
        subset = fsr_series.loc[start:end]
        if len(subset) == 0:
            skipped += 1
            continue
        vals = subset.dropna().to_numpy()
        if len(vals) < min_samples:
            if verbose:
                print(f"Trial {trial_idx}: only {len(vals)} valid samples "
                      f"(< {min_samples}), skipping")
            skipped += 1
            continue
        lo = np.quantile(vals, q=min_percentile)
        hi = np.quantile(vals, q=max_percentile)
        if hi - lo < 1e-6:
            out.loc[start:end] = 0.5
            continue
        scaled = ((subset - lo) / (hi - lo)).clip(lower=0.0, upper=1.0)
        out.loc[scaled.index] = scaled.values
    if verbose and skipped:
        print(f"Skipped {skipped}/{len(trial_start_ends)} trials due to "
              f"insufficient data")
    return out


# --------------------------------------------------------------------------
# statistical features
# --------------------------------------------------------------------------
def compute_feature_mi_importance(feature_array, target_array,
                                  feature_labels,
                                  target_label: str = 'Target',
                                  target_type: str = 'auto',
                                  feature_type: str = 'auto',
                                  random_state: int = 42,
                                  sort_by_importance: bool = True,
                                  include_barplot: bool = False,
                                  plot_save_dir=None, **_ignored):
    """Mutual-information feature importances (reference :1820-2065).

    Auto-detects discrete vs continuous features/targets (string dtype →
    discrete; numeric with unique-ratio < 5 % → discrete).
    """
    from sklearn.feature_selection import (mutual_info_classif,
                                           mutual_info_regression)
    from sklearn.preprocessing import LabelEncoder

    if hasattr(feature_array, 'values'):
        feature_array = feature_array.values
    feature_array = np.asarray(feature_array)
    target_original = np.asarray(target_array)

    def is_cat(arr):
        arr = np.asarray(arr)
        return arr.dtype == object or arr.dtype.kind in ('U', 'S')

    def infer(arr, ratio=0.05):
        arr = np.asarray(arr, dtype=float)
        return ('discrete'
                if len(np.unique(arr)) / len(arr) < ratio else 'continuous')

    if target_type == 'auto':
        if is_cat(target_original):
            target_type = 'discrete'
            target_encoded = LabelEncoder().fit_transform(target_original)
        else:
            try:
                target_encoded = target_original.astype(float)
                target_type = infer(target_encoded)
            except (ValueError, TypeError):
                target_type = 'discrete'
                target_encoded = LabelEncoder().fit_transform(
                    target_original)
    elif target_type == 'discrete':
        target_encoded = (LabelEncoder().fit_transform(target_original)
                          if is_cat(target_original)
                          else target_original.astype(int))
    else:
        target_encoded = target_original.astype(float)

    n_feat = feature_array.shape[1]
    encoded = np.zeros((feature_array.shape[0], n_feat), dtype=float)
    cat_mask = np.zeros(n_feat, dtype=bool)
    for j in range(n_feat):
        col = feature_array[:, j]
        if is_cat(col):
            cat_mask[j] = True
            encoded[:, j] = LabelEncoder().fit_transform(col)
        else:
            try:
                encoded[:, j] = col.astype(float)
            except (ValueError, TypeError):
                cat_mask[j] = True
                encoded[:, j] = LabelEncoder().fit_transform(col)

    if feature_type == 'auto':
        types = ['discrete' if cat_mask[j] else infer(encoded[:, j])
                 for j in range(n_feat)]
        feature_type = ('discrete'
                        if sum(t == 'discrete' for t in types) > n_feat / 2
                        else 'continuous')

    if target_type == 'discrete':
        mi = mutual_info_classif(encoded, target_encoded.astype(int),
                                 random_state=random_state)
    else:
        mi = mutual_info_regression(encoded, target_encoded.astype(float),
                                    random_state=random_state)

    importance = dict(zip(feature_labels, mi))
    if sort_by_importance:
        importance = dict(sorted(importance.items(), key=lambda x: x[1],
                                 reverse=True))
    if include_barplot:
        from mba_tpu.pipeline import visualizations
        fig, ax = visualizations.plot_mi_barplot(
            importance, target_label, plot_save_dir=plot_save_dir)
        return fig, ax, importance
    return importance
