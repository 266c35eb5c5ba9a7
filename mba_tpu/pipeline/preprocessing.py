"""Lazily-computed, cache-invalidating biosignal preprocessing cascade.

Parity target: reference ``src/pipeline/preprocessing.py`` —
``BiosignalPreprocessor``'s memoized property hierarchy (:104-113), its
cache-invalidation truth table (:1001-1110), config round-trip (:184-239),
the validation suite (:1113-1269) and ``import_npy_with_config``
(:1309-1357).  MNE is replaced by native device kernels:

raw → filtered (ops.filters FIR band-pass + harmonic notch, auto bands
EEG (0.1, 100) / EMG (20, 500) Hz) → referenced (average re-ref, EEG only)
→ amplitude_compliant (rolling peak-to-peak artifact annotation, peak
3 mV / 25 ms / 5 % bad-channel rule) → artefact_free (extended-Infomax ICA
+ rule-based IC labeling excluding {'heart beat', 'muscle artifact',
'channel noise', 'eye blink'}) → spatially_filtered (Laplacian neighbor
subtraction as one adjacency matmul) → denoised (wavelet shrinkage)
→ output.

Property names keep the reference's ``np_*`` prefixes (``mne_*`` aliases
retained where workflows referenced them) so downstream code ports 1:1.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Literal

import numpy as np
import jax
import jax.numpy as jnp

from mba_tpu.channel_layout import (EEG_CHANNELS, EEG_CHANNEL_IND_DICT,
                                    EMG_CHANNELS, eeg_positions_3d,
                                    emg_grid_positions_3d)
from mba_tpu.ops.filters import bandpass_filter, notch_filter
from mba_tpu.ops.wavelet import wavelet_denoise
from mba_tpu.ops.ica import InfomaxICA, label_components
from mba_tpu.ops import surrogate as surrogation
from mba_tpu.ops.coherence import multitaper_msc
from mba_tpu.ops.spectral import spectral_snr
from mba_tpu.utils import file_management as filemgmt

# invalidation hierarchy: each stage clears itself + everything after it
_STAGES = ['import', 'filtering', 'referencing', 'amplitude thresholding',
           'ica computation', 'artefact rejection', 'smoothing', 'denoising']
_STAGE_ATTRS = {
    'import': ['_filtered_data'],
    'filtering': ['_filtered_data'],
    'referencing': ['_referenced_data'],
    'amplitude thresholding': ['_amplitude_compliant_data', '_bad_channels',
                               '_bad_annotations'],
    'ica computation': ['_ica_result'],
    'artefact rejection': ['_ica_automatic_labels', '_artefact_free_data'],
    'smoothing': ['_spatially_filtered_data'],
    'denoising': ['_denoised_data', '_output_data'],
}


def _sliding_extreme(x, window: int, fill, cum):
    """Sliding-window extreme via the block prefix/suffix trick: two
    O(n) cumulative scans instead of an O(n·w) reduce_window or an
    (n, w, C) gather (90 GB at 28-min × 64-ch scale)."""
    n, c = x.shape
    pad = (-n) % window
    xp = jnp.pad(x, ((0, pad), (0, 0)), constant_values=fill)
    blocks = xp.reshape(-1, window, c)
    pref = cum(blocks, axis=1).reshape(-1, c)
    suff = cum(blocks[:, ::-1], axis=1)[:, ::-1].reshape(-1, c)
    # window [i, i+w-1] spans at most two length-w blocks: its extreme
    # is extreme(suffix-of-first-block from i, prefix-of-second-block
    # to i+w-1)
    op = jnp.maximum if cum is jax.lax.cummax else jnp.minimum
    return op(suff[:n - window + 1], pref[window - 1:n])


@functools.partial(jax.jit, static_argnames=("window",))
def _rolling_ptp(x, window):
    """Per-channel rolling peak-to-peak over ``window`` samples —
    O(n·C) memory and work."""
    hi = _sliding_extreme(x, window, -jnp.inf, jax.lax.cummax)
    lo = _sliding_extreme(x, window, jnp.inf, jax.lax.cummin)
    return hi - lo


class BiosignalPreprocessor:
    """EEG/EMG preprocessing cascade with lazy memoized stages."""

    def __init__(self,
                 np_input_data: np.ndarray,  # (timesteps, channels)
                 sampling_freq: int,
                 modality: Literal['eeg', 'emg'],
                 band_pass_frequencies='auto',
                 notch_frequency: float | None = 50,
                 notch_harmonics: int = 4,
                 notch_width: float | None = None,
                 reference_channels: str | None = 'average',
                 amplitude_rejection_threshold: float | None = .003,
                 n_ica_components: int | None = 25,
                 automatic_ic_labelling: bool = True,
                 laplacian_filter_neighbor_radius='auto',
                 wavelet_type: str | None = None,
                 denoising_threshold_mode: Literal['soft', 'hard'] = 'soft',
                 device_resident: bool = False):
        assert np_input_data.shape[1] < np_input_data.shape[0], \
            "Should be more timesteps (rows) than channels (columns)!"
        # device_resident: keep every stage result on the accelerator —
        # the cascade then transfers the recording host→device ONCE and
        # downloads only what a consumer asks for via np.asarray (tiny
        # diagnostics excepted).  The default (False) stores each stage
        # as a numpy array, mirroring the reference's MNE RawArray
        # staging — but at study scale (28 min × 64 ch) each stage
        # then round-trips ~0.9 GB between host and device.
        self._device_resident = bool(device_resident)
        if isinstance(np_input_data, jax.Array):
            self._np_input_data = np_input_data
        else:
            self._np_input_data = np.asarray(np_input_data)
        self._sampling_freq = sampling_freq
        self._modality = modality
        self._band_pass_frequencies = band_pass_frequencies
        self._notch_frequency = notch_frequency
        self._notch_harmonics = notch_harmonics
        self._notch_width = notch_width
        self._reference_channels = reference_channels
        self._amplitude_rejection_threshold = amplitude_rejection_threshold
        self._n_ica_components = n_ica_components
        self._automatic_ic_labelling = automatic_ic_labelling
        self._manual_ics_to_exclude: list[int] | None = None
        self._laplacian_filter_neighbor_radius = \
            laplacian_filter_neighbor_radius
        self._wavelet_type = wavelet_type
        self._denoising_threshold_mode = denoising_threshold_mode
        self._reset_all_results()

    def _maybe_host(self, x):
        """Stage-result placement: device array in ``device_resident``
        mode, numpy otherwise."""
        if self._device_resident:
            return x if isinstance(x, jax.Array) else jnp.asarray(x)
        return np.asarray(x)

    def _reset_all_results(self):
        self._filtered_data = None
        self._referenced_data = None
        self._amplitude_compliant_data = None
        self._bad_channels = None
        self._bad_annotations = None
        self._ica_result = None
        self._ica_automatic_labels = None
        self._artefact_free_data = None
        self._spatially_filtered_data = None
        self._denoised_data = None
        self._output_data = None

    # ------------------------------------------------------------------
    # construction / persistence (reference :184-239)
    # ------------------------------------------------------------------
    @classmethod
    def init_from_config(cls, config_file_path, np_input_data: np.ndarray):
        """Instance from a .json config + input array."""
        if str(config_file_path)[-5:] != ".json":
            raise ValueError("Provided file path must be .json")
        with open(config_file_path, "r") as f:
            config = json.load(f)
        manual = config.pop('manual_ics_to_exclude', None)
        config.pop('bad_channels', None)
        if isinstance(config.get('band_pass_frequencies'), list):
            config['band_pass_frequencies'] = tuple(
                config['band_pass_frequencies'])
        instance = cls(np_input_data=np_input_data, **config)
        if manual is not None:
            instance.manual_ics_to_exclude = manual
        return instance

    def export_config(self, save_dir, identifier: str | None = None):
        title = f"Preprocessor Config {self.modality} {self.n_channels}ch"
        if identifier is not None:
            title += f" ({identifier})"
        save_path = Path(save_dir) / filemgmt.file_title(title, ".json")
        attrs = ['sampling_freq', 'modality', 'band_pass_frequencies',
                 'notch_frequency', 'notch_harmonics', 'notch_width',
                 'reference_channels', 'amplitude_rejection_threshold',
                 'n_ica_components', 'automatic_ic_labelling',
                 'laplacian_filter_neighbor_radius', 'wavelet_type',
                 'denoising_threshold_mode', 'manual_ics_to_exclude',
                 'bad_channels']
        config = {a: getattr(self, a) for a in attrs}
        with open(save_path, "w") as f:
            json.dump(config, f, indent=4)
        print('Saved config to ', save_path)

    def export_results(self, save_dir, identifier: str | None = None,
                       with_config: bool = True):
        title = (f"Preprocessed {self.modality} {self.n_channels}ch "
                 f"{int(self.n_timesteps / self.sampling_freq)}sec")
        if identifier is not None:
            title += f" ({identifier})"
        save_path = Path(save_dir) / filemgmt.file_title(title, ".npy")
        np.save(save_path, self.np_output_data)
        print('Saved results to ', save_path)
        if with_config:
            self.export_config(save_dir, identifier=identifier)

    # ------------------------------------------------------------------
    # parameter properties (setters invalidate downstream caches)
    # ------------------------------------------------------------------
    @property
    def np_input_data(self):
        return self._np_input_data

    @np_input_data.setter
    def np_input_data(self, value):
        self._np_input_data = value
        self.clean_downstream_results(change_in='import')

    @property
    def sampling_freq(self):
        return self._sampling_freq

    @sampling_freq.setter
    def sampling_freq(self, value):
        self._sampling_freq = value
        self.clean_downstream_results(change_in='import')

    @property
    def modality(self):
        return self._modality

    @modality.setter
    def modality(self, value):
        self._modality = value
        self.clean_downstream_results(change_in='import')

    @property
    def n_timesteps(self) -> int:
        return self.np_input_data.shape[0]

    @property
    def n_channels(self) -> int:
        return self.np_input_data.shape[1]

    @property
    def channel_names(self) -> list[str]:
        names = EEG_CHANNELS if self.modality == 'eeg' else EMG_CHANNELS
        return names[:self.n_channels]

    @property
    def band_pass_frequencies(self):
        if self._band_pass_frequencies == "auto":
            return (.1, 100) if self.modality == 'eeg' else (20, 500)
        return self._band_pass_frequencies

    @band_pass_frequencies.setter
    def band_pass_frequencies(self, value):
        self._band_pass_frequencies = value
        self.clean_downstream_results(change_in='filtering')

    @property
    def notch_frequency(self):
        return self._notch_frequency

    @notch_frequency.setter
    def notch_frequency(self, value):
        self._notch_frequency = value
        self.clean_downstream_results(change_in='filtering')

    @property
    def notch_harmonics(self):
        return self._notch_harmonics

    @notch_harmonics.setter
    def notch_harmonics(self, value):
        self._notch_harmonics = value
        self.clean_downstream_results(change_in='filtering')

    @property
    def notch_width(self):
        return self._notch_width

    @notch_width.setter
    def notch_width(self, value):
        self._notch_width = value
        self.clean_downstream_results(change_in='filtering')

    @property
    def reference_channels(self):
        return self._reference_channels

    @reference_channels.setter
    def reference_channels(self, value):
        self._reference_channels = value
        self.clean_downstream_results(change_in='referencing')

    @property
    def amplitude_rejection_threshold(self):
        return self._amplitude_rejection_threshold

    @amplitude_rejection_threshold.setter
    def amplitude_rejection_threshold(self, value):
        self._amplitude_rejection_threshold = value
        self.clean_downstream_results(change_in='amplitude thresholding')

    @property
    def n_ica_components(self):
        return self._n_ica_components

    @n_ica_components.setter
    def n_ica_components(self, value):
        self._n_ica_components = value
        self.clean_downstream_results(change_in='ica computation')

    @property
    def automatic_ic_labelling(self):
        return self._automatic_ic_labelling

    @automatic_ic_labelling.setter
    def automatic_ic_labelling(self, value):
        self._automatic_ic_labelling = value
        self.clean_downstream_results(change_in='artefact rejection')

    @property
    def manual_ics_to_exclude(self) -> list[int]:
        return ([] if self._manual_ics_to_exclude is None
                else self._manual_ics_to_exclude)

    @manual_ics_to_exclude.setter
    def manual_ics_to_exclude(self, value):
        self._manual_ics_to_exclude = value
        self.clean_downstream_results('artefact rejection')

    @property
    def laplacian_filter_neighbor_radius(self):
        if self._laplacian_filter_neighbor_radius == 'auto':
            if self.modality == 'eeg':
                return .05
            if self.modality == 'emg':
                return None
            raise ValueError(f"Unknown modality: {self.modality}")
        return self._laplacian_filter_neighbor_radius

    @laplacian_filter_neighbor_radius.setter
    def laplacian_filter_neighbor_radius(self, value):
        self._laplacian_filter_neighbor_radius = value
        self.clean_downstream_results(change_in='smoothing')

    @property
    def wavelet_type(self):
        return self._wavelet_type

    @wavelet_type.setter
    def wavelet_type(self, value):
        self._wavelet_type = value
        self.clean_downstream_results(change_in='denoising')

    @property
    def denoising_threshold_mode(self):
        return self._denoising_threshold_mode

    @denoising_threshold_mode.setter
    def denoising_threshold_mode(self, value):
        self._denoising_threshold_mode = value
        self.clean_downstream_results(change_in='denoising')

    # ------------------------------------------------------------------
    # computed stages
    # ------------------------------------------------------------------
    @property
    def electrode_positions(self) -> np.ndarray:
        """(n_channels, 3) coordinates in meters."""
        if self.modality == 'eeg':
            return eeg_positions_3d(self.channel_names)
        return emg_grid_positions_3d()[:self.n_channels]

    @property
    def np_filtered_data(self) -> np.ndarray:
        """Band-pass + harmonic-notch filtered data (reference :581-599)."""
        if self._filtered_data is not None:
            return self._filtered_data
        lo, hi = self.band_pass_frequencies
        out = bandpass_filter(self.np_input_data, self.sampling_freq, lo, hi)
        if self.notch_frequency is not None:
            freqs = [self.notch_frequency * i
                     for i in range(1, self.notch_harmonics + 1)]
            out = notch_filter(out, self.sampling_freq, freqs,
                               notch_widths=self.notch_width)
        self._filtered_data = self._maybe_host(out)
        return self._filtered_data

    @property
    def np_referenced_data(self) -> np.ndarray:
        """Average re-reference; EEG only (reference :602-619)."""
        if self._referenced_data is not None:
            return self._referenced_data
        if self.reference_channels is None or self.modality == 'emg':
            return self.np_filtered_data
        x = self.np_filtered_data
        if self.reference_channels == 'average':
            ref = x.mean(axis=1, keepdims=True)
        else:
            inds = [EEG_CHANNEL_IND_DICT[ch]
                    for ch in np.atleast_1d(self.reference_channels)]
            ref = x[:, inds].mean(axis=1, keepdims=True)
        self._referenced_data = self._maybe_host(x - ref)
        return self._referenced_data

    def _annotate_amplitude_based_artefacts(
            self, input_data: np.ndarray | None = None,
            min_duration: float = .025,
            max_bad_segments_percent: float = 5.0) -> list[int]:
        """Peak-to-peak artifact detection (reference :960-999).

        A channel sample is artifactual when the peak-to-peak amplitude
        within any ``min_duration`` window exceeds the threshold; channels
        whose artifactual fraction exceeds ``max_bad_segments_percent`` are
        bad.  Returns 0-based indices of bad channels; stores annotations.
        """
        if self.amplitude_rejection_threshold is None:
            raise ValueError(
                "amplitude_rejection_threshold needs to be defined!")
        data = (self.np_referenced_data if input_data is None
                else input_data)
        window = max(2, int(round(min_duration * self.sampling_freq)))
        # (n-w+1, C) exceedance stays on device; only the per-channel
        # fractions and the (n,) any-channel trace come back to host
        exceed_d = _rolling_ptp(jnp.asarray(data, jnp.float32), window) \
            > self.amplitude_rejection_threshold
        bad_fraction = np.asarray(exceed_d.mean(axis=0)) * 100.0
        bad_idx = np.flatnonzero(
            bad_fraction > max_bad_segments_percent).tolist()

        if input_data is None:
            names = self.channel_names
            self._bad_channels = [names[i] for i in bad_idx]
            # merged bad-segment intervals (any channel exceeding)
            any_bad = np.asarray(exceed_d.any(axis=1))
            edges = np.diff(any_bad.astype(int))
            starts = np.flatnonzero(edges == 1) + 1
            ends = np.flatnonzero(edges == -1) + 1
            if any_bad[0]:
                starts = np.r_[0, starts]
            if any_bad[-1]:
                ends = np.r_[ends, len(any_bad)]
            self._bad_annotations = [
                (s / self.sampling_freq, (e + window - 1)
                 / self.sampling_freq) for s, e in zip(starts, ends)]
            if len(bad_idx) == self.n_channels:
                raise ValueError(
                    "current amplitude_rejection_threshold causes all "
                    "channels to be marked as bad!")
        return bad_idx

    @property
    def np_amplitude_compliant_data(self) -> np.ndarray:
        """Data after amplitude annotation (reference :622-639).

        As in the reference, data itself is unchanged — bad channels and
        segments are recorded in :attr:`bad_channels` /
        :attr:`bad_annotations`.
        """
        if self._amplitude_compliant_data is not None:
            return self._amplitude_compliant_data
        if self.amplitude_rejection_threshold is None:
            return self.np_referenced_data
        self._amplitude_compliant_data = self.np_referenced_data
        self._annotate_amplitude_based_artefacts()
        return self._amplitude_compliant_data

    @property
    def bad_channels(self) -> list[str]:
        _ = self.np_amplitude_compliant_data
        return self._bad_channels if self._bad_channels is not None else []

    @property
    def bad_annotations(self) -> list[tuple[float, float]]:
        _ = self.np_amplitude_compliant_data
        return (self._bad_annotations
                if self._bad_annotations is not None else [])

    @property
    def ica_result(self) -> InfomaxICA:
        """Fitted extended-Infomax ICA (reference :654-682)."""
        if self._ica_result is not None:
            return self._ica_result
        if self.n_ica_components is None:
            raise ValueError("n_ica_components needs to be defined!")
        if self.modality == 'emg':
            raise ValueError(
                "ica fitting only works (and is only intended) for EEG "
                "data.")
        ica = InfomaxICA(n_components=self.n_ica_components,
                         random_state=42)
        ica.fit(self.np_amplitude_compliant_data)
        self._ica_result = ica
        return self._ica_result

    # reference-compatible alias
    mne_ica_result = ica_result

    @property
    def ica_automatic_labels(self) -> dict:
        if self._ica_automatic_labels is None:
            self._ica_automatic_labels = label_components(
                self.ica_result, self.np_amplitude_compliant_data,
                self.sampling_freq, channel_names=self.channel_names)
        return self._ica_automatic_labels

    @property
    def np_artefact_free_data(self) -> np.ndarray:
        """ICA-cleaned data (reference :685-748).

        Skipped when ``n_ica_components`` is None or for EMG data.
        Automatically-labeled {'heart beat', 'muscle artifact',
        'channel noise', 'eye blink'} components plus
        ``manual_ics_to_exclude`` are removed.
        """
        if self._artefact_free_data is not None:
            return self._artefact_free_data
        if self.n_ica_components is None or self.modality == 'emg':
            return self.np_amplitude_compliant_data
        exclusion = list(self.manual_ics_to_exclude)
        if self.automatic_ic_labelling:
            labels = self.ica_automatic_labels['labels']
            to_exclude = ('heart beat', 'muscle artifact', 'channel noise',
                          'eye blink')
            auto = [i for i, lab in enumerate(labels) if lab in to_exclude]
            exclusion += auto
        self.ica_result.exclude = sorted(set(exclusion))
        self._artefact_free_data = self._maybe_host(self.ica_result.apply(
            self.np_amplitude_compliant_data, self.ica_result.exclude))
        return self._artefact_free_data

    def get_neighboring_electrodes_mapping(self) -> list[list[int]]:
        """Neighbors within the Laplacian radius (reference :922-944)."""
        if self.laplacian_filter_neighbor_radius is None:
            raise ValueError(
                "laplacian_filter_neighbor_radius needs to be defined!")
        pos = self.electrode_positions
        neighbors = []
        for i, p in enumerate(pos):
            dists = np.linalg.norm(pos - p, axis=1)
            neighbors.append(np.where(
                (dists > 0)
                & (dists < self.laplacian_filter_neighbor_radius)
            )[0].tolist())
        return neighbors

    @property
    def np_spatially_filtered_data(self) -> np.ndarray:
        """Laplacian spatial filter as ONE adjacency matmul (ref :751-781).

        The reference's per-channel Python loop becomes
        ``x − x @ Wᵀ`` with W the row-normalised neighbor matrix — an
        matmul-friendly (T, C) × (C, C) product.
        """
        if self._spatially_filtered_data is not None:
            return self._spatially_filtered_data
        if self.laplacian_filter_neighbor_radius is None:
            return self.np_artefact_free_data
        neighbors = self.get_neighboring_electrodes_mapping()
        c = self.n_channels
        w = np.zeros((c, c), dtype=np.float32)
        for i, neigh in enumerate(neighbors):
            if neigh:
                w[i, neigh] = 1.0 / len(neigh)
        x = jnp.asarray(self.np_artefact_free_data, jnp.float32)
        out = x - x @ jnp.asarray(w).T
        self._spatially_filtered_data = self._maybe_host(out)
        return self._spatially_filtered_data

    @property
    def np_denoised_data(self) -> np.ndarray:
        """Wavelet-shrinkage denoised data (reference :784-873)."""
        if self._denoised_data is not None:
            return self._denoised_data
        if self.wavelet_type is None:
            return self.np_spatially_filtered_data
        self._denoised_data = self._maybe_host(wavelet_denoise(
            self.np_spatially_filtered_data, self.wavelet_type,
            mode=self.denoising_threshold_mode))
        return self._denoised_data

    @property
    def np_output_data(self) -> np.ndarray:
        """Full pipeline output (reference :876-905)."""
        if self._output_data is not None:
            return self._output_data
        self._output_data = self.np_denoised_data
        return self._output_data

    def free_intermediate_stages(self) -> np.ndarray:
        """Materialize ``np_output_data``, then drop every cached
        intermediate stage array.

        In ``device_resident`` mode each cached stage pins a full
        recording-sized buffer in HBM (~0.9 GB at 28 min × 64 ch ×
        2048 Hz); a study-scale cascade holds five to six of them, which
        starves downstream feature extraction.  Call this once the
        cascade output is all a consumer needs: the output (and the
        small diagnostics — bad channels/annotations, ICA solution,
        labels) survive, and any intermediate requested later is
        recomputed lazily from the retained input.  Returns the output.
        """
        out = self.np_output_data
        self._filtered_data = None
        self._referenced_data = None
        self._amplitude_compliant_data = None
        self._artefact_free_data = None
        self._spatially_filtered_data = None
        self._denoised_data = None
        self._output_data = out
        return out

    # ------------------------------------------------------------------
    # invalidation truth table (reference :1001-1110)
    # ------------------------------------------------------------------
    def clean_downstream_results(self, change_in: str):
        change_in = change_in.lower()
        if change_in not in _STAGES:
            raise ValueError(
                f"change_in category: '{change_in}' is undefined!")
        # 'ica computation' also invalidates everything the reference does
        start = _STAGES.index(change_in)
        for stage in _STAGES[start:]:
            for attr in _STAGE_ATTRS[stage]:
                setattr(self, attr, None)
        # downstream array results always cleared:
        for attr in ['_artefact_free_data', '_spatially_filtered_data',
                     '_denoised_data', '_output_data']:
            setattr(self, attr, None)
        if start <= _STAGES.index('amplitude thresholding'):
            self._ica_result = None
            self._ica_automatic_labels = None

    # ------------------------------------------------------------------
    # validation suite (reference :1113-1269)
    # ------------------------------------------------------------------
    def validate_filtering(self, target_freq: float = 21.5,
                           freq_window: float = 8.5,
                           verbose: bool = True):
        """SNR + PSD change in the target band due to filtering."""
        input_snr = spectral_snr(
            self.np_input_data, self.sampling_freq,
            target_freq=target_freq, freq_window=freq_window)
        filtered_snr = spectral_snr(
            self.np_filtered_data, self.sampling_freq,
            target_freq=target_freq, freq_window=freq_window)
        snr_improvement = filtered_snr - input_snr

        from mba_tpu.ops.spectral import welch_psd
        freqs, raw_psd = welch_psd(self.np_input_data, self.sampling_freq,
                                   nperseg=int(self.sampling_freq * 4))
        _, filt_psd = welch_psd(self.np_filtered_data, self.sampling_freq,
                                nperseg=int(self.sampling_freq * 4))
        band = ((freqs < target_freq + freq_window)
                & (freqs > target_freq - freq_window))
        psd_difference = float(10 * np.log10(filt_psd[band].mean())
                               - 10 * np.log10(raw_psd[band].mean()))
        if verbose:
            print(f'[VALIDATION] Target-band SNR improvement due to '
                  f'filtering: {snr_improvement:.3f} dB')
            print(f'[VALIDATION] Target-band PSD difference due to '
                  f'filtering: {psd_difference:.3f} dB')
        return snr_improvement, psd_difference

    def validate_referencing(self, target_freq: float = 21.5,
                             freq_window: float = 8.5,
                             verbose: bool = True) -> float:
        input_snr = spectral_snr(
            self.np_filtered_data, self.sampling_freq,
            target_freq=target_freq, freq_window=freq_window)
        ref_snr = spectral_snr(
            self.np_referenced_data, self.sampling_freq,
            target_freq=target_freq, freq_window=freq_window)
        improvement = ref_snr - input_snr
        if verbose:
            print(f'[VALIDATION] Target-band SNR improvement due to '
                  f'referencing: {improvement:.3f} dB')
        return improvement

    def validate_amplitude_thresholding(self, n_runs: int = 10,
                                        verbose: bool = True):
        """Surrogate bad-channel specificity/selectivity (ref :1176-1210)."""
        all_channels = list(range(self.n_channels))
        spec_list, sel_list = [], []
        rng = np.random.default_rng(0)
        for _ in range(n_runs):
            surrogate, amended = surrogation.insert_bad_channels(
                self.np_referenced_data, axis=0, scale_range=(5, 15),
                rng=rng)
            amended0 = [ch - 1 for ch in amended]  # returned inds 1-based
            unchanged = [ch for ch in all_channels if ch not in amended0]
            detected = self._annotate_amplitude_based_artefacts(
                input_data=surrogate)
            fp = [ch for ch in unchanged if ch in detected]
            tp = [ch for ch in amended0 if ch in detected]
            fn = [ch for ch in amended0 if ch not in detected]
            tn = [ch for ch in unchanged if ch not in detected]
            spec_list.append(len(tn) / max(len(tn) + len(fp), 1))
            sel_list.append(len(tp) / max(len(tp) + len(fn), 1))
        specificity = float(np.nanmean(spec_list))
        selectivity = float(np.nanmean(sel_list))
        if verbose:
            print(f'[VALIDATION] Amplitude-Thresholding for Bad Channel '
                  f'Detection:\n\tSpecificity (true neg.): '
                  f'{specificity:.3f}\n\tSelectivity (true pos.): '
                  f'{selectivity:.3f}')
        return specificity, selectivity

    def validate_spatial_filtering(self, verbose: bool = True) -> float:
        """Neighbor-coherence change due to the Laplacian (ref :1214-1248).

        The reference's per-pair scipy loops ('~2-5 s per electrode')
        become two batched multitaper-MSC calls on the device.
        """
        neighbors = self.get_neighboring_electrodes_mapping()
        results = []
        for data in (self.np_artefact_free_data,
                     self.np_spatially_filtered_data):
            res = multitaper_msc(
                data, data, self.sampling_freq, window_length_sec=1.0,
                use_jackknife=False, apply_independence_threshold=False)
            coh = res["coherence_raw"].mean(axis=(0, 1))   # (C, C)
            per_channel = [np.nanmean(coh[i, neigh]) if neigh else np.nan
                           for i, neigh in enumerate(neighbors)]
            results.append(float(np.nanmean(per_channel)))
        before, after = results
        if verbose:
            print(f"[VALIDATION] Local Mag.Sq. Coherence BEFORE spatial "
                  f"filtering: {before:.3f}")
            print(f"[VALIDATION] Local Mag.Sq. Coherence AFTER spatial "
                  f"filtering: {after:.3f}")
        return after - before

    def validate_wavelet_denoising(self, target_freq: float = 21.5,
                                   freq_window: float = 8.5,
                                   verbose: bool = True) -> float:
        input_snr = spectral_snr(
            self.np_spatially_filtered_data, self.sampling_freq,
            target_freq=target_freq, freq_window=freq_window)
        out_snr = spectral_snr(
            self.np_denoised_data, self.sampling_freq,
            target_freq=target_freq, freq_window=freq_window)
        improvement = out_snr - input_snr
        if verbose:
            print(f'[VALIDATION] Target-band SNR improvement due to '
                  f'wavelet denoising: {improvement:.3f} dB')
        return improvement

    def describe(self) -> str:
        return (f"BiosignalPreprocessor ({self.modality}, "
                f"{self.sampling_freq} Hz, {self.n_timesteps} x "
                f"{self.n_channels})")

    __str__ = __repr__ = describe


def import_npy_with_config(file_title: str, data_dir,
                           load_only_first_n_seconds: int | None = None,
                           sampling_rate_Hz: int = 2048,
                           retrieve_latest_config: bool = True,
                           bad_channel_treatment: Literal['None', 'Zero']
                           = 'Zero',
                           channel_subset_inds: list[int] | None = None):
    """Load a 'Preprocessed …' artifact + its config (reference :1309-1357).

    Bad channels recorded in the config are zeroed by default.
    """
    print(f'Searching most recent file {file_title} in {data_dir}...')
    path = filemgmt.most_recent_file(data_dir, ".npy",
                                     [file_title, "Preprocessed"])
    file = np.load(path)
    if load_only_first_n_seconds is not None:
        file = file[:sampling_rate_Hz * int(load_only_first_n_seconds), :]

    config = None
    if retrieve_latest_config:
        try:
            config_file = filemgmt.most_recent_file(data_dir, ".json",
                                                    [file_title])
            with open(config_file, "r") as f:
                config = json.load(f)
        except ValueError:
            print(f"No config file found for {file_title}")
    if config is None:
        config = {'sampling_freq': sampling_rate_Hz, 'bad_channels': [],
                  'modality': 'eeg'}

    if bad_channel_treatment == 'Zero' and config.get('bad_channels'):
        print(f"Setting the following channels to 0: "
              f"{config['bad_channels']}")
        if config.get('modality') == "eeg":
            remove = [EEG_CHANNEL_IND_DICT[ch]
                      for ch in config['bad_channels']]
        else:
            remove = [int(ch[-2:]) for ch in config['bad_channels']]
        file = file.copy()
        file[:, remove] = 0.0

    if channel_subset_inds is not None:
        file = file[:, channel_subset_inds]
        print("Selecting channel subset: ", channel_subset_inds)
    print("Resulting file shape: ", file.shape, "\n")
    return file, config
