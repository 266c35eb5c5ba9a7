"""Surrogate-data generation and batched null-distribution estimation.

Covers and extends reference ``src/pipeline/data_surrogation.py``:

- :func:`insert_bad_channels`   ↔ data_surrogation.py:19-65
- :func:`add_noise_to_channels` ↔ data_surrogation.py:69-148
- :func:`generate_noise`        ↔ data_surrogation.py:151-198
- :func:`phase_randomize`       — FFT phase-randomised surrogates (the
  north-star extension; the reference has no phase-randomisation, its nulls
  come from the Beta(K−2,K−2) analytic threshold — BASELINE.md).
- :func:`msc_phase_randomized_null` — batched 10k-surrogate coherence nulls:
  thousands of sign/phase-randomised realisations evaluated per device with
  an on-line quantile reduction so the null tensor never materialises.

All heavy paths are jitted; surrogate realisations ride a leading batch axis
(``vmap``) and chunked ``lax.map`` bounds peak HBM.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from mba_tpu.ops.dpss import filtered_tapers
from mba_tpu.ops.framing import frame_signal, window_grid

_F32_TINY = np.float32(np.finfo(np.float32).tiny)


# --------------------------------------------------------------------------
# Reference-parity fault injection (host-side, numpy)
# --------------------------------------------------------------------------
def insert_bad_channels(input_array: np.ndarray, axis=None,
                        n_channels: int = 5,
                        scale_range: tuple[float, float] = (10.0, 15.0),
                        rng: np.random.Generator | None = None,
                        ) -> tuple[np.ndarray, list[int]]:
    """Scale random channels to simulate bad channels.

    Parity: reference data_surrogation.py:19-65 — channels are drawn from
    index range [1, n_channels_total), scaled by a uniform factor, and the
    returned indices are 1-based.
    """
    if input_array.ndim == 1:
        input_array = input_array[:, None]
        axis = 0
    elif axis is None:
        raise AttributeError("For 2D signal arrays, axis needs to be defined!")
    rng = rng or np.random.default_rng()
    channel_axis = (axis + 1) % 2
    output = input_array.copy()
    picked = rng.choice(np.arange(1, input_array.shape[channel_axis]),
                        size=n_channels, replace=False)
    amended = []
    for ch in picked:
        factor = scale_range[0] + rng.random() * (scale_range[1]
                                                  - scale_range[0])
        output[:, ch] = input_array[:, ch] * factor
        amended.append(int(ch) + 1)
    return output, amended


def generate_noise(shape: tuple, noise_type: str, amplitude: float,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """White or pink (1/f) noise at a target RMS amplitude.

    Parity: reference data_surrogation.py:151-198 (pink noise via 1/sqrt(f)
    rFFT shaping, identical across channels).
    """
    rng = rng or np.random.default_rng()
    if noise_type == "white":
        noise = rng.normal(0, 1, shape)
    elif noise_type == "pink":
        white_fft = np.fft.rfft(rng.normal(0, 1, shape[0]))
        freqs = np.fft.rfftfreq(shape[0])
        freqs[0] = 1
        noise = np.fft.irfft(white_fft / np.sqrt(freqs), n=shape[0])
        if len(shape) > 1:
            noise = np.tile(noise[:, None], (1, shape[1]))
    else:
        raise ValueError(f"Unknown noise_type: {noise_type}")
    return noise * (amplitude / np.sqrt(np.mean(noise ** 2)))


def add_noise_to_channels(input_array: np.ndarray, noise_db: float,
                          channels: list[int], axis: int = 0,
                          noise_type: str = "white",
                          random_seed: int | None = None) -> np.ndarray:
    """Add noise at a target SNR (dB) to selected channels.

    Parity: reference data_surrogation.py:69-148.
    """
    rng = np.random.default_rng(random_seed)
    arr = input_array.copy()
    if arr.ndim == 1:
        arr = arr[:, None]
    n_ch = arr.shape[1 - axis]
    if not all(0 <= ch < n_ch for ch in channels):
        raise ValueError(f"Channel indices must be in range [0, {n_ch - 1}]")
    for ch in channels:
        sig = arr[:, ch] if axis == 0 else arr[ch, :]
        signal_power = np.mean(sig ** 2)
        noise_rms = np.sqrt(signal_power / 10 ** (noise_db / 10))
        noise = generate_noise(sig.shape, noise_type, noise_rms, rng)
        if axis == 0:
            arr[:, ch] = sig + noise
        else:
            arr[ch, :] = sig + noise
    return arr


# --------------------------------------------------------------------------
# FFT phase-randomised surrogates (jitted)
# --------------------------------------------------------------------------
def phase_randomize(key, x: jnp.ndarray, n_surrogates: int) -> jnp.ndarray:
    """FFT phase-randomised surrogates of ``x`` (n_samples, n_channels).

    Preserves the amplitude spectrum (hence PSD and autocorrelation) while
    destroying cross-signal phase relationships — the canonical coherence
    null.  DC and Nyquist bins keep zero phase so the output stays real.
    Channels share the rotation within one surrogate? No — each channel gets
    independent phases, which is the correct null for *cross* coherence.

    Returns (n_surrogates, n_samples, n_channels).
    """
    n = x.shape[0]
    xf = jnp.fft.rfft(x, axis=0)                      # (F, C)
    n_freqs = xf.shape[0]
    phases = jax.random.uniform(
        key, (n_surrogates, n_freqs) + x.shape[1:],
        minval=0.0, maxval=2 * jnp.pi)
    # keep DC (and Nyquist if present) unrotated:
    mask = jnp.ones((n_freqs,), dtype=bool).at[0].set(False)
    if n % 2 == 0:
        mask = mask.at[-1].set(False)
    mask = mask[None, :, None] if x.ndim == 2 else mask[None, :]
    # build the unit rotation via lax.complex on real parts
    rot = jax.lax.complex(jnp.where(mask, jnp.cos(phases), 1.0),
                          jnp.where(mask, jnp.sin(phases), 0.0))
    return jnp.fft.irfft(xf[None] * rot, n=n, axis=1)


@functools.partial(jax.jit, static_argnames=("n_surrogates",))
def _phase_randomize_jit(key, x, n_surrogates):
    return phase_randomize(key, x, n_surrogates)


@functools.partial(jax.jit, static_argnames=("window_samples",))
def _observed_msc_jit(eeg_frames, emg, starts, tapers, inv_fs_n,
                      window_samples):
    mf = frame_signal(emg, starts, window_samples)
    return _msc_spectrum_mean(eeg_frames, mf, tapers, inv_fs_n)


@functools.partial(jax.jit, static_argnames=("window_samples", "chunk",
                                              "vmap_width"))
def _surrogate_chunk_jit(key, eeg_frames, emg, starts, tapers, inv_fs_n,
                         window_samples, chunk, vmap_width=8):
    """One chunk of phase-randomised surrogates → (chunk, F, E, M) MSC.

    Surrogates are processed in ``vmap_width``-wide batches (one fused FFT
    program over the surrogate×window×taper axes) scanned via ``lax.map`` so
    arbitrary chunk sizes stay within HBM.
    """
    surr = phase_randomize(key, emg, chunk)          # (chunk, n, M)
    width = min(vmap_width, chunk)
    n_pad = (-chunk) % width
    surr = jnp.pad(surr, [(0, n_pad), (0, 0), (0, 0)])
    groups = surr.reshape((-1, width) + surr.shape[1:])

    def one(s):
        mf = frame_signal(s, starts, window_samples)
        return _msc_spectrum_mean(eeg_frames, mf, tapers, inv_fs_n)

    out = jax.lax.map(jax.vmap(one), groups)
    return out.reshape((-1,) + out.shape[2:])[:chunk]


@functools.partial(jax.jit, static_argnames=("n_cells", "n_bins"))
def _hist_accumulate_jit(spectra, hist_in, n_cells, n_bins):
    idx = jnp.clip((spectra * n_bins).astype(jnp.int32), 0, n_bins - 1)
    cell = jnp.arange(n_cells, dtype=jnp.int32).reshape(spectra.shape[1:])
    flat = (cell[None] * n_bins + idx).reshape(-1)
    return hist_in + jnp.bincount(flat, length=n_cells * n_bins)


def _auto_vmap_width(n_windows: int, window_samples: int, K: int,
                     n_eeg: int, n_emg: int, chunk: int,
                     budget_bytes: float = 2.5e9) -> int:
    """Surrogate batch width bounding transient HBM.

    Per surrogate the chunk kernel materialises the framed EMG, the
    taper spectra and the MSC grid; a fixed narrow width under-fills the
    device for few-channel cases, while a large width would exhaust
    device memory at 64x64.
    """
    n_freqs = window_samples // 2 + 1
    per_surr = n_windows * (window_samples * n_emg * 4
                            + K * n_freqs * (n_eeg + n_emg) * 8
                            + n_freqs * n_eeg * n_emg * 4)
    return int(max(1, min(chunk, budget_bytes // max(per_surr, 1))))


def _make_sharded_null_step(mesh, window_samples: int, chunk: int,
                            n_cells: int, n_bins: int,
                            max_stat_only: bool, vmap_width: int = 8):
    """shard_map step: surrogate chunks split over every mesh device.

    Same chunk kernel (``_surrogate_chunk_jit``) and histogram accumulator
    as the single-device loop — one engine, one code path; the per-cell
    histogram increment is psum-reduced over the surrogate axis.
    """
    from jax.sharding import Mesh as _Mesh, PartitionSpec as _P
    from jax import shard_map as _shard_map

    flat = _Mesh(mesh.devices.reshape(-1), ("surr",))
    n_dev = flat.devices.size

    def per_device(keys, eeg_frames, emg, starts, tapers, inv, fmask, hist):
        spectra = _surrogate_chunk_jit(keys[0], eeg_frames, emg, starts,
                                       tapers, inv, window_samples, chunk,
                                       vmap_width=vmap_width)
        # max statistic over valid band only (coherence >= 0 so a zero
        # mask removes a cell from the max)
        ms = (spectra * fmask[None, :, None, None]).max(axis=(1, 2, 3))
        if max_stat_only:
            return ms, hist
        inc = _hist_accumulate_jit(spectra, jnp.zeros_like(hist),
                                   n_cells, n_bins)
        return ms, hist + jax.lax.psum(inc, "surr")

    fn = _shard_map(per_device, mesh=flat,
                    in_specs=(_P("surr"), _P(), _P(), _P(), _P(), _P(),
                              _P(), _P()),
                    out_specs=(_P("surr"), _P()))
    return jax.jit(fn), flat, n_dev


def _msc_spectrum_mean(eeg_frames, emg_frames, tapers, inv_fs_n):
    """Window-averaged MSC spectrum: (W,S,E),(W,S,M) → (F, E, M)."""
    K = tapers.shape[0]
    E = jnp.fft.rfft(eeg_frames[:, None] * tapers[None, :, :, None], axis=2)
    M = jnp.fft.rfft(emg_frames[:, None] * tapers[None, :, :, None], axis=2)
    pe = ((E.real ** 2 + E.imag ** 2) * inv_fs_n).sum(axis=1) / K
    pm = ((M.real ** 2 + M.imag ** 2) * inv_fs_n).sum(axis=1) / K
    cs = (jnp.conj(E)[..., :, None] * M[..., None, :] * inv_fs_n
          ).sum(axis=1) / K
    num = cs.real ** 2 + cs.imag ** 2
    den = jnp.maximum(pe[..., :, None] * pm[..., None, :], _F32_TINY)
    coh = jnp.clip(num / den, 0.0, 1.0)             # (W, F, E, M)
    return coh.mean(axis=0)                          # (F, E, M)


def _null_freq_mask(freqs: np.ndarray, window_samples: int,
                    band: tuple[float, float] | None) -> np.ndarray:
    """Frequency mask for the null max statistic.

    DC — and Nyquist when the window length is even — are ALWAYS
    excluded BY INDEX, matching :func:`phase_randomize`'s unrotated
    bins: a float comparison against fs/2 misses the Nyquist bin for
    many sampling rates (rfftfreq rounding puts it strictly below
    fs/2, e.g. fs=93 with a 0.5-s window).  ``band`` optionally
    restricts further.
    """
    mask = np.ones(len(freqs), dtype=bool)
    mask[0] = False
    if window_samples % 2 == 0:
        mask[-1] = False
    if band is not None:
        mask &= (freqs >= band[0]) & (freqs <= band[1])
    if not mask.any():
        raise ValueError(f"band {band} selects no valid frequencies")
    return mask


def msc_phase_randomized_null(
        eeg: np.ndarray,
        emg: np.ndarray,
        sampling_freq: float,
        n_surrogates: int = 10_000,
        nw: float = 3,
        window_length_sec: float = 1.0,
        overlap_frac: float = 0.5,
        taper_eigenvalue_threshold: float = 0.90,
        band: tuple[float, float] | None = None,
        quantiles=(0.95, 0.99),
        surrogate_chunk: int = 64,
        seed: int = 0,
        max_stat_only: bool = False,
        mesh=None,
) -> dict:
    """Phase-randomised coherence null thresholds.

    For each surrogate the EMG signals' Fourier phases are randomised (EEG
    kept fixed — randomising one side suffices to break cross-coherence),
    the full window-averaged MSC spectrum is computed, and per-frequency
    (and global-max) null statistics are accumulated on-line.

    ``band``: optional (lo, hi) Hz restriction for the *max statistic*
    (and ``p_fwe``).  DC and Nyquist are ALWAYS excluded from the max:
    phase randomisation keeps those (real-valued) bins unrotated, so
    coherence there is not destroyed under the null — and after
    high-pass filtering their vanishing power makes the MSC ratio
    numerically meaningless.  The per-cell ``null_quantiles`` and
    ``observed`` keep the full frequency grid.

    ``mesh``: optional ``jax.sharding.Mesh`` — the surrogate axis is split
    over every device in the mesh (each draws its own chunk; the per-cell
    histogram is psum-reduced), running the identical chunk kernel as the
    single-device path.

    Returns dict with:
      - ``null_quantiles``: {q: (F, E, M) array} per-frequency-pair
        coherence thresholds (or scalars if ``max_stat_only``)
      - ``max_stat``: (n_surrogates,) distribution of the in-band max
        coherence per surrogate (for FWE-corrected thresholds)
      - ``observed``: (F, E, M) observed window-averaged MSC
      - ``observed_max``: float, in-band max of ``observed``
      - ``p_fwe``: (1 + #{max_stat >= observed_max}) / (1 + n_surrogates)
      - ``freqs``
    """
    eeg = np.asarray(eeg, np.float32)
    emg = np.asarray(emg, np.float32)
    if eeg.ndim == 1:          # promote single channels like multitaper_psd
        eeg = eeg[:, None]
    if emg.ndim == 1:
        emg = emg[:, None]
    n_samples = eeg.shape[0]
    window_samples = int(window_length_sec * sampling_freq)
    hop = int(window_samples * (1 - overlap_frac))
    tapers = jnp.asarray(
        filtered_tapers(window_samples, nw, taper_eigenvalue_threshold),
        dtype=jnp.float32)
    starts, _ = window_grid(n_samples, window_samples, hop, sampling_freq,
                            convention="cmc")
    starts_j = jnp.asarray(starts, jnp.int32)
    inv_fs_n = np.float32(1.0 / (sampling_freq * window_samples))
    freqs = np.fft.rfftfreq(window_samples, d=1.0 / sampling_freq)

    fmask_np = _null_freq_mask(freqs, window_samples, band)
    fmask = jnp.asarray(fmask_np, jnp.float32)

    # stage timers: upload, observed map and null are timed apart
    import time as _time
    t_up0 = _time.perf_counter()
    eeg_j = jnp.asarray(eeg)
    emg_j = jnp.asarray(emg)
    jax.block_until_ready((eeg_j, emg_j))
    t_upload = _time.perf_counter() - t_up0
    t_ob0 = _time.perf_counter()
    eeg_frames = frame_signal(eeg_j, starts_j, window_samples)

    observed = np.asarray(_observed_msc_jit(
        eeg_frames, emg_j, starts_j, tapers, inv_fs_n, window_samples))
    t_observed = _time.perf_counter() - t_ob0
    t_null0 = _time.perf_counter()

    key = jax.random.PRNGKey(seed)
    max_stats = []
    # on-line per-(freq, pair) quantiles via histogram accumulation
    # (coherence ∈ [0,1]) — scatter-add so the null tensor of shape
    # (n_surrogates, F, E, M) never materialises.
    n_bins = 1024
    n_freqs = len(freqs)
    n_cells = n_freqs * eeg.shape[1] * emg.shape[1]
    hist = None

    # always run full-size chunks so exactly ONE surrogate program is
    # compiled per configuration; surplus surrogates in the final chunk
    # still enter the histogram (equally valid null draws) and the CDF is
    # normalised by the true total.
    chunk = int(min(surrogate_chunk, n_surrogates))
    vw = _auto_vmap_width(len(starts), window_samples,
                          int(tapers.shape[0]), eeg.shape[1],
                          emg.shape[1], chunk)
    n_hist_total = 0
    done = 0
    if mesh is not None:
        step, flat_mesh, n_dev = _make_sharded_null_step(
            mesh, window_samples, chunk, n_cells, n_bins, max_stat_only,
            vmap_width=vw)
        from jax.sharding import NamedSharding, PartitionSpec as _P
        rep = NamedSharding(flat_mesh, _P())
        key_shard = NamedSharding(flat_mesh, _P("surr"))
        eeg_frames = jax.device_put(eeg_frames, rep)
        emg_j = jax.device_put(emg_j, rep)
        starts_d = jax.device_put(starts_j, rep)
        tapers_d = jax.device_put(tapers, rep)
        hist = jax.device_put(
            jnp.zeros(1 if max_stat_only else n_cells * n_bins,
                      jnp.int32), rep)
        inv_d = jax.device_put(jnp.float32(inv_fs_n), rep)
        fmask_d = jax.device_put(fmask, rep)
        while done < n_surrogates:
            key, sub = jax.random.split(key)
            keys = jax.device_put(jax.random.split(sub, n_dev), key_shard)
            ms, hist = step(keys, eeg_frames, emg_j, starts_d, tapers_d,
                            inv_d, fmask_d, hist)
            take = min(n_dev * chunk, n_surrogates - done)
            max_stats.append(np.asarray(ms)[:take])
            n_hist_total += n_dev * chunk
            done += take
        if max_stat_only:
            hist = None
    else:
        while done < n_surrogates:
            key, sub = jax.random.split(key)
            spectra = _surrogate_chunk_jit(sub, eeg_frames, emg_j,
                                           starts_j, tapers, inv_fs_n,
                                           window_samples, chunk,
                                           vmap_width=vw)
            take = min(chunk, n_surrogates - done)
            ms = (spectra * fmask[None, :, None, None]).max(axis=(1, 2, 3))
            max_stats.append(np.asarray(ms)[:take])
            if not max_stat_only:
                if hist is None:
                    hist = jnp.zeros(n_cells * n_bins, dtype=jnp.int32)
                hist = _hist_accumulate_jit(spectra, hist, n_cells, n_bins)
                n_hist_total += chunk
            done += take

    max_stat = np.concatenate(max_stats)
    t_null = _time.perf_counter() - t_null0
    observed_max = float(observed[fmask_np].max())
    p_fwe = float((1.0 + (max_stat >= observed_max).sum())
                  / (1.0 + len(max_stat)))
    result = {"max_stat": max_stat, "observed": observed, "freqs": freqs,
              "observed_max": observed_max, "p_fwe": p_fwe,
              "timings": {"upload_sec": round(t_upload, 3),
                          "observed_sec": round(t_observed, 3),
                          "null_sec": round(t_null, 3),
                          "upload_bytes": int(eeg.nbytes + emg.nbytes)},
              "null_quantiles": {}}
    if not max_stat_only:
        hist = hist.reshape((n_freqs, eeg.shape[1], emg.shape[1], n_bins))
        cdf = jnp.cumsum(hist, axis=-1) / n_hist_total
    for q in quantiles:
        if max_stat_only:
            result["null_quantiles"][q] = float(np.quantile(max_stat, q))
        else:
            qidx = (cdf < q).sum(axis=-1)               # first bin ≥ q
            result["null_quantiles"][q] = np.asarray(
                (qidx + 1) / n_bins, dtype=np.float32)
    return result
