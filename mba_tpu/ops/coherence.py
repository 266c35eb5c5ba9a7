"""Fused multitaper magnitude-squared coherence (CMC) kernel.

Parity target: reference signal_features.py:619-839
(``multitaper_magnitude_squared_coherence``) + :484-578
(``jackknife_coherence_and_ci``) — the single most expensive computation in
the reference (SURVEY.md §3.3).

Design
------
The reference runs a Python loop over ~2 800 windows; per window it loops K
tapers accumulating PSD/CSD, then re-runs a K×(K−1) leave-one-out loop for
the jackknife.  Here:

- Windows are a batch axis; a chunk of windows is one fused XLA program
  (taper multiply → batched rFFT → cross-spectral outer product → coherence
  → jackknife → CI) with no host round-trips.
- The jackknife is computed **algebraically**: with per-taper PSD/CSD terms
  ``x_k`` and their sum ``S``, every leave-one-out replicate is
  ``(S − x_k)/(K−1)``.  This removes the reference's K× recompute while
  producing bit-identical replicates (same floating-point formula, summed
  once).
- The EMG-axis max aggregation of ``compute_task_wise_aggregated_cmc``
  (signal_features.py:992-1004 → 1132-1171) can be fused into the kernel
  (``aggregate_emg_max=True``) so the huge 4-D (windows, freqs, EEG, EMG)
  tensor never leaves the device.

Conventions copied from the reference:
- taper set: k = 2·nw − 1 DPSS tapers, eigenvalue-filtered λ > 0.9,
  L2-normalised (signal_features.py:669-678);
- PSD = |rfft|²/(fs·N), CSD = conj(EEG)·EMG/(fs·N), **no** one-sided
  doubling (signal_features.py:750-760);
- coherence = |CSD̄|²/max(PSD̄ₑ·PSD̄ₘ, tiny) clipped to [0, 1];
- jackknife: mean in coherence space, variance in Fisher-z space, Student-t
  CI, CI clamped to contain the mean (signal_features.py:554-576).
"""
from __future__ import annotations

import functools
import time
from typing import Literal

import numpy as np
import jax
import jax.numpy as jnp
from scipy.stats import t as _t_dist

from mba_tpu.ops.dpss import (dpss_windows, filtered_tapers,
                              cmc_independence_threshold_host)
from mba_tpu.ops.framing import frame_signal, window_grid

_F32_TINY = np.float32(np.finfo(np.float32).tiny)
_FISHER_EPS = np.float32(1e-10)


def fisher_atanh(coherence, eps: float = 1e-10):
    """Forward Fisher atanh: C² → z (reference signal_features.py:459-462)."""
    c = jnp.clip(coherence, eps, 1 - eps)
    return 0.5 * jnp.log((1 + c) / (1 - c))


def inverse_fisher_atanh(z):
    """Inverse Fisher atanh: z → C² (reference signal_features.py:465-467)."""
    return jnp.tanh(z) ** 2


def cmc_independence_threshold(K: int, alpha: float = 0.05) -> float:
    """(1−alpha) quantile of the Beta(K−2, K−2) independence null."""
    return cmc_independence_threshold_host(K, alpha)


@functools.partial(
    jax.jit,
    static_argnames=("use_jackknife", "aggregate_emg_max"))
def _msc_chunk_kernel(eeg_frames, emg_frames, tapers, inv_fs_n, t_crit,
                      use_jackknife: bool, aggregate_emg_max: bool):
    """Coherence for one chunk of windows.

    eeg_frames: (w, S, E); emg_frames: (w, S, M); tapers: (K, S).
    Returns dict of (w, F, E, M) arrays — or (w, F, E) when
    ``aggregate_emg_max`` (indices aligned across mean/lower/upper exactly as
    max_cmc_spectrograms_over_channels, signal_features.py:1132-1171).
    """
    K = tapers.shape[0]
    # taper-expanded spectra: (w, K, F, ch)
    eeg_fft = jnp.fft.rfft(
        eeg_frames[:, None, :, :] * tapers[None, :, :, None], axis=2)
    emg_fft = jnp.fft.rfft(
        emg_frames[:, None, :, :] * tapers[None, :, :, None], axis=2)

    psd_e_k = (eeg_fft.real ** 2 + eeg_fft.imag ** 2) * inv_fs_n  # (w,K,F,E)
    psd_m_k = (emg_fft.real ** 2 + emg_fft.imag ** 2) * inv_fs_n  # (w,K,F,M)
    csd_k = (jnp.conj(eeg_fft)[..., :, None] * emg_fft[..., None, :]
             ) * inv_fs_n                                          # (w,K,F,E,M)

    sum_e = psd_e_k.sum(axis=1)          # (w,F,E)
    sum_m = psd_m_k.sum(axis=1)          # (w,F,M)
    sum_c = csd_k.sum(axis=1)            # (w,F,E,M)

    def _coh(csd, pe, pm):
        num = csd.real ** 2 + csd.imag ** 2
        den = jnp.maximum(pe[..., :, None] * pm[..., None, :], _F32_TINY)
        return jnp.clip(num / den, 0.0, 1.0)

    coherence_raw = _coh(sum_c / K, sum_e / K, sum_m / K)

    if not use_jackknife:
        out = {"coherence": coherence_raw}
        if aggregate_emg_max:
            out = {"coherence": coherence_raw.max(axis=-1)}
        return out

    # ---- algebraic leave-one-out jackknife over the taper axis ----
    inv_km1 = 1.0 / (K - 1)
    loo_c = (sum_c[:, None] - csd_k) * inv_km1       # (w,K,F,E,M)
    loo_e = (sum_e[:, None] - psd_e_k) * inv_km1     # (w,K,F,E)
    loo_m = (sum_m[:, None] - psd_m_k) * inv_km1     # (w,K,F,M)
    coh_k = _coh(loo_c, loo_e, loo_m)                # (w,K,F,E,M)

    coherence_mean = jnp.clip(coh_k.mean(axis=1), 0.0, 1.0)

    z_k = fisher_atanh(coh_k, _FISHER_EPS)
    z_mean = z_k.mean(axis=1)
    z_var = ((K - 1) / K) * ((z_k - z_mean[:, None]) ** 2).sum(axis=1)
    z_se = jnp.sqrt(z_var)

    z_center = fisher_atanh(coherence_mean, _FISHER_EPS)
    ci_lower = inverse_fisher_atanh(z_center - t_crit * z_se)
    ci_upper = inverse_fisher_atanh(z_center + t_crit * z_se)
    ci_lower = jnp.minimum(ci_lower, coherence_mean)
    ci_upper = jnp.maximum(ci_upper, coherence_mean)

    if aggregate_emg_max:
        # joint max over EMG channels with CI-aligned indices
        max_idx = jnp.argmax(coherence_mean, axis=-1, keepdims=True)
        take = lambda a: jnp.take_along_axis(a, max_idx, axis=-1)[..., 0]
        return {"coherence": take(coherence_mean),
                "ci_lower": take(ci_lower),
                "ci_upper": take(ci_upper)}

    return {"coherence": coherence_mean,
            "ci_lower": ci_lower,
            "ci_upper": ci_upper}


def _auto_chunk(window_samples: int, K: int, n_eeg: int, n_emg: int,
                use_jackknife: bool, budget_bytes: float = 2.5e9) -> int:
    """Pick a window-chunk size keeping transient device memory under
    budget."""
    n_freqs = window_samples // 2 + 1
    per_win = K * n_freqs * n_eeg * n_emg * (24 if use_jackknife else 10)
    per_win += 2 * K * n_freqs * (n_eeg + n_emg) * 8
    return max(1, int(budget_bytes // max(per_win, 1)))


@functools.partial(
    jax.jit,
    static_argnames=("window_samples", "inner_chunk", "use_jackknife",
                     "aggregate_emg_max", "transfer_dtype"))
def _msc_all_windows(eeg, emg, starts_padded, tapers, inv_fs_n, t_crit,
                     window_samples, inner_chunk, use_jackknife,
                     aggregate_emg_max, transfer_dtype=None):
    """Entire (masked) window grid in ONE device program.

    ``lax.map`` scans fixed-size window chunks so transient device memory
    stays bounded while the host sees a single dispatch and a single
    download.
    """
    chunks = starts_padded.reshape((-1, inner_chunk))

    def chunk_fn(cs):
        ef = frame_signal(eeg, cs, window_samples)
        mf = frame_signal(emg, cs, window_samples)
        return _msc_chunk_kernel(ef, mf, tapers, inv_fs_n, t_crit,
                                 use_jackknife, aggregate_emg_max)

    out = jax.lax.map(chunk_fn, chunks)
    out = jax.tree_util.tree_map(
        lambda o: o.reshape((-1,) + o.shape[2:]), out)
    if transfer_dtype is not None:
        out = jax.tree_util.tree_map(
            lambda o: o.astype(transfer_dtype), out)
    return out


def multitaper_msc(
        eeg_array,
        emg_array,
        sampling_freq: float,
        nw: float = 3,
        window_length_sec: float = 1.0,
        overlap_frac: float = 0.5,
        eeg_axis: Literal[0, 1] = 0,
        emg_axis: Literal[0, 1] = 0,
        taper_eigenvalue_threshold: float = 0.90,
        use_jackknife: bool = True,
        jackknife_alpha: float = 0.05,
        apply_independence_threshold: bool = True,
        apply_bonferroni_correction: bool = False,
        significance_level: float = 0.05,
        window_mask: np.ndarray | None = None,
        aggregate_emg_max: bool = False,
        window_chunk: int | None = None,
        freq_range: tuple | None = None,
        transfer_dtype=None,
        input_transfer: Literal[None, "int16"] = None,
        verbose: bool = False,
        collect_timings: bool = False,
) -> dict:
    """Multitaper magnitude-squared coherence over all EEG×EMG pairs.

    Drop-in equivalent of the reference's
    ``multitaper_magnitude_squared_coherence`` (signal_features.py:619-839):
    same window grid, taper policy, masking semantics (skipped windows are
    zeros on the full global grid) and output dictionary.  Additional
    ``aggregate_emg_max`` fuses the EMG max-pooling on the device.

    ``freq_range=(f_lo, f_hi)`` slices the frequency axis ON DEVICE
    (inclusive bounds, same ``(freqs >= lo) & (freqs <= hi)`` rule as the
    band aggregators) before the download, and returns the sliced
    ``freqs`` vector.  The kernel math is unchanged — every value inside
    the range is bit-identical to the full-grid run — but the download
    shrinks proportionally.  At study scale (fs=2048, 2 s windows → 2049
    bins up to 1024 Hz) capping at 250 Hz — the top edge of every
    downstream band consumer (``AGGREGATE_BANDS['all'/'fast']``) — cuts
    the downloaded bytes ~4×.  ``None`` keeps the full rfft grid.

    ``transfer_dtype`` (e.g. ``jnp.float16``) casts the result arrays on
    device before download.  All arithmetic stays float32; coherence
    values lie in [0, 1] so the f16 rounding error is ≤ ~5e-4 — and the
    downloaded bytes halve.  ``np.int16`` / ``np.int8`` instead route
    through the affine per-lane quantized download
    (``utils/transfer.py``): same halving/quartering of the downloaded
    bytes, but tighter error for [0, 1]
    coherence (int16 ≤ ~8e-6 vs f16's 5e-4) because the integer grid is
    fitted to the per-lane value range rather than spending exponent
    bits.  ``None`` (default) keeps float32 end to end.

    ``input_transfer='int16'`` quantizes each channel to int16 on the
    host (per-channel max scaling) and uploads half the bytes; the cast
    back to float32 happens on device.  Coherence is invariant to
    per-channel scaling, so the only effect is the int16 rounding of
    the signal itself (relative error ≤ 2^-15 ≈ 3e-5 of each channel's
    peak — an order of magnitude below the f16 *output* rounding above,
    and below the noise floor of any physical ADC front-end).  Arrays
    that are already int16 ADC counts upload verbatim.

    ``collect_timings=True`` adds a ``result['timings']`` dict with
    upload / compute / download wall seconds (each closed by
    ``jax.block_until_ready``) and the download byte count.  Off by default: the barriers serialize stages that
    otherwise overlap asynchronously, so enable it only for
    benchmarking/attribution.
    """
    keep_i16 = input_transfer == "int16"

    def _as_input(x):
        """Device arrays stay on device (a host round-trip here moves
        ~1 GB each way at study scale); host inputs normalize to f32
        numpy, or pass through as int16 ADC counts when requested."""
        if isinstance(x, jax.Array) and not isinstance(x, np.ndarray):
            return x if x.dtype == jnp.float32 else x.astype(jnp.float32)
        x = np.asarray(x)
        if not (keep_i16 and x.dtype == np.int16):
            x = np.asarray(x, dtype=np.float32)
        return x

    eeg = _as_input(eeg_array)
    emg = _as_input(emg_array)
    if eeg.ndim != 2 or emg.ndim != 2:
        raise ValueError("EEG/EMG arrays must be 2D")
    if eeg_axis == 1:
        eeg = eeg.T
    if emg_axis == 1:
        emg = emg.T
    n_samples, n_eeg = eeg.shape
    n_samples_m, n_emg = emg.shape
    if n_samples != n_samples_m:
        raise ValueError(
            f"EEG and EMG must have same number of samples. "
            f"Got EEG: {n_samples}, EMG: {n_samples_m}")

    window_samples = int(window_length_sec * sampling_freq)
    hop_samples = int(window_samples * (1 - overlap_frac))
    if hop_samples <= 0:
        raise ValueError("overlap_frac too high: hop_samples becomes <= 0")

    tapers = filtered_tapers(window_samples, nw, taper_eigenvalue_threshold)
    K = tapers.shape[0]
    if use_jackknife and K < 2:
        raise ValueError("jackknife requires at least 2 tapers")

    starts, time_centers = window_grid(
        n_samples, window_samples, hop_samples, sampling_freq,
        convention="cmc")
    n_windows = len(starts)
    freqs = np.fft.rfftfreq(window_samples, d=1.0 / sampling_freq)
    n_freqs = len(freqs)
    if freq_range is not None:
        f_lo, f_hi = freq_range
        # inclusive on both edges — matches the band aggregators' rule
        f0 = int(np.searchsorted(freqs, f_lo, side="left"))
        f1 = int(np.searchsorted(freqs, f_hi, side="right"))
        if f1 <= f0:
            raise ValueError(
                f"freq_range {freq_range} selects no frequency bins "
                f"(axis spans {freqs[0]:.3f}-{freqs[-1]:.3f} Hz)")
    else:
        f0, f1 = 0, n_freqs
    n_freqs_out = f1 - f0

    if window_mask is not None:
        window_mask = np.asarray(window_mask, dtype=bool)
        if window_mask.shape != (n_windows,):
            raise ValueError(
                f"window_mask must have shape ({n_windows},), "
                f"got {window_mask.shape}")
        active = np.nonzero(window_mask)[0]
    else:
        active = np.arange(n_windows)
    n_active = len(active)
    if verbose:
        print(f"window_mask: {n_active}/{n_windows} windows will be computed"
              f" ({100 * n_active / max(n_windows, 1):.1f}%) | K={K} tapers")

    t_crit = np.float32(_t_dist.ppf(1 - jackknife_alpha / 2, K - 1))
    inv_fs_n = np.float32(1.0 / (sampling_freq * window_samples))
    tapers_j = jnp.asarray(tapers, dtype=jnp.float32)

    chunk = window_chunk or _auto_chunk(window_samples, K, n_eeg, n_emg,
                                        use_jackknife)
    chunk = int(min(chunk, max(n_active, 1)))
    # balance the chunks so padding wastes less than one window per chunk
    chunk = -(-max(n_active, 1) // -(-max(n_active, 1) // chunk))

    # frame only the active windows (compact), then scatter to the full grid
    def _upload(x):
        if input_transfer == "int16" and not isinstance(x, jax.Array):
            if x.dtype != np.int16:
                # per-channel peak scaling: cancels exactly in coherence
                # (native SIMD quantizer, bit-identical numpy fallback)
                from mba_tpu.native import quantize_int16_per_channel
                x = quantize_int16_per_channel(x)
            return jnp.asarray(x).astype(jnp.float32)   # cast on device
        return jnp.asarray(x)

    timings: dict | None = {} if collect_timings else None
    if collect_timings:
        t0 = time.perf_counter()
    eeg_j = _upload(eeg)
    emg_j = _upload(emg)
    if timings is not None:
        jax.block_until_ready((eeg_j, emg_j))
        timings["upload_sec"] = round(time.perf_counter() - t0, 3)
        timings["upload_bytes"] = int(eeg_j.nbytes + emg_j.nbytes)
        t0 = time.perf_counter()

    if n_active > 0:
        # pad active starts to a chunk multiple (extra windows recompute the
        # first start and are discarded) so one program covers everything
        n_pad = (-n_active) % chunk
        starts_padded = np.concatenate(
            [starts[active], np.full(n_pad, starts[active[0]],
                                     dtype=starts.dtype)])
        # int16/int8 transfer_dtype = affine per-lane quantized download
        # (utils/transfer.py): keep f32 in the kernel, quantize the result
        quantized_td = (transfer_dtype is not None
                        and np.dtype(transfer_dtype) in
                        (np.dtype(np.int16), np.dtype(np.int8)))
        device_out = _msc_all_windows(
            eeg_j, emg_j, jnp.asarray(starts_padded, jnp.int32), tapers_j,
            inv_fs_n, t_crit, window_samples, chunk, use_jackknife,
            aggregate_emg_max,
            transfer_dtype=None if quantized_td else transfer_dtype)
        if (f0, f1) != (0, n_freqs):
            # device-side frequency slice: only the requested band is
            # downloaded (values inside it are bit-identical to
            # the full-grid run — same kernel, same lanes when the
            # quantizer uses per-(freq, channel) lanes)
            device_out = {key: val[:, f0:f1]
                          for key, val in device_out.items()}
        if timings is not None:
            jax.block_until_ready(device_out)
            timings["compute_sec"] = round(time.perf_counter() - t0, 3)
            t0 = time.perf_counter()
        # single host download per output array
        if quantized_td:
            from mba_tpu.utils.transfer import download_quantized
            compact, dl_bytes = {}, 0
            td = np.dtype(transfer_dtype)
            for key, val in device_out.items():
                # reduce over the window axis only when the
                # per-(freq, eeg[, emg]) scale sidecars (2·4 bytes/lane)
                # stay under 10 % of the integer payload — tighter
                # per-lane spans at study scale, plain per-channel lanes
                # for tiny window counts.  Judged on n_active, not the
                # chunk-padded val.shape[0]: near the threshold the
                # granularity must not flip on padding (padded rows are
                # window-0 copies, so their min/max effect is benign,
                # but the lane choice should track real data volume).
                fine = 8.0 <= 0.1 * td.itemsize * n_active
                host, n_bytes, _ = download_quantized(
                    val, td, lane_ndim=val.ndim - 1 if fine else 1)
                compact[key] = host[:n_active]
                dl_bytes += n_bytes
        else:
            compact = {key: np.asarray(val, dtype=np.float32)[:n_active]
                       for key, val in device_out.items()}
            dl_bytes = int(sum(v.nbytes for v in device_out.values()))
        if timings is not None:
            timings["download_sec"] = round(time.perf_counter() - t0, 3)
            timings["download_bytes"] = dl_bytes
    else:
        shape_tail = (n_freqs_out, n_eeg) if aggregate_emg_max \
            else (n_freqs_out, n_eeg, n_emg)
        compact = {"coherence": np.zeros((0,) + shape_tail, np.float32)}
        if use_jackknife:
            compact["ci_lower"] = compact["coherence"].copy()
            compact["ci_upper"] = compact["coherence"].copy()

    out_tail = compact["coherence"].shape[1:]
    full = {key: np.zeros((n_windows,) + out_tail, dtype=np.float32)
            for key in compact}
    for key in compact:
        full[key][active] = compact[key]

    result = {
        "coherence_raw": full["coherence"],
        "time_centers": time_centers,
        "freqs": freqs[f0:f1],
        "metadata": {
            "K_tapers": int(K),
            "n_windows": int(n_windows),
            "n_active_windows": int(n_active),
            "window_length_sec": window_length_sec,
            "overlap_frac": overlap_frac,
            "use_jackknife": use_jackknife,
            "apply_independence_threshold": apply_independence_threshold,
            "apply_bonferroni_correction": apply_bonferroni_correction,
            "significance_level": significance_level,
            "freq_range": freq_range,
        },
    }
    if use_jackknife:
        result["coherence_ci_lower"] = full["ci_lower"]
        result["coherence_ci_upper"] = full["ci_upper"]
    if timings is not None:
        timings.setdefault("compute_sec", 0.0)
        timings.setdefault("download_sec", 0.0)
        timings.setdefault("download_bytes", 0)
        result["timings"] = timings

    if apply_independence_threshold:
        n_comp = n_eeg * n_emg
        alpha_adj = (max(significance_level / n_comp, 1e-10)
                     if apply_bonferroni_correction else significance_level)
        it = cmc_independence_threshold_host(K, alpha=alpha_adj)
        result["coherence_significant"] = result["coherence_raw"] > it
        result["metadata"]["IT_unadjusted"] = float(
            cmc_independence_threshold_host(K, alpha=significance_level))
        if apply_bonferroni_correction:
            result["metadata"]["IT_bonferroni"] = float(it)
            result["metadata"]["n_comparisons"] = n_comp
        result["metadata"]["n_significant"] = int(
            result["coherence_significant"].sum())
    return result


def max_cmc_over_channels(cmc_array, lower=None, upper=None,
                          channel_ax: int = 3, verbose: bool = False):
    """Joint EMG-channel max with CI-aligned indices.

    Parity: reference signal_features.py:1132-1171.  (Prefer passing
    ``aggregate_emg_max=True`` to :func:`multitaper_msc`, which fuses this
    on the device; this host version exists for stored spectrograms.)
    """
    max_idx = np.argmax(cmc_array, axis=channel_ax)
    take = lambda a: np.take_along_axis(
        a, np.expand_dims(max_idx, channel_ax), axis=channel_ax
    ).squeeze(axis=channel_ax)
    maxed = take(cmc_array)
    if lower is None or upper is None:
        return maxed
    return maxed, take(lower), take(upper)
