"""Full-cohort 10k-surrogate MSC null via exact algebraic taper rotation.

The north-star workload (BASELINE.md) is the *full-cohort* 64×64 CMC null:
12 subjects × task windows × 64 EEG × 64 EMG channels with a 10 000-surrogate
null distribution of the cohort statistic.

A naive phase-randomised null (ops/surrogate.py:205, the single-pair engine)
resynthesises a surrogate EMG signal per draw (irfft), reframes it, and
redoes the taper FFTs and the 64×64 cross-spectral outer products — roughly
10 GFLOP × 12 subjects × 10 000 surrogates ≈ 1 EFLOP.  No amount of
sharding closes that budget.

Reformulation (exact, not approximate)
--------------------------------------
Write the per-window multitaper MSC at frequency f for pair (e, m) as

    MSC_w = |Σ_k conj(E_kw) M_kw|² / (Σ_k |E_kw|² · Σ_k |M_kw|²)

with E_kw / M_kw the taper-k windowed spectra.  The surrogate operation is a
*per-taper phase rotation* of the EMG spectra, M_kw → M_kw · e^{iφ_k(f)},
with φ drawn iid uniform per (taper, frequency, subject, surrogate) and
shared across windows and EMG channels.  Under H0 (independent stationary
processes) the taper coefficients have iid uniform phases, so this rotation
is distribution-preserving — the same asymptotic argument that underpins
classic FFT phase randomisation and the analytic Beta(K−2, K−2) null
(reference signal_features.py:470-481).  Sharing the rotation across windows
and channels *preserves* the window-to-window and channel-to-channel
covariance of the null field, which the max statistic depends on.

The payoff is algebraic: with z_kw = conj(E_kw) M_kw / den_w,

    stat(φ) = mean_w |Σ_k z_kw e^{iφ_k}|²
            = Σ_k C_kk  +  Σ_{k<l} [ cosΔ_kl · 2Re C_kl − sinΔ_kl · 2Im C_kl ]

where C_kl = mean_w z_kw conj(z_lw) is a **precomputed** (K, K) tensor per
(frequency, EEG, EMG) cell and Δ_kl = φ_k − φ_l.  Every surrogate is then a
*dot product of length K(K−1)* against trig features of the phases — no FFT,
no resynthesis.  The whole 10k-surrogate cohort null becomes a handful of
batched matmuls with contraction dim J·K(K−1) (= 240 for 12 subjects, K=5),
~3.4 PFLOP total at the north-star scale — seconds, not hours.

The identity is exact (tested to float32 tolerance against a direct
rotate-then-recompute evaluation in tests/test_cohort_null.py), and the
null it draws is validated against (a) fresh-draw Monte-Carlo ground truth
and (b) the classic full-FFT phase-randomisation engine.

Statistical note: because the rotation is shared across windows, the null
conditions on the observed window-to-window phase consistency.  Under H0
that consistency is noise-level and the null matches fresh-draw ground
truth (tested); under a strong true coupling the null widens (it does not
enjoy the 1/W variance shrinkage a per-window randomisation would give),
making the test *conservative* in the alternative — detection of real
coupling still stands out by construction since the observed statistic
contains the coherent sum the rotations destroy.  The measured operating
characteristic (BENCH_NULL_POWER.json, tools/bench_null_power.py) puts
the power cost vs the classic full-FFT engine at a mean gap ≈ 0.11 over
a coupling × window-count sweep reaching study scale (W up to 1320),
concentrated in a narrow near-threshold coupling band (max 0.45 at
W = 32); in coupling units the cost is bounded: the 80 %-power
detectable-coupling floor sits ≤ 11 % above the full-FFT engine's at
every measured W (detection_limit block).  Most of that band-edge cost
is the calibrated ``'disjoint'`` inference using only every other window
of a 50 %-overlap grid (W/2 windows vs the full-FFT engine's W), the
rest the no-shrinkage conservativeness above.  Where that band matters
and the scale permits, :func:`cohort_msc_fft_null` (same cohort
statistic, fresh signal-level phases per surrogate — signal-level
randomisation preserves the overlap dependence, so ALL windows enter
the inference exactly) is the higher-power alternative; at study scale
the rotation engine is the one that fits in seconds.

Exactness requires *non-overlapping* windows: overlapping windows'
taper coefficients carry a non-zero pseudo-covariance E[M_kw M_kw']
(no conjugate) through their shared samples, and a common rotation
multiplies it by e^{2iφ} instead of preserving it.  Empirically this
inflates H0 rejection on 50 %-overlap grids as W grows (~0.10 at
nominal 0.05, W = 128).  The engine therefore computes the inference
statistic on a maximal disjoint window subset by default
(``p_value_windows='disjoint'``), which restores exact calibration at
every W; the dense-overlap map remains the estimation layer's job.

Cohort statistic: mean over subjects of the per-subject window-averaged MSC
map, maximised over the analysis band × all pairs (FWE max statistic), with
per-cell uncorrected empirical p-values accumulated on-line.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from mba_tpu.backend import backend_policy
from mba_tpu.ops.dpss import filtered_tapers
from mba_tpu.ops.framing import frame_signal, window_grid

_F32_TINY = np.float32(np.finfo(np.float32).tiny)
# matmul precision of the surrogate contraction (both rotation modes)
NULL_PRECISION = jax.lax.Precision.DEFAULT


def _pair_indices(K: int) -> tuple[np.ndarray, np.ndarray]:
    """Upper-triangle (k < l) index pairs for the rotation features."""
    ks, ls = np.triu_indices(K, k=1)
    return ks.astype(np.int32), ls.astype(np.int32)


def phase_features(phi: jnp.ndarray) -> jnp.ndarray:
    """Rotation-phase trig features.

    phi: (..., K, F) → (..., F, P) with P = K(K−1):
    ``[cos(φ_k−φ_l)]_{k<l} ++ [sin(φ_k−φ_l)]_{k<l}`` — the observed
    statistic corresponds to φ = 0, i.e. features ``[1…1, 0…0]``.
    """
    K = phi.shape[-2]
    ks, ls = _pair_indices(K)
    c, s = jnp.cos(phi), jnp.sin(phi)
    # cos(a−b) = ca·cb + sa·sb ; sin(a−b) = sa·cb − ca·sb
    cos_d = (c[..., ks, :] * c[..., ls, :]
             + s[..., ks, :] * s[..., ls, :])          # (..., P/2, F)
    sin_d = (s[..., ks, :] * c[..., ls, :]
             - c[..., ks, :] * s[..., ls, :])
    feats = jnp.concatenate([cos_d, sin_d], axis=-2)   # (..., P, F)
    return jnp.moveaxis(feats, -2, -1)                 # (..., F, P)


def disjoint_window_weights(window_starts, window_weights,
                            window_samples: int) -> np.ndarray:
    """Weights restricted to a greedy maximal non-overlapping window
    subset per subject (``p_value_windows='disjoint'``).

    Zero-weight windows are ignored so a masked-out window never blocks
    an active one; a non-overlapping grid passes through unchanged.
    window_starts / window_weights: (J, W).
    """
    window_starts = np.asarray(window_starts, np.int64)
    window_weights = np.asarray(window_weights, np.float32)
    keep = np.zeros(window_starts.shape, np.float32)
    for j in range(window_starts.shape[0]):
        order = np.argsort(window_starts[j], kind="stable")
        last = -(1 << 62)
        for idx in order:
            if window_weights[j, idx] == 0.0:
                continue
            s = int(window_starts[j, idx])
            if s >= last + window_samples:
                keep[j, idx] = 1.0
                last = s
    return window_weights * keep


def _rotation_coeffs_body(eeg, emg, starts, weights, tapers,
                          window_samples: int, band_lo: int, band_hi: int,
                          window_chunk: int, per_window: bool = False,
                          use_gram: bool = False,
                          gram_spectra: str = "dft"):
    """Per-subject rotation-null coefficients (traceable body).

    Returns (base, coef):
      base : (F, E, M) f32 — Σ_k Re C_kk   (the rotation-invariant part)
      coef : (F, E, M, P) f32 — [2Re C_kl]_{k<l} ++ [−2Im C_kl]_{k<l}
    such that ``stat(φ) = base + feats(φ) · coef`` exactly equals the
    weighted window-mean MSC with taper-rotated EMG spectra.

    ``per_window=True`` keeps the window axis instead of summing it:
    coef comes back as (Wp, F, E·M, P) (Wp = W padded to the chunk
    multiple; pad windows carry zero weight hence exactly-zero
    coefficients) so the null can rotate every window independently —
    the 1/W-shrinkage, higher-power variant for small window counts.
    ``base`` is unchanged (it is rotation-invariant either way).
    """
    if use_gram and not per_window:
        # gram engine (ops/gram_coeffs.py): pair products as
        # window-contraction matmuls, band spectra as one taper-folded
        # DFT matmul — the production default (the XLA scan below is its
        # parity reference and the per-window engine)
        from mba_tpu.ops.gram_coeffs import gram_coeffs_subject
        return gram_coeffs_subject(
            eeg, emg, starts, weights, tapers, window_samples,
            band_lo, band_hi, spectra=gram_spectra)
    K = tapers.shape[0]
    ks, ls = _pair_indices(K)
    # reduced transfer dtypes (int8/int16) are converted to f32 per
    # window chunk INSIDE the scan body — converting the whole signal
    # here would materialize 2×1.7 GB (padded) copies at study scale
    # (28 min × 64 ch)
    pad = (-starts.shape[0]) % window_chunk
    if pad:                       # shapes are static at trace time
        starts = jnp.concatenate([starts, jnp.tile(starts[:1], pad)])
        weights = jnp.concatenate([weights, jnp.zeros(pad, weights.dtype)])
    starts_c = starts.reshape((-1, window_chunk))
    weights_c = weights.reshape((-1, window_chunk))

    nF = band_hi - band_lo
    nE = eeg.shape[1]
    nM = emg.shape[1]

    nN = nE * nM
    nP2 = len(ks)

    # The scan accumulates only what the epilogue consumes — the K
    # taper-diagonal powers and the P/2 = K(K−1)/2 upper-triangle pair
    # products — as f32 tensors whose minor axis is the flattened
    # N = E·M pair dim.  Carrying the full K×K complex matrix out of an
    # einsum lets XLA lay the tiny (5, 5) taper dims out minor.
    def body(carry, cw):
        diag, pr, pi = cw_body(*cw)
        return (carry[0] + diag, carry[1] + pr, carry[2] + pi), None

    def _taper_products(cs, wts):
        """Tapered band spectra → per-window rotation products yr/yi."""
        ef = frame_signal(eeg, cs, window_samples).astype(
            jnp.float32)                                  # (wc, S, E)
        mf = frame_signal(emg, cs, window_samples).astype(
            jnp.float32)                                  # (wc, S, M)
        Ef = jnp.fft.rfft(ef[:, None] * tapers[None, :, :, None],
                          axis=2)[:, :, band_lo:band_hi]  # (wc, K, F, E)
        Mf = jnp.fft.rfft(mf[:, None] * tapers[None, :, :, None],
                          axis=2)[:, :, band_lo:band_hi]  # (wc, K, F, M)
        pe = (Ef.real ** 2 + Ef.imag ** 2).sum(axis=1)    # (wc, F, E)
        pm = (Mf.real ** 2 + Mf.imag ** 2).sum(axis=1)    # (wc, F, M)
        den = jnp.maximum(pe[..., :, None] * pm[..., None, :], _F32_TINY)
        scale = jnp.sqrt(wts[:, None, None, None] / den)  # (wc, F, E, M)
        # y_k = conj(E_k) M_k · sqrt(w/den):  C_kl = Σ_w y_k conj(y_l),
        # in real arithmetic: per taper,
        #   yr_k = (Er_k·Mr_k + Ei_k·Mi_k)·scale
        #   yi_k = (Er_k·Mi_k − Ei_k·Mr_k)·scale
        Er, Ei = Ef.real[..., :, None], Ef.imag[..., :, None]
        Mr, Mi = Mf.real[..., None, :], Mf.imag[..., None, :]
        sc = scale[:, None]
        yr = ((Er * Mr + Ei * Mi) * sc).reshape(
            -1, K, nF, nN)                                # (wc, K, F, N)
        yi = ((Er * Mi - Ei * Mr) * sc).reshape(-1, K, nF, nN)
        return yr, yi, None

    def cw_body(cs, wts):
        yr, yi, _ = _taper_products(cs, wts)
        diag = (yr * yr + yi * yi).sum(axis=(0, 1))       # (F, N)
        # Re/Im of Σ_w y_k conj(y_l), k < l — a static loop over the
        # P/2 ≈ 10 pairs, each a fused mul+reduce over the window axis
        # with no temp larger than (F, N).  A vectorised yr[:, ks]·…
        # gather materialises (wc, P/2, F, N) intermediates (~2 GB per
        # product at study scale); the tiny-K contraction gains nothing
        # from a matrix unit.
        pr = jnp.stack([(yr[:, k] * yr[:, l]
                         + yi[:, k] * yi[:, l]).sum(axis=0)
                        for k, l in zip(ks, ls)])         # (P/2, F, N)
        pi = jnp.stack([(yi[:, k] * yr[:, l]
                         - yr[:, k] * yi[:, l]).sum(axis=0)
                        for k, l in zip(ks, ls)])
        return diag, pr, pi

    def cw_body_per_window(cs, wts):
        """Same pair products but keeping the window axis (small scale
        only — the per-window tensor is guarded by the caller)."""
        yr, yi, _ = _taper_products(cs, wts)
        diag = (yr * yr + yi * yi).sum(axis=1)            # (wc, F, N)
        pr = jnp.stack([yr[:, k] * yr[:, l] + yi[:, k] * yi[:, l]
                        for k, l in zip(ks, ls)], axis=1)  # (wc, P/2, F, N)
        pi = jnp.stack([yi[:, k] * yr[:, l] - yr[:, k] * yi[:, l]
                        for k, l in zip(ks, ls)], axis=1)
        return diag, pr, pi

    wsum = jnp.maximum(weights.sum(), _F32_TINY)
    if per_window:
        diag_w, pr_w, pi_w = jax.lax.map(
            lambda cw: cw_body_per_window(*cw), (starts_c, weights_c))
        diag_w = diag_w.reshape(-1, nF, nN)               # (Wp, F, N)
        pr_w = pr_w.reshape(-1, nP2, nF, nN)              # (Wp, P/2, F, N)
        pi_w = pi_w.reshape(-1, nP2, nF, nN)
        base = diag_w.sum(axis=0) / wsum
        coefw = jnp.concatenate([2.0 * pr_w, -2.0 * pi_w], axis=1) / wsum
        return base.reshape(nF, nE, nM), \
            jnp.moveaxis(coefw, 1, -1)                    # (Wp, F, N, P)

    C0 = (jnp.zeros((nF, nN), jnp.float32),
          jnp.zeros((nP2, nF, nN), jnp.float32),
          jnp.zeros((nP2, nF, nN), jnp.float32))
    (diag, pr, pi), _ = jax.lax.scan(body, C0, (starts_c, weights_c))

    base = diag / wsum                                       # (F, N)
    coef = jnp.concatenate([2.0 * pr, -2.0 * pi], axis=0) / wsum
    return base.reshape(nF, nE, nM), \
        jnp.moveaxis(coef, 0, -1).reshape(nF, nE, nM, -1)    # (F, E, M, P)


_subject_rotation_coeffs = functools.partial(
    jax.jit, static_argnames=("window_samples", "band_lo", "band_hi",
                              "window_chunk", "per_window", "use_gram",
                              "gram_spectra"))(_rotation_coeffs_body)


@functools.partial(jax.jit, static_argnames=("J",))
def _sharded_epilogue(base_j, coef_all, J: int):
    """Cohort mean + observed from the (padded) sharded coefficient
    pass — same contract as ``_cohort_rotation_coeffs``."""
    base_j = base_j[:J]
    coef_all = coef_all[:J]
    base_cohort = base_j.mean(axis=0)
    P = coef_all.shape[-1]
    base_flat = base_cohort.reshape(base_cohort.shape[0], -1)
    observed_flat = base_flat + coef_all[..., :P // 2].sum(
        axis=-1).mean(axis=0)
    return base_cohort, coef_all, observed_flat


@jax.jit
def _pipelined_epilogue(bases, coefs):
    """Stack per-subject pipelined results on device (no host round trip).

    bases: J-tuple of (F, E, M); coefs: J-tuple of (F, E, M, P) →
    (base_cohort (F, E, M), coef_all (J, F, N, P), observed_flat (F, N))
    — same contract as ``_cohort_rotation_coeffs``.
    """
    base_cohort = jnp.stack(bases).mean(axis=0)
    coef_all = jnp.stack(
        [c.reshape(c.shape[0], -1, c.shape[-1]) for c in coefs])
    P = coef_all.shape[-1]
    base_flat = base_cohort.reshape(base_cohort.shape[0], -1)
    observed_flat = base_flat + coef_all[..., :P // 2].sum(
        axis=-1).mean(axis=0)
    return base_cohort, coef_all, observed_flat


@functools.partial(jax.jit,
                   static_argnames=("window_samples", "band_lo", "band_hi",
                                    "window_chunk", "use_gram"))
def _cohort_rotation_coeffs(eeg, emg, starts, weights, tapers,
                            window_samples: int, band_lo: int,
                            band_hi: int, window_chunk: int,
                            use_gram: bool = False):
    """All-subject rotation coefficients in ONE program.

    eeg: (J, n, E), emg: (J, n, M) — any real dtype (cast to f32 on
    device); starts/weights: (J, W).  ``lax.map`` over subjects bounds
    transient device memory to one subject's frames while avoiding the J
    separate dispatches + host-side stack of the per-subject path.

    Returns (base_cohort (F, E, M) — subject mean, coef_all (J, F, N, P)
    with N = E·M, observed_flat (F, N)).
    """
    J = eeg.shape[0]
    nE, nM = eeg.shape[2], emg.shape[2]

    def one(args):
        e, m, s, w = args
        # e/m stay in their transfer dtype (int8/int16) — the body
        # converts per window chunk after framing
        b, c = _rotation_coeffs_body(
            e, m, s, w, tapers,
            window_samples, band_lo, band_hi, window_chunk,
            use_gram=use_gram)
        return b, c.reshape(c.shape[0], nE * nM, c.shape[-1])

    base_j, coef_all = jax.lax.map(one, (eeg, emg, starts, weights))
    base_cohort = base_j.mean(axis=0)                       # (F, E, M)
    P = coef_all.shape[-1]
    base_flat = base_cohort.reshape(base_cohort.shape[0], nE * nM)
    # observed = stat at φ = 0: cos features 1, sin features 0
    observed_flat = base_flat + coef_all[..., :P // 2].sum(
        axis=-1).mean(axis=0)
    return base_cohort, coef_all, observed_flat


@functools.partial(jax.jit,
                   static_argnames=("window_samples", "band_lo", "band_hi",
                                    "window_chunk"))
def _cohort_rotation_coeffs_pw(eeg, emg, starts, weights, tapers,
                               window_samples: int, band_lo: int,
                               band_hi: int, window_chunk: int):
    """All-subject PER-WINDOW rotation coefficients in one program.

    Small-scale companion of ``_cohort_rotation_coeffs`` (the caller
    guards the tensor size): returns (base_cohort (F, E, M),
    coefw_all (Wp, J, F, N, P) — window axis leading so the null scan
    consumes it without a per-chunk transpose, observed_flat (F, N)).
    """
    nE, nM = eeg.shape[2], emg.shape[2]

    def one(args):
        e, m, s, w = args
        return _rotation_coeffs_body(
            e, m, s, w, tapers, window_samples, band_lo, band_hi,
            window_chunk, per_window=True)

    base_j, coefw = jax.lax.map(one, (eeg, emg, starts, weights))
    coefw_all = jnp.moveaxis(coefw, 0, 1)       # (Wp, J, F, N, P)
    base_cohort = base_j.mean(axis=0)                       # (F, E, M)
    P = coefw_all.shape[-1]
    base_flat = base_cohort.reshape(base_cohort.shape[0], nE * nM)
    # observed = stat at φ = 0: cos features 1, sin features 0, summed
    # over the window axis (pad windows are exactly zero)
    observed_flat = base_flat + coefw_all[..., :P // 2].sum(
        axis=(0, -1)).mean(axis=0)
    return base_cohort, coefw_all, observed_flat


@functools.partial(jax.jit,
                   static_argnames=("n_chunk", "K", "compute_dtype"),
                   donate_argnums=(4,))
def _null_chunk_jit_pw(key, coefw_all, base_cohort, observed, counts,
                       n_chunk, K, compute_dtype):
    """One surrogate chunk with INDEPENDENT rotations per window.

    coefw_all: (Wp, J, F, N, P).  A ``lax.scan`` over the window axis
    keeps the live footprint identical to the shared-rotation chunk
    (one (J, S, F, P) feature tensor + the (F, S, N) accumulator);
    ``fold_in(key, w)`` gives every window its own phase stream.
    """
    Wp, J, nF, nN, P = coefw_all.shape

    def body(acc, xw):
        coef_w, w_idx = xw
        kw = jax.random.fold_in(key, w_idx)
        phi = jax.random.uniform(kw, (J, n_chunk, K, nF),
                                 minval=0.0, maxval=2.0 * np.pi)
        G = phase_features(phi)                            # (J, S, F, P)
        inc = jax.lax.dot_general(
            G.astype(compute_dtype), coef_w.astype(compute_dtype),
            dimension_numbers=(((0, 3), (0, 3)), ((2,), (1,))),
            precision=NULL_PRECISION,
            preferred_element_type=jnp.float32)            # (F, S, N)
        return acc + inc, None

    acc0 = jnp.zeros((nF, n_chunk, nN), jnp.float32)
    stat_sum, _ = jax.lax.scan(
        body, acc0, (coefw_all, jnp.arange(Wp, dtype=jnp.uint32)))
    stat = base_cohort[:, None, :] + stat_sum / J
    max_stat = stat.max(axis=(0, 2))                       # (S,)
    counts = counts + (stat >= observed[:, None, :]).sum(axis=1)
    return max_stat, counts


@functools.partial(jax.jit,
                   static_argnames=("window_samples", "band_lo", "band_hi",
                                    "window_chunk"))
def _cohort_msc_map(eeg, emg, starts, weights, tapers,
                    window_samples: int, band_lo: int, band_hi: int,
                    window_chunk: int):
    """Cohort-mean weighted window-mean MSC map (F, E, M).

    eeg: (J, n, E), emg: (J, n, M); starts/weights: (J, W).  Same
    chunked-scan memory profile as the coefficient pass, but computing
    the MSC map directly (no pair products) — the shared evaluation
    core of the full-FFT cohort engine below.
    """
    nF = band_hi - band_lo

    def one(args):
        e, m, s, w = args
        pad = (-s.shape[0]) % window_chunk
        if pad:
            s = jnp.concatenate([s, jnp.tile(s[:1], pad)])
            w = jnp.concatenate([w, jnp.zeros(pad, w.dtype)])
        s_c = s.reshape(-1, window_chunk)
        w_c = w.reshape(-1, window_chunk)

        def body(carry, cw):
            cs, wts = cw
            ef = frame_signal(e, cs, window_samples).astype(jnp.float32)
            mf = frame_signal(m, cs, window_samples).astype(jnp.float32)
            Ef = jnp.fft.rfft(ef[:, None] * tapers[None, :, :, None],
                              axis=2)[:, :, band_lo:band_hi]
            Mf = jnp.fft.rfft(mf[:, None] * tapers[None, :, :, None],
                              axis=2)[:, :, band_lo:band_hi]
            Er, Ei = Ef.real[..., :, None], Ef.imag[..., :, None]
            Mr, Mi = Mf.real[..., None, :], Mf.imag[..., None, :]
            csd_r = (Er * Mr + Ei * Mi).sum(axis=1)       # (wc, F, E, M)
            csd_i = (Er * Mi - Ei * Mr).sum(axis=1)
            pe = (Ef.real ** 2 + Ef.imag ** 2).sum(axis=1)
            pm = (Mf.real ** 2 + Mf.imag ** 2).sum(axis=1)
            den = jnp.maximum(pe[..., :, None] * pm[..., None, :],
                              _F32_TINY)
            msc = (csd_r ** 2 + csd_i ** 2) / den
            return carry + (wts[:, None, None, None] * msc).sum(axis=0), \
                None

        m0 = jnp.zeros((nF, e.shape[1], m.shape[1]), jnp.float32)
        acc, _ = jax.lax.scan(body, m0, (s_c, w_c))
        return acc / jnp.maximum(w.sum(), _F32_TINY)

    return jax.lax.map(one, (eeg, emg, starts, weights)).mean(axis=0)


@functools.partial(jax.jit,
                   static_argnames=("chunk", "n_samples", "window_samples",
                                    "band_lo", "band_hi", "window_chunk"),
                   donate_argnums=(2,))
def _fft_null_chunk(key, spec, counts, eeg, starts, weights, tapers,
                    observed_flat, chunk: int, n_samples: int,
                    window_samples: int, band_lo: int, band_hi: int,
                    window_chunk: int):
    """``chunk`` full-FFT surrogates: fresh uniform phases on every
    subject's EMG signal spectrum ``spec`` (J, nf, M) — DC/Nyquist kept
    real — resynthesis, and the cohort MSC map of each.  Returns
    (max_stat (chunk,), counts + per-cell exceedances of observed)."""
    J = spec.shape[0]

    def one(k):
        phases = jax.random.uniform(k, (J, spec.shape[1]),
                                    minval=0.0, maxval=2.0 * np.pi)
        phases = phases.at[:, 0].set(0.0)
        if n_samples % 2 == 0:
            phases = phases.at[:, -1].set(0.0)
        surr = jnp.fft.irfft(spec * jnp.exp(1j * phases)[..., None],
                             n=n_samples, axis=1)
        m = _cohort_msc_map(eeg, surr, starts, weights, tapers,
                            window_samples, band_lo, band_hi, window_chunk)
        return m.reshape(m.shape[0], -1)

    maps = jax.lax.map(one, jax.random.split(key, chunk))   # (chunk, F, N)
    max_stat = maps.max(axis=(1, 2))
    counts = counts + (maps >= observed_flat[None]).sum(axis=0)
    return max_stat, counts


def cohort_msc_fft_null(
        eeg_cohort,
        emg_cohort,
        sampling_freq: float,
        n_surrogates: int = 1000,
        nw: float = 3,
        window_length_sec: float = 2.0,
        overlap_frac: float = 0.5,
        taper_eigenvalue_threshold: float = 0.90,
        band: tuple[float, float] = (13.0, 100.0),
        quantiles=(0.95, 0.99),
        surrogate_chunk: int = 8,
        window_chunk: int = 32,
        seed: int = 0,
        window_starts=None,
        window_weights=None,
        verbose: bool = False,
) -> dict:
    """Classic full-FFT phase-randomisation cohort null (small scale).

    The higher-power companion of :func:`cohort_msc_rotation_null`: each
    surrogate draws fresh uniform phases on every subject's EMG *signal*
    spectrum (one phase per frequency bin, shared across EMG channels so
    intra-EMG structure survives; DC/Nyquist stay real) and re-evaluates
    the full cohort statistic.  Because the surrogate signal has the
    original autocorrelation, overlapping windows of the surrogate carry
    the same cross-window dependence as the observed data — so ALL
    windows enter the inference exactly (no disjoint subsetting), which
    is where the rotation engine's near-threshold power gap comes from
    (BENCH_NULL_POWER.json).  The price is an FFT resynthesis + full
    map evaluation per surrogate: O(n_surrogates) cohort passes, vs the
    rotation engine's precompute-once-then-matmul — use this engine for
    small cohorts/channel subsets, the rotation engine at study scale.

    Result dict schema matches ``cohort_msc_rotation_null``.
    Parity note: the reference has no cohort-level surrogate engine
    (its nulls are the Beta threshold, MNE cluster permutations, and
    clustered bootstrap — data_surrogation.py:19-198 provides only
    fault-injection surrogates); both engines extend it.
    """
    eeg = np.asarray(eeg_cohort, np.float32) \
        if not isinstance(eeg_cohort, jax.Array) else eeg_cohort
    emg = np.asarray(emg_cohort, np.float32) \
        if not isinstance(emg_cohort, jax.Array) else emg_cohort
    if eeg.ndim != 3 or emg.ndim != 3:
        raise ValueError("cohort arrays must be (J, n_samples, n_channels)")
    if eeg.shape[:2] != emg.shape[:2]:
        raise ValueError("EEG/EMG cohorts must share (J, n_samples)")
    J, n_samples, nE = eeg.shape
    nM = emg.shape[2]

    window_samples = int(window_length_sec * sampling_freq)
    hop = int(window_samples * (1 - overlap_frac))
    tapers = filtered_tapers(window_samples, nw, taper_eigenvalue_threshold)
    K = int(tapers.shape[0])
    freqs_all = np.fft.rfftfreq(window_samples, d=1.0 / sampling_freq)
    lo = max(int(np.searchsorted(freqs_all, band[0], side="left")), 1)
    hi = min(int(np.searchsorted(freqs_all, band[1], side="right")),
             len(freqs_all) - (1 if window_samples % 2 == 0 else 0))
    if hi <= lo:
        raise ValueError(f"band {band} selects no frequency bins")
    freqs = freqs_all[lo:hi]
    nF = hi - lo

    if window_starts is None:
        starts, _ = window_grid(n_samples, window_samples, hop,
                                sampling_freq, convention="cmc")
        window_starts = np.tile(starts[None], (J, 1))
    window_starts = np.asarray(window_starts, np.int64)
    if window_weights is None:
        window_weights = np.ones(window_starts.shape, np.float32)
    window_weights = np.asarray(window_weights, np.float32)
    W = window_starts.shape[1]
    wc = int(min(window_chunk, W))

    import time as _time
    t_pre0 = _time.perf_counter()
    eeg_d = jnp.asarray(eeg)
    emg_d = jnp.asarray(emg)
    starts_d = jnp.asarray(window_starts, jnp.int32)
    weights_d = jnp.asarray(window_weights)
    tapers_j = jnp.asarray(tapers, jnp.float32)
    observed_d = _cohort_msc_map(eeg_d, emg_d, starts_d, weights_d,
                                 tapers_j, window_samples, lo, hi, wc)
    spec = jnp.fft.rfft(emg_d, axis=1)          # (J, nf, M), complex64
    observed = np.asarray(observed_d)
    observed_flat_d = observed_d.reshape(nF, nE * nM)
    t_precompute = _time.perf_counter() - t_pre0

    t_null0 = _time.perf_counter()
    counts = jnp.zeros((nF, nE * nM), jnp.int32)
    chunk = int(min(surrogate_chunk, n_surrogates))
    key = jax.random.PRNGKey(seed)
    max_stats = []
    n_total = 0
    while n_total < n_surrogates:
        key, sub = jax.random.split(key)
        ms, counts = _fft_null_chunk(
            sub, spec, counts, eeg_d, starts_d, weights_d, tapers_j,
            observed_flat_d, chunk, n_samples, window_samples, lo, hi, wc)
        max_stats.append(np.asarray(ms))
        n_total += chunk
    max_stat = np.concatenate(max_stats)[:n_surrogates]
    counts_np = np.asarray(counts).reshape(nF, nE, nM)
    t_null = _time.perf_counter() - t_null0
    p_unc = (1.0 + counts_np) / (1.0 + n_total)
    p_fwe = float((1.0 + (max_stat >= observed.max()).sum())
                  / (1.0 + len(max_stat)))
    if verbose:
        print(f"[fft-null] J={J} K={K} F={nF} pairs={nE}x{nM} W={W}: "
              f"{n_total} surrogates in {t_null:.1f}s")

    return {
        "observed": observed,
        "freqs": freqs,
        "max_stat": max_stat,
        "null_quantiles": {q: float(np.quantile(max_stat, q))
                           for q in quantiles},
        "p_uncorrected": p_unc.astype(np.float32),
        "p_fwe": p_fwe,
        "metadata": {
            "method": "full_fft_phase_randomization",
            "K_tapers": K,
            "n_surrogates_drawn": int(n_total),
            "n_surrogates": int(n_surrogates),
            "band": tuple(band),
            "band_bins": (lo, hi),
            "n_subjects": J,
            "timings": {"precompute_sec": round(t_precompute, 3),
                        "null_sec": round(t_null, 3)},
        },
    }


def _make_sharded_coeffs(mesh, J: int, window_samples: int, band_lo: int,
                         band_hi: int, window_chunk: int,
                         use_gram: bool = False):
    """Subject-sharded coefficient precompute under ``mesh``.

    Subjects are split over every device of the (flattened) mesh; each
    device runs the same per-subject body (``_rotation_coeffs_body``
    via ``lax.map``) on its local subjects — embarrassingly parallel,
    no collectives (the cohort mean/observed epilogue runs on the
    gathered result).  Returns (jitted fn, j_pad): call with inputs
    padded to ``j_pad`` subjects (tile the last subject; the pad rows
    are sliced away by the caller).  Asserted equal to the single-device
    program in tests.
    """
    import math as _math
    from jax.sharding import Mesh, PartitionSpec as Pspec
    from jax import shard_map

    flat = Mesh(mesh.devices.reshape(-1), ("subj",))
    n_dev = int(flat.devices.size)
    j_pad = n_dev * _math.ceil(J / n_dev)

    def per_device(eeg, emg, starts, weights, tapers):
        def one(args):
            e, m, s, w = args
            b, c = _rotation_coeffs_body(
                e, m, s, w,
                tapers, window_samples, band_lo, band_hi, window_chunk,
                use_gram=use_gram)
            return b, c.reshape(c.shape[0], -1, c.shape[-1])
        return jax.lax.map(one, (eeg, emg, starts, weights))

    # check_vma=False: the per-subject body builds its scan carry fresh
    # (unvarying) while the inputs are 'subj'-varying — the static vma
    # checker rejects that even though the body touches no collectives
    fn = shard_map(per_device, mesh=flat,
                   in_specs=(Pspec("subj"), Pspec("subj"),
                             Pspec("subj"), Pspec("subj"), Pspec()),
                   out_specs=(Pspec("subj"), Pspec("subj")),
                   check_vma=False)
    return jax.jit(fn), j_pad, n_dev, flat


def _null_chunk_core(key, coef_all, base_cohort, observed, counts,
                     n_chunk: int, K: int, compute_dtype):
    """One chunk of surrogates against precomputed rotation coefficients.

    coef_all: (J, F, N, P) with N = E·M flattened; base_cohort/observed:
    (F, N).  Returns (max_stat (n_chunk,), counts + per-cell exceedances).
    """
    J, nF, nN, P = coef_all.shape
    phi = jax.random.uniform(key, (J, n_chunk, K, nF),
                             minval=0.0, maxval=2.0 * np.pi)
    G = phase_features(phi)                                # (J, S, F, P)
    # cohort mean over subjects folds into the contraction: batch dim f,
    # contraction dims (j, p) → inner dim J·P (240 at study scale).
    stat = jax.lax.dot_general(
        G.astype(compute_dtype), coef_all.astype(compute_dtype),
        dimension_numbers=(((0, 3), (0, 3)), ((2,), (1,))),
        precision=NULL_PRECISION,
        preferred_element_type=jnp.float32)                # (F, S, N)
    stat = base_cohort[:, None, :] + stat / J
    max_stat = stat.max(axis=(0, 2))                       # (S,)
    counts = counts + (stat >= observed[:, None, :]).sum(axis=1)
    return max_stat, counts


@functools.partial(jax.jit,
                   static_argnames=("n_chunk", "K", "compute_dtype"),
                   donate_argnums=(4,))
def _null_chunk_jit(key, coef_all, base_cohort, observed, counts,
                    n_chunk, K, compute_dtype):
    return _null_chunk_core(key, coef_all, base_cohort, observed, counts,
                            n_chunk, K, compute_dtype)


def _make_sharded_chunk(mesh, n_chunk: int, K: int, compute_dtype):
    """shard_map variant: surrogates split over every device in the mesh.

    Inputs are replicated except the per-device keys; per-cell exceedance
    counts are psum-reduced over the surrogate axis, max stats gathered.
    """
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    flat = Mesh(mesh.devices.reshape(-1), ("surr",))
    n_dev = flat.devices.size

    def per_device(keys, coefs, base_cohort, observed, counts):
        # accumulate the *increment* locally, psum it, then add to the
        # replicated running counts (psum-ing counts directly would scale
        # the carried-over total by n_devices).
        ms, inc = _null_chunk_core(keys[0], coefs, base_cohort,
                                   observed, jnp.zeros_like(counts),
                                   n_chunk, K, compute_dtype)
        return ms, counts + jax.lax.psum(inc, "surr")

    fn = shard_map(per_device, mesh=flat,
                   in_specs=(P("surr"), P(), P(), P(), P()),
                   out_specs=(P("surr"), P()))
    return jax.jit(fn), flat, n_dev


def cohort_msc_rotation_null(
        eeg_cohort,
        emg_cohort,
        sampling_freq: float,
        n_surrogates: int = 10_000,
        nw: float = 3,
        window_length_sec: float = 2.0,
        overlap_frac: float = 0.5,
        taper_eigenvalue_threshold: float = 0.90,
        band: tuple[float, float] = (13.0, 100.0),
        quantiles=(0.95, 0.99),
        surrogate_chunk: int = 256,
        window_chunk: int = 32,
        seed: int = 0,
        compute_dtype=jnp.float32,
        transfer_dtype=None,
        mesh=None,
        window_starts=None,
        window_weights=None,
        p_value_windows: str = "disjoint",
        rotation_mode: str = "shared",
        per_window_max_coef_bytes: int = 2 * 1024 ** 3,
        overlap_upload: bool = True,
        precompute_only: bool = False,
        coeff_engine: str = "auto",
        verbose: bool = False,
) -> dict:
    """Cohort-level FWE-corrected MSC surrogate null (see module docstring).

    Parameters
    ----------
    eeg_cohort, emg_cohort : (J, n_samples, E) / (J, n_samples, M) arrays.
    band : analysis band in Hz over which the null/max statistic is taken
        (DC and Nyquist are always excluded — a phase rotation of a real
        coefficient is not distribution-preserving there).
    compute_dtype : dtype of the contraction inputs (accumulation is f32
        via ``preferred_element_type``).  bf16 perturbs null draws by
        ~0.4 % relative.
    transfer_dtype : optional reduced dtype for the host→device signal
        upload (fewer bytes to move); arithmetic stays float32 on device.  ``np.float16`` → relative signal error
        ~1e-3; ``np.int16`` → per-channel peak quantization (error
        ≤ 2^-15 of each channel's peak; per-channel scaling cancels
        exactly in MSC).  Either way the statistic error is far below
        Monte-Carlo noise (tested).
    mesh : optional ``jax.sharding.Mesh`` — surrogates are sharded over all
        its devices (embarrassingly parallel; one psum on the per-cell
        exceedance counts).
    window_starts / window_weights : optional (J, W) per-subject window
        starts (sample index) and weights (e.g. a task mask as 0/1 floats).
        Default: the full "cmc"-convention grid, all weight 1.
    p_value_windows : ``'disjoint'`` (default) computes the statistic and
        its null on a maximal non-overlapping subset of the windows;
        ``'all'`` uses every window.  The shared taper rotation is exactly
        distribution-preserving for disjoint windows, but *overlapping*
        windows carry a non-zero pseudo-covariance between their taper
        coefficients that a common rotation does not preserve — measured
        H0 rejection at nominal α = 0.05 with 50 %-overlap grids grows
        from ~0.05 (W ≤ 32) to ~0.10 (W = 128, 200 replicates) under
        ``'all'``, while ``'disjoint'`` stays at nominal for every W
        (0.03 at W = 128).  Estimation (the coherence *map*) is
        unaffected — use ``parallel.cohort.cohort_multitaper_msc`` for
        overlap-dense estimates; this engine's job is inference.
    rotation_mode : ``'shared'`` (default) draws ONE rotation per
        (subject, taper, frequency) shared across windows — the
        study-scale engine (coefficients are window-summed, so memory
        and the surrogate contraction are independent of W).
        ``'per_window'`` draws an independent rotation per window.
        Under H0 the two nulls coincide in distribution (each window's
        rotated products are rotation-invariant and windows are
        independent), so calibration is identical; under true coupling
        the per-window null stops conditioning on the observed
        cross-window phase alignment and is strictly tighter (measured:
        max-stat q95 ~5 % lower at planted coherence 0.25, a small
        power gain concentrated at strong coupling — the sweep's
        near-threshold gap vs the full-FFT engine is dominated by the
        disjoint-subset window count, NOT the shared rotation;
        BENCH_NULL_POWER.json quantifies all three engines).  Costs W×
        the coefficient memory and surrogate FLOPs, so it is guarded to
        small scale (``per_window_max_coef_bytes``, default 2 GB) and
        requires ``p_value_windows='disjoint'`` (independent per-window
        rotations are only distribution-preserving for non-overlapping
        windows) and ``mesh=None``.
    overlap_upload : pipeline the precompute per subject — quantize
        subject j+1 on the host while subject j uploads and the device
        runs subject j-1's coefficient pass (all transfers and
        dispatches are asynchronous; XLA orders them by data
        dependency).  ``False`` runs the single fused all-subject
        program (one upload, one dispatch).  Both paths run the same
        per-subject body and produce identical coefficients.
    precompute_only : return after the coefficient pass (observed map +
        timings, no surrogates) — used to warm the per-subject program
        at full shape and to time precompute in isolation.
    coeff_engine : ``'auto'`` | ``'gram'`` | ``'xla'`` — which
        coefficient-pass lowering to run.  ``'auto'`` picks the gram
        engine (ops/gram_coeffs.py: pair products as window-contraction
        matmuls + taper-folded band DFT matmul); ``'xla'`` is the
        chunked-scan reference.  Both produce the same coefficients to
        f32 tolerance (tested).  An engine that fails raises.

    Integer ADC passthrough: if the cohorts are already int16/int8 ADC
    counts (the OTB4 on-disk format, io/otb4.py) *and* ``transfer_dtype``
    names the same integer type, they upload verbatim — no host float32
    materialisation, no re-quantization (per-channel scaling cancels in
    MSC, so ADC counts and mV-scaled floats give identical coherence).

    Returns
    -------
    dict with
      observed       : (F, E, M) cohort-mean window-averaged MSC (band bins)
      freqs          : (F,) band frequencies
      max_stat       : (n_surrogates,) null of the cohort max statistic
      null_quantiles : {q: scalar FWE threshold}
      p_uncorrected  : (F, E, M) per-cell empirical p of the observed map
      p_fwe          : scalar FWE p of the observed max statistic
      metadata
    """
    td = np.dtype(transfer_dtype) if transfer_dtype is not None else None
    int_transfer = td in (np.dtype(np.int16), np.dtype(np.int8))

    def _host_prep(x):
        if isinstance(x, jax.Array):
            # already device-resident (any real dtype): uploads become
            # no-ops and the f32 cast happens inside the programs —
            # the caller owns placement and precision
            return x
        x = np.asarray(x)
        if int_transfer and x.dtype == td:
            return x                   # ADC-count passthrough, zero copies
        return np.asarray(x, np.float32)

    eeg = _host_prep(eeg_cohort)
    emg = _host_prep(emg_cohort)
    if eeg.ndim != 3 or emg.ndim != 3:
        raise ValueError("cohort arrays must be (J, n_samples, n_channels)")
    if eeg.shape[:2] != emg.shape[:2]:
        raise ValueError("EEG/EMG cohorts must share (J, n_samples)")
    J, n_samples, nE = eeg.shape
    nM = emg.shape[2]

    window_samples = int(window_length_sec * sampling_freq)
    hop = int(window_samples * (1 - overlap_frac))
    tapers = filtered_tapers(window_samples, nw, taper_eigenvalue_threshold)
    K = int(tapers.shape[0])
    if K < 2:
        raise ValueError("rotation null requires at least 2 tapers")

    freqs_all = np.fft.rfftfreq(window_samples, d=1.0 / sampling_freq)
    lo = int(np.searchsorted(freqs_all, band[0], side="left"))
    hi = int(np.searchsorted(freqs_all, band[1], side="right"))
    lo = max(lo, 1)                                   # never DC
    hi = min(hi, len(freqs_all) - (1 if window_samples % 2 == 0 else 0))
    if hi <= lo:
        raise ValueError(f"band {band} selects no frequency bins")
    freqs = freqs_all[lo:hi]
    nF = hi - lo

    if window_starts is None:
        starts, _ = window_grid(n_samples, window_samples, hop,
                                sampling_freq, convention="cmc")
        window_starts = np.tile(starts[None], (J, 1))
    window_starts = np.asarray(window_starts, np.int64)
    if window_weights is None:
        window_weights = np.ones(window_starts.shape, np.float32)
    window_weights = np.asarray(window_weights, np.float32)
    if p_value_windows == "disjoint":
        window_weights = disjoint_window_weights(
            window_starts, window_weights, window_samples)
        if not window_weights.any():
            raise ValueError("p_value_windows='disjoint' left no active "
                             "windows — check window_starts/weights")
    elif p_value_windows != "all":
        raise ValueError("p_value_windows must be 'disjoint' or 'all', "
                         f"got {p_value_windows!r}")
    W = window_starts.shape[1]
    wc = int(min(window_chunk, W))   # chunk-padding happens inside the jit

    if rotation_mode not in ("shared", "per_window"):
        raise ValueError("rotation_mode must be 'shared' or 'per_window', "
                         f"got {rotation_mode!r}")
    per_window = rotation_mode == "per_window"
    if per_window:
        if mesh is not None:
            raise ValueError("rotation_mode='per_window' does not support "
                             "mesh sharding; use the shared mode or run "
                             "single-device")
        if p_value_windows != "disjoint":
            raise ValueError("rotation_mode='per_window' requires "
                             "p_value_windows='disjoint': independent "
                             "per-window rotations are only distribution-"
                             "preserving for non-overlapping windows")
        Wp = -(-W // wc) * wc
        P_f = K * (K - 1)
        pw_bytes = Wp * J * nF * nE * nM * P_f * 4
        if pw_bytes > per_window_max_coef_bytes:
            raise ValueError(
                f"per-window coefficients need {pw_bytes / 1e9:.1f} GB "
                f"(> {per_window_max_coef_bytes / 1e9:.1f} GB budget) — "
                "the per-window mode is for small window counts / channel "
                "subsets; use rotation_mode='shared' (window-summed "
                "coefficients, W-independent memory) at this scale")

    tapers_j = jnp.asarray(tapers, jnp.float32)
    # ---- precompute all-subject rotation coefficients (device-resident) --
    import time as _time
    t_pre0 = _time.perf_counter()
    t_stage = {}
    quantize = None
    device_resident = isinstance(eeg, jax.Array)
    if (transfer_dtype is not None and not device_resident
            and not (int_transfer
                     and eeg.dtype == td
                     and emg.dtype == td)):
        if int_transfer:
            # per-(subject, channel) peak scaling: cancels exactly in
            # MSC, so precision is 2^-15 (int16) / 2^-7 (int8) of each
            # channel's peak — int16 is an order of magnitude tighter
            # than f16 at the same byte count; int8 quarters the upload
            # at a still-below-Monte-Carlo error
            # (tested).  Native single-thread SIMD quantizer
            # (mba_tpu/native/quantshim.cpp) with a numpy fallback: the
            # numpy version costs ~5 memory passes over the cohort.
            from mba_tpu.native import (quantize_int16_per_channel,
                                        quantize_int8_per_channel)
            quantize = (quantize_int16_per_channel
                        if td == np.dtype(np.int16)
                        else quantize_int8_per_channel)
        else:
            def quantize(x, _td=transfer_dtype):
                return x.astype(_td)
    starts_all = jnp.asarray(window_starts, jnp.int32)       # (J, W)
    weights_all = jnp.asarray(window_weights)                # (J, W)

    def _precompute_fused(program=_cohort_rotation_coeffs, **pkw):
        """One upload per modality + one all-subject program.  The f32
        cast happens inside the program, per subject, so the f32 cohort
        never materialises in device memory at once."""
        nonlocal eeg, emg
        tq0 = _time.perf_counter()
        if quantize is not None and eeg.dtype != td:   # re-entry safe
            eeg = quantize(eeg)
            emg = quantize(emg)
        t_stage["quantize_sec"] = round(_time.perf_counter() - tq0, 3)
        t_up0 = _time.perf_counter()
        eeg_d = jnp.asarray(eeg)
        emg_d = jnp.asarray(emg)
        jax.block_until_ready((eeg_d, emg_d))
        t_stage["upload_sec"] = round(_time.perf_counter() - t_up0, 3)
        t_co0 = _time.perf_counter()
        out = program(
            eeg_d, emg_d, starts_all, weights_all,
            tapers_j, window_samples, lo, hi, wc, **pkw)
        jax.block_until_ready(out)
        t_stage["coeffs_sec"] = round(_time.perf_counter() - t_co0, 3)
        return out

    def _precompute_pipelined(use_gram=False):
        """Per-subject quantize → async device_put → async coefficient
        dispatch: the host quantizes subject j+1 while subject j uploads
        and the device runs subject j-1's pass."""
        t_q = 0.0
        t_ov0 = _time.perf_counter()
        bases, coefs = [], []
        for j in range(J):
            tq0 = _time.perf_counter()
            ej = quantize(eeg[j]) if quantize is not None else eeg[j]
            mj = quantize(emg[j]) if quantize is not None else emg[j]
            t_q += _time.perf_counter() - tq0
            ej_d = jax.device_put(ej)          # async transfer
            mj_d = jax.device_put(mj)
            b, c = _subject_rotation_coeffs(    # async dispatch
                ej_d, mj_d, starts_all[j], weights_all[j], tapers_j,
                window_samples, lo, hi, wc, use_gram=use_gram)
            bases.append(b)
            coefs.append(c)
        out = _pipelined_epilogue(tuple(bases), tuple(coefs))
        jax.block_until_ready(out)   # one barrier after the whole chain
        t_stage["quantize_sec"] = round(t_q, 3)
        # upload and coefficient passes overlap by construction; their
        # union is what remains after subtracting host quantize time
        t_stage["upload_coeffs_overlap_sec"] = round(
            _time.perf_counter() - t_ov0 - t_q, 3)
        return out

    def _precompute_sharded(use_gram=False):
        """Subject-sharded coefficient pass over the mesh (one sharded
        upload, no collectives; the pad subjects are sliced away in the
        epilogue)."""
        nonlocal eeg, emg
        from jax.sharding import NamedSharding, PartitionSpec as Pspec
        tq0 = _time.perf_counter()
        if quantize is not None and eeg.dtype != td:
            eeg = quantize(eeg)
            emg = quantize(emg)
        t_stage["quantize_sec"] = round(_time.perf_counter() - tq0, 3)
        fn, j_pad, n_dev, flat = _make_sharded_coeffs(
            mesh, J, window_samples, lo, hi, wc, use_gram=use_gram)

        def pad_subjects(x):
            x = np.asarray(x) if not isinstance(x, jax.Array) else x
            if j_pad == J:
                return x
            reps = np.concatenate if not isinstance(x, jax.Array) \
                else jnp.concatenate
            return reps([x] + [x[-1:]] * (j_pad - J))

        sharded = NamedSharding(flat, Pspec("subj"))
        t_up0 = _time.perf_counter()
        eeg_s = jax.device_put(pad_subjects(eeg), sharded)
        emg_s = jax.device_put(pad_subjects(emg), sharded)
        starts_s = jax.device_put(pad_subjects(window_starts
                                               .astype(np.int32)),
                                  sharded)
        weights_s = jax.device_put(pad_subjects(window_weights), sharded)
        jax.block_until_ready((eeg_s, emg_s))
        t_stage["upload_sec"] = round(_time.perf_counter() - t_up0, 3)
        t_co0 = _time.perf_counter()
        base_j, coef_p = fn(eeg_s, emg_s, starts_s, weights_s, tapers_j)
        out = _sharded_epilogue(base_j, coef_p, J)
        jax.block_until_ready(out)
        t_stage["coeffs_sec"] = round(_time.perf_counter() - t_co0, 3)
        t_stage["coeffs_shard_devices"] = n_dev
        return out

    pipelined = bool(overlap_upload) and mesh is None and not per_window
    if coeff_engine not in ("auto", "gram", "xla"):
        raise ValueError("coeff_engine must be 'auto', 'gram' or 'xla', "
                         f"got {coeff_engine!r}")
    # the gram lowering is plain XLA, valid on every platform and shape;
    # per-window coefficients keep the scan engine
    engine = "xla" if per_window or coeff_engine == "xla" else "gram"
    if per_window:
        # coef_all: (Wp, J, F, N, P)
        base_cohort_d, coef_all, observed_flat = _precompute_fused(
            _cohort_rotation_coeffs_pw)
    elif mesh is not None:
        base_cohort_d, coef_all, observed_flat = _precompute_sharded(
            use_gram=engine == "gram")
    elif pipelined:
        base_cohort_d, coef_all, observed_flat = _precompute_pipelined(
            use_gram=engine == "gram")
    else:
        base_cohort_d, coef_all, observed_flat = _precompute_fused(
            use_gram=engine == "gram")
    base_flat = base_cohort_d.reshape(nF, nE * nM)
    P_feats = int(coef_all.shape[-1])
    observed = np.asarray(observed_flat).reshape(nF, nE, nM)
    t_precompute = _time.perf_counter() - t_pre0   # incl. uploads + sync
    upload_bytes = (eeg.nbytes + emg.nbytes if quantize is None
                    else eeg.size * td.itemsize + emg.size * td.itemsize)
    t_stage["upload_bytes"] = int(upload_bytes)
    t_stage["coeff_engine"] = engine

    if precompute_only:
        # warm-up / coefficient-extraction mode: skip the surrogate loop
        return {
            "observed": observed,
            "freqs": freqs,
            "metadata": {
                "method": "taper_rotation",
                "rotation_mode": rotation_mode,
                "K_tapers": K,
                "n_subjects": J,
                "band": tuple(band),
                "band_bins": (lo, hi),
                "timings": {"precompute_sec": round(t_precompute, 3),
                            **t_stage},
            },
        }

    if verbose:
        gB = coef_all.size * 4 / 1e9
        print(f"[rotation-null] J={J} K={K} F={nF} pairs={nE}x{nM} "
              f"P={P_feats} coef tensor {gB:.2f} GB, "
              f"{n_surrogates} surrogates in chunks of {surrogate_chunk}")

    # ---- surrogate chunks ------------------------------------------------
    t_null0 = _time.perf_counter()
    counts = jnp.zeros((nF, nE * nM), jnp.int32)
    chunk = int(min(surrogate_chunk, n_surrogates))
    key = jax.random.PRNGKey(seed)
    max_stats = []
    n_total = 0
    if per_window:
        # independent rotations per window (the scan over the window axis
        # keeps the live footprint at the shared-mode chunk size)
        while n_total < n_surrogates:
            key, sub = jax.random.split(key)
            ms, counts = _null_chunk_jit_pw(
                sub, coef_all, base_flat, observed_flat, counts,
                chunk, K, compute_dtype)
            max_stats.append(np.asarray(ms))
            n_total += chunk
    elif mesh is not None:
        step, flat_mesh, n_dev = _make_sharded_chunk(mesh, chunk, K,
                                                     compute_dtype)
        from jax.sharding import NamedSharding, PartitionSpec as Pspec
        key_shard = NamedSharding(flat_mesh, Pspec("surr"))
        rep = NamedSharding(flat_mesh, Pspec())
        coefs_in = jax.device_put(coef_all, rep)
        base_flat_d = jax.device_put(base_flat, rep)
        obs_d = jax.device_put(observed_flat, rep)
        counts = jax.device_put(counts, rep)
        while n_total < n_surrogates:
            key, sub = jax.random.split(key)
            keys = jax.device_put(jax.random.split(sub, n_dev), key_shard)
            ms, counts = step(keys, coefs_in, base_flat_d, obs_d, counts)
            max_stats.append(np.asarray(ms))
            n_total += n_dev * chunk
    else:
        while n_total < n_surrogates:
            key, sub = jax.random.split(key)
            ms, counts = _null_chunk_jit(sub, coef_all, base_flat,
                                         observed_flat, counts,
                                         chunk, K, compute_dtype)
            max_stats.append(np.asarray(ms))
            n_total += chunk

    # surplus draws in the last chunk are equally valid null samples; the
    # per-cell counts are normalised by the true total (same convention as
    # ops/surrogate.py msc_phase_randomized_null).
    max_stat = np.concatenate(max_stats)[:n_surrogates]
    counts_np = np.asarray(counts).reshape(nF, nE, nM)
    t_null = _time.perf_counter() - t_null0
    p_unc = (1.0 + counts_np) / (1.0 + n_total)
    p_fwe = float((1.0 + (max_stat >= observed.max()).sum())
                  / (1.0 + len(max_stat)))

    return {
        "observed": observed,
        "freqs": freqs,
        "max_stat": max_stat,
        "null_quantiles": {q: float(np.quantile(max_stat, q))
                           for q in quantiles},
        "p_uncorrected": p_unc.astype(np.float32),
        "p_fwe": p_fwe,
        "metadata": {
            "method": "taper_rotation",
            "K_tapers": K,
            "n_surrogates_drawn": int(n_total),
            "n_surrogates": int(n_surrogates),
            "band": tuple(band),
            "band_bins": (lo, hi),
            "n_subjects": J,
            "rotation_mode": rotation_mode,
            "compute_dtype": jnp.dtype(compute_dtype).name,
            "contraction_flops": float(2 * n_total * nF * nE * nM * J
                                       * P_feats * (Wp if per_window
                                                    else 1)),
            "timings": {"precompute_sec": round(t_precompute, 3),
                        "null_sec": round(t_null, 3), **t_stage},
        },
    }


def _fft_null_flops(J: int, n_samples: int, nE: int, nM: int, W: int,
                    K: int, window_samples: int, nF: int,
                    n_surrogates: int) -> float:
    """Device-flop estimate of one full-FFT cohort null (dispatch model).

    Per surrogate: EMG signal resynthesis (irfft per subject×channel),
    EMG window taper FFTs, and the cohort MSC map re-evaluation (the
    EEG window spectra are surrogate-invariant and amortize to zero).
    """
    lg = float(np.log2(max(n_samples, 2)))
    lw = float(np.log2(max(window_samples, 2)))
    per_surr = J * (5.0 * n_samples * lg * nM                # resynthesis
                    + 5.0 * window_samples * lw * W * K * nM  # window FFTs
                    + 8.0 * K * W * nF * nE * nM)             # MSC map
    return per_surr * n_surrogates


def cohort_msc_null(eeg_cohort, emg_cohort, sampling_freq: float,
                    n_surrogates: int = 10_000, method: str = "auto",
                    fft_flop_budget: float | None = None, **kw) -> dict:
    """Cohort FWE null with automatic engine selection.

    The two engines trade POWER for SCALE on overlapping window grids:

    - ``'fft'`` (:func:`cohort_msc_fft_null`) resynthesizes the EMG
      signals per surrogate, so every window — including 50 %-overlap
      ones — enters the inference exactly.  Cost: O(n_surrogates) full
      cohort passes.
    - ``'rotation'`` (:func:`cohort_msc_rotation_null`) precomputes
      rotation coefficients once and draws surrogates as matmuls, but
      calibrated inference restricts to a disjoint window subset
      (p_value_windows='disjoint'), which halves the effective window
      count of a 50 %-overlap grid — the measured near-threshold power
      gap vs the fft engine (BENCH_NULL_POWER.json: up to 0.45 at
      W=32) is dominated by exactly that subsetting.

    ``method='auto'`` therefore runs the exact fft engine whenever its
    estimated device cost fits ``fft_flop_budget`` and falls back to
    the rotation engine at scales where O(n_surrogates) cohort passes
    are unaffordable.  The default budget comes from the platform's
    entry in ``mba_tpu.backend`` (about a minute of device time).

    Measured sensitivity cost of that fallback (BENCH_NULL_POWER.json
    ``detection_limit``, sweep W ∈ {8 … 1320} with the rotation arm at
    every cell): the near-threshold rejection-rate gap does NOT vanish
    with W — the coupling grid point where the gap peaks shifts down as
    W grows but its height stays ~0.25–0.45 — yet in coupling units the
    cost is bounded and roughly constant: the rotation engine's
    80 %-power detectable-coupling floor sits at most 11 % above the
    exact fft engine's at every measured window count (cost ratio
    1.08–1.11, W = 8/32/128/512/1320).  That 11 % is the documented
    detection limit of study-scale runs; it is attached to the result
    as ``metadata['sensitivity_note']`` whenever the rotation engine is
    selected so downstream reports carry it.

    Considered and rejected for closing the gap inside the rotation
    engine: two-offset disjoint inference (Bonferroni over the even-
    and odd-parity disjoint subsets, each marginally calibrated).  The
    parities overlap 50 % sample-wise, so their statistics are strongly
    correlated and ``2·min(p_even, p_odd)`` pays the factor 2 without
    the independence that would earn it back — measured in
    tools/bench_null_power.py (``power_rotation_2off``): it never beats
    the single-parity engine by more than replicate noise, while the
    fft engine recovers the full gap.

    All ``**kw`` are forwarded to the chosen engine (rotation-only
    options are dropped with a note when the fft engine is picked).
    Returns the engine's result dict; ``metadata['method']`` records
    which engine ran, ``metadata['engine_choice']`` why.
    """
    if method not in ("auto", "fft", "rotation"):
        raise ValueError("method must be 'auto', 'fft' or 'rotation', "
                         f"got {method!r}")
    eeg = np.asarray(eeg_cohort) if not isinstance(eeg_cohort, jax.Array) \
        else eeg_cohort
    emg = np.asarray(emg_cohort) if not isinstance(emg_cohort, jax.Array) \
        else emg_cohort
    if eeg.ndim != 3 or emg.ndim != 3:
        raise ValueError("cohort arrays must be (J, n_samples, n_channels)")
    J, n_samples, nE = eeg.shape
    nM = emg.shape[2]

    window_length_sec = kw.get("window_length_sec", 2.0)
    overlap_frac = kw.get("overlap_frac", 0.5)
    nw = kw.get("nw", 3)
    band = kw.get("band", (13.0, 100.0))
    window_samples = int(window_length_sec * sampling_freq)
    hop = max(int(window_samples * (1 - overlap_frac)), 1)
    if kw.get("window_starts") is not None:
        W = int(np.asarray(kw["window_starts"]).shape[-1])
    else:
        W = max((n_samples - window_samples) // hop + 1, 1)
    nF = max(int((band[1] - band[0]) * window_length_sec), 1)
    K = max(int(2 * nw - 1), 2)

    choice = method
    est = _fft_null_flops(J, n_samples, nE, nM, W, K, window_samples,
                          nF, n_surrogates)
    if method == "auto":
        if fft_flop_budget is None:
            fft_flop_budget = backend_policy().fft_flop_budget
        choice = "fft" if est <= fft_flop_budget else "rotation"

    if choice == "fft":
        fft_kw = dict(kw)
        dropped = [k for k in ("rotation_mode", "p_value_windows",
                               "compute_dtype", "transfer_dtype",
                               "overlap_upload", "precompute_only",
                               "coeff_engine", "per_window_max_coef_bytes")
                   if fft_kw.pop(k, None) is not None]
        # fft engine uses a smaller default surrogate chunk
        fft_kw.setdefault("surrogate_chunk", 8)
        res = cohort_msc_fft_null(eeg, emg, sampling_freq,
                                  n_surrogates=n_surrogates, **fft_kw)
        if dropped:
            res["metadata"]["dropped_rotation_kwargs"] = dropped
    else:
        res = cohort_msc_rotation_null(eeg, emg, sampling_freq,
                                       n_surrogates=n_surrogates, **kw)
        res["metadata"]["sensitivity_note"] = (
            "rotation engine (calibrated disjoint inference): measured "
            "80%-power detectable-coupling floor at most 11% above the "
            "exact full-FFT engine at every window count in 8..1320 "
            "(BENCH_NULL_POWER.json detection_limit, cost ratio "
            "1.08-1.11); near-threshold rejection-rate gap up to 0.45 "
            "does not vanish with W.")
    res["metadata"]["engine_choice"] = {
        "method_requested": method, "method_run": choice,
        "estimated_fft_flops": est,
        "fft_flop_budget": fft_flop_budget,
    }
    return res
