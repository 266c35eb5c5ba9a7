"""Gram-matmul rotation-null coefficient pass.

The rotation-null coefficient precompute is the study-scale null's main
device cost outside the surrogate contraction.  This module turns it into
matrix products by *factorizing before the outer product*.  The
normalized taper product

    y_k,w(f,e,m) = conj(E_k,w(f,e)) · M_k,w(f,m) · sqrt(wt_w / (pe·pm))

splits exactly into an EEG-only and an EMG-only factor, because the
denominator ``pe_w(f,e) · pm_w(f,m)`` is itself separable:

    y_k conj(y_l) = A_kl,w(f,e) · B_kl,w(f,m)
    A_kl,w = conj(E_k) E_l · sqrt(wt)/pe      (E-side, complex)
    B_kl,w = M_k conj(M_l) · sqrt(wt)/pm      (M-side, complex)

so every window-summed pair product C_kl(f, e, m) = Σ_w A·B is a TRUE
matmul: batch (pair, f), output (E × M) = 64×64 tiles, contraction over
windows (~1 320 at study scale; stacked ×2 for the Re/Im parts).  The
taper-diagonal term contracts over (taper, window) the same way.  The
operands are (wc, P/2, F, E) and (wc, P/2, F, M) — never the
(wc, P/2, F, E·M) pair products — and the E×M outer product happens
inside the contraction.

Band-limited taper-folded DFT.  Only ``band_hi − band_lo`` (~175) of
the 2 049 rfft bins are consumed, so the spectra stage is also a matmul:
one per modality against a constant ``(S, 2·K·F_band)`` matrix with the
DPSS tapers folded in — no (wc, K, C, S) tapered-frame materialization,
frames are read once.  Twiddle angles are computed with an exact integer
``(s·f) mod S`` reduction (s·f ≤ 4096·2048 < 2³¹), so the factor table
carries no large-angle cos/sin error.  ``spectra='fft'`` keeps
``jnp.fft.rfft`` as the bit-conservative option.

Matmul precision: both stages run at ``Precision.HIGH``, which XLA runs
as TF32 on the H100 (the same results as the default precision there;
the study-scale observed map agreed with ``multitaper_msc`` to 1.6e-5 in
``chip_smoke.py``, inside its 1e-4 bar).  On the CPU precision is ignored
(exact f32), which is what the parity tests pin against the loop
engine.

Parity: ``tests/test_gram_coeffs.py`` asserts coefficient-level
agreement with ``cohort_null._rotation_coeffs_body`` (both spectra
modes, int8/int16 transfer dtypes, masked + padded windows).
Reference anchor: the statistic this feeds matches the window-mean MSC
of reference ``src/pipeline/signal_features.py:619-839``; the
rotation-null engine itself has no reference counterpart.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

_F32_TINY = np.float32(np.finfo(np.float32).tiny)
# clamp each power factor at sqrt(tiny) so the factorized denominator
# pe'·pm' ≥ tiny matches the fused engine's max(pe·pm, tiny) clamp in
# the degenerate (zero-signal) region
_EPS_HALF = np.float32(np.sqrt(np.finfo(np.float32).tiny))

DFT_PRECISION = jax.lax.Precision.HIGH
GRAM_PRECISION = jax.lax.Precision.HIGH
GRAM_CHUNK = 512


def _pair_indices(K: int):
    ks, ls = np.triu_indices(K, k=1)
    return ks.astype(np.int32), ls.astype(np.int32)


def band_dft_tapered(tapers, window_samples: int, band_lo: int,
                     band_hi: int) -> jnp.ndarray:
    """Constant (S, 2·K·F) taper-folded band DFT matrix (traceable).

    ``out[s, (part, k, f)] = taper[k, s] · {cos, sin}(−2π·s·(band_lo+f)/S)``
    — multiplying a frame (…, S) by this matrix yields the Re/Im parts
    of its K tapered band spectra in one matmul contraction.  The angle is
    reduced with exact int32 arithmetic (s·f < 2³¹ at any power-of-2
    window this framework uses) before the trig, so there is no
    large-argument cos error.
    """
    S = window_samples
    K = tapers.shape[0]
    nF = band_hi - band_lo
    s_idx = jnp.arange(S, dtype=jnp.int32)
    f_idx = jnp.arange(band_lo, band_hi, dtype=jnp.int32)
    sf = (s_idx[:, None] * f_idx[None, :]) % S          # exact, (S, F)
    ang = sf.astype(jnp.float32) * np.float32(-2.0 * np.pi / S)
    tr = jnp.stack([jnp.cos(ang), jnp.sin(ang)])        # (2, S, F)
    # fold tapers: (2, S, F) × (K, S) → (S, 2, K, F)
    D = tr[:, None] * tapers[None, :, :, None]          # (2, K, S, F)
    return jnp.transpose(D, (2, 0, 1, 3)).reshape(S, 2 * K * nF)


def gram_coeffs_subject(eeg, emg, starts, weights, tapers,
                        window_samples: int, band_lo: int, band_hi: int,
                        gram_chunk: int = GRAM_CHUNK,
                        spectra: str = "dft",
                        dft_precision=None, gram_precision=None):
    """Per-subject rotation-null coefficients via gram matmuls.

    Same contract as ``cohort_null._rotation_coeffs_body`` (shared
    rotation mode): returns ``(base (F, E, M), coef (F, E, M, P))`` with
    P = K(K−1) (cos pairs then sin pairs), where
    ``stat(φ) = base + feats(φ)·coef`` is the weighted window-mean MSC
    under taper-rotated EMG spectra.  Fully traceable; eeg (n, E) /
    emg (n, M) in any real dtype (f32 cast happens per window chunk).
    """
    if spectra not in ("dft", "fft"):
        raise ValueError(f"spectra must be 'dft' or 'fft', got {spectra!r}")
    dft_precision = dft_precision or DFT_PRECISION
    gram_precision = gram_precision or GRAM_PRECISION
    K = tapers.shape[0]
    ks, ls = _pair_indices(K)
    nF = band_hi - band_lo
    nE = eeg.shape[1]
    nM = emg.shape[1]
    P2 = len(ks)

    W = starts.shape[0]
    gc = int(min(gram_chunk, W))
    pad = (-W) % gc
    if pad:
        starts = jnp.concatenate([starts, jnp.tile(starts[:1], pad)])
        weights = jnp.concatenate([weights,
                                   jnp.zeros(pad, weights.dtype)])
    starts_c = starts.reshape(-1, gc)
    weights_c = weights.reshape(-1, gc)

    from mba_tpu.ops.framing import frame_signal
    if spectra == "dft":
        D = band_dft_tapered(tapers, window_samples, band_lo, band_hi)

    def _band_spectra(sig, cs):
        """(n, C) signal + (gc,) starts → Re/Im (gc, K, F, C) f32."""
        fr = frame_signal(sig, cs, window_samples).astype(jnp.float32)
        if spectra == "fft":
            Xf = jnp.fft.rfft(fr[:, None] * tapers[None, :, :, None],
                              axis=2)[:, :, band_lo:band_hi]
            return Xf.real, Xf.imag                      # (gc, K, F, C)
        C = sig.shape[1]
        Xq = jnp.einsum("wsc,sq->wcq", fr, D,
                        precision=dft_precision,
                        preferred_element_type=jnp.float32)
        Xq = Xq.reshape(-1, C, 2, K, nF)                 # (gc, C, 2, K, F)
        Xq = jnp.moveaxis(Xq, 1, -1)                     # (gc, 2, K, F, C)
        return Xq[:, 0], Xq[:, 1]

    def _side_operands(Xr, Xi, sqrtw):
        """Per-modality gram operands from (gc, K, F, C) spectra."""
        power = (Xr * Xr + Xi * Xi)                      # (gc, K, F, C)
        inv = sqrtw[:, None, None] \
            / jnp.maximum(power.sum(axis=1), _EPS_HALF)  # (gc, F, C)
        diag_op = power * inv[:, None]                   # (gc, K, F, C)
        return diag_op, inv

    def chunk(carry, cw):
        cs, wts = cw
        Er, Ei = _band_spectra(eeg, cs)
        Mr, Mi = _band_spectra(emg, cs)
        sqrtw = jnp.sqrt(wts.astype(jnp.float32))
        a_diag, ipe = _side_operands(Er, Ei, sqrtw)
        b_diag, ipm = _side_operands(Mr, Mi, sqrtw)
        diag = jnp.einsum("wkfe,wkfm->fem", a_diag, b_diag,
                          precision=gram_precision,
                          preferred_element_type=jnp.float32)
        # E side: A_kl = conj(E_k)·E_l · sqrt(wt)/pe
        Ar = (Er[:, ks] * Er[:, ls] + Ei[:, ks] * Ei[:, ls]) * ipe[:, None]
        Ai = (Er[:, ks] * Ei[:, ls] - Ei[:, ks] * Er[:, ls]) * ipe[:, None]
        # M side: B_kl = M_k·conj(M_l) · sqrt(wt)/pm
        Br = (Mr[:, ks] * Mr[:, ls] + Mi[:, ks] * Mi[:, ls]) * ipm[:, None]
        Bi = (Mi[:, ks] * Mr[:, ls] - Mr[:, ks] * Mi[:, ls]) * ipm[:, None]

        def g(x, y):                                     # (gc,P2,F,C)²→
            return jnp.einsum("wpfe,wpfm->pfem", x, y,   # (P2,F,E,M)
                              precision=gram_precision,
                              preferred_element_type=jnp.float32)

        re_c = g(Ar, Br) - g(Ai, Bi)     # Re Σ_w y_k conj(y_l)
        im_c = g(Ar, Bi) + g(Ai, Br)     # Im Σ_w y_k conj(y_l)
        return (carry[0] + diag, carry[1] + re_c, carry[2] + im_c), None

    C0 = (jnp.zeros((nF, nE, nM), jnp.float32),
          jnp.zeros((P2, nF, nE, nM), jnp.float32),
          jnp.zeros((P2, nF, nE, nM), jnp.float32))
    (diag, re_c, im_c), _ = jax.lax.scan(chunk, C0, (starts_c, weights_c))

    wsum = jnp.maximum(weights.sum(), _F32_TINY)
    base = diag / wsum
    coef = jnp.concatenate([2.0 * re_c, -2.0 * im_c], axis=0) / wsum
    return base, jnp.moveaxis(coef, 0, -1)               # (F, E, M, P)
