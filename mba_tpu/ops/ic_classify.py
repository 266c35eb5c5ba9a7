"""ICLabel-equivalent IC artifact classifier (feature-based, transparent).

The reference auto-excludes ICs labeled {heart beat, muscle artifact,
channel noise, eye blink} by the pretrained mne-icalabel network
(preprocessing.py:685-720).  That model cannot ship here, so this module
implements a transparent per-class feature classifier over the same label
vocabulary, with per-artifact-class behavior validated by injection tests
(tests/test_ic_classify.py: plant a synthetic ECG / blink / EMG /
channel-pop / line-hum component, assert it — and only it — is flagged;
specificity and selectivity are asserted per class over many seeds).

Per-class evidence:

- **channel noise** — topography concentration: one channel carries almost
  all of the component's scalp projection (max |w| / ‖w‖ and top-1/top-2
  ratio).
- **eye blink** — frontal topography dominance (Fp*/AF* channels) together
  with low-frequency (< 4 Hz) spectral dominance and one-sided deflections
  (|skewness|).
- **heart beat** — QRS-train periodicity on the 5–18 Hz band (the
  Pan-Tompkins QRS band: 1/f background leak lives almost entirely below
  5 Hz, so band-passing before peak detection keeps the R-peaks supra-3
  robust-σ even when the component carries 40 % background variance):
  low inter-peak-interval CV at 37–150 bpm plus high in-band kurtosis.
- **muscle artifact** — high-band power ratio P(45–250 Hz)/P(20–45 Hz)
  (flat EMG ≈ bandwidth ratio ≫ 1; 1/f EEG ≈ 1.0–1.6 — and, unlike the
  >30 Hz *fraction of total*, the ratio is insensitive to low-frequency
  background leak), gated on the above-20 Hz power fraction being
  material; the 48–52 Hz mains band is excised from both ratio bands so
  hum cannot masquerade as EMG.
- **line noise** — narrowband power concentration at the mains frequency
  (50 Hz ± 1) relative to its spectral neighbourhood.
- **brain / other** — fallback when no artifact class scores.
"""
from __future__ import annotations

import numpy as np

EXCLUDE_CLASSES = ('heart beat', 'muscle artifact', 'channel noise',
                   'eye blink')
LABELS = ('brain', 'eye blink', 'heart beat', 'muscle artifact',
          'channel noise', 'line noise', 'other')


def _sigmoid(x: float, center: float, width: float) -> float:
    return float(1.0 / (1.0 + np.exp(-(x - center) / max(width, 1e-9))))


def _band_fraction(freqs, power, lo, hi, total_lo=0.5):
    total = power[freqs >= total_lo].sum() + 1e-20
    return float(power[(freqs >= lo) & (freqs < hi)].sum() / total)


def _robust_sigma(x: np.ndarray) -> float:
    """MAD-based σ estimate — insensitive to the sparse large peaks whose
    detection it thresholds (a plain std is inflated by the peaks
    themselves plus any broadband contamination)."""
    med = np.median(x)
    return float(1.4826 * np.median(np.abs(x - med)))


def _bandpass_fft(spec: np.ndarray, freqs: np.ndarray, n: int,
                  lo: float, hi: float) -> np.ndarray:
    """Brick-wall band-pass from an already-computed rfft."""
    keep = (freqs >= lo) & (freqs < hi)
    return np.fft.irfft(np.where(keep, spec, 0.0), n=n)


def _spectral_slope(freqs, power, lo=7.0, hi=45.0):
    """Log-log slope of the spectrum in [lo, hi) Hz (EEG ≈ −1…−2; EMG
    ≈ flat or rising)."""
    m = (freqs >= lo) & (freqs < hi) & (power > 0)
    if m.sum() < 8:
        return -1.0
    return float(np.polyfit(np.log10(freqs[m]),
                            np.log10(power[m] + 1e-20), 1)[0])


def _qrs_periodicity(source: np.ndarray, fs: float) -> float:
    """Score ∈ [0, 1] for an ECG-like sharp periodic peak train.

    Detection runs on the 5–18 Hz band (Pan-Tompkins QRS band) with a
    robust (MAD) σ: 1/f background leak concentrates below 5 Hz, so the
    R-peaks stay far above threshold even for heavily contaminated
    components.  ``source`` is expected already band-passed (see
    ``component_features``); falls back to the raw signal for short fs.
    """
    z = (source - source.mean()) / (_robust_sigma(source) + 1e-20)
    a = np.abs(z)
    # local maxima above 3σ with a 250 ms refractory period
    cand = np.flatnonzero((a[1:-1] > 3.0) & (a[1:-1] >= a[:-2])
                          & (a[1:-1] >= a[2:])) + 1
    if len(cand) < 4:
        return 0.0
    refractory = int(0.25 * fs)
    peaks = [int(cand[0])]
    for c in cand[1:]:
        if c - peaks[-1] >= refractory:
            peaks.append(int(c))
    if len(peaks) < 4:
        return 0.0
    ipi = np.diff(peaks) / fs
    med = float(np.median(ipi))
    if not (0.4 <= med <= 1.6):                 # 37–150 bpm
        return 0.0
    # outlier-robust rhythm evidence: the fraction of inter-peak
    # intervals at the median RR *or its double* (a missed beat under
    # heavy contamination produces exactly one doubled interval; a raw
    # CV blows up on those and rejects genuinely rhythmic trains)
    near = np.abs(ipi - med) < 0.2 * med
    doubled = np.abs(ipi - 2.0 * med) < 0.3 * med
    regularity = float(np.mean(near | doubled))
    # peaks (+ the beats hidden inside doubled intervals) must roughly
    # fill the recording; squares keep Poisson-interval impostors low
    expected = (len(source) / fs) / med
    coverage = min((len(peaks) + doubled.sum()) / max(expected, 1.0), 1.0)
    return float(regularity ** 2 * coverage)


def component_features(source: np.ndarray, topo: np.ndarray, fs: float,
                       frontal_idx: list[int],
                       override_kurtosis: float | None = None,
                       override_abs_skew: float | None = None) -> dict:
    """Per-component evidence features (see module docstring).

    ``override_kurtosis`` / ``override_abs_skew`` replace the
    full-signal moments — the device-resident label path computes them
    on the accelerator over the complete recording and ships only the
    spectral-feature segment to the host (ops/ica.py:label_components).
    """
    src = np.asarray(source, np.float64)
    n = len(src)
    n_use = min(n, int(120 * fs))               # cap spectral cost
    seg = src[:n_use] - src[:n_use].mean()
    freqs = np.fft.rfftfreq(n_use, 1.0 / fs)
    spec = np.fft.rfft(seg)
    power = np.abs(spec) ** 2

    # QRS band (5-18 Hz): background leak lives below it
    if fs > 40:
        qrs_sig = _bandpass_fft(spec, freqs, n_use, 5.0, 18.0)
    else:
        qrs_sig = seg
    q_sd = qrs_sig.std() + 1e-20
    qrs_kurtosis = float(np.mean((qrs_sig / q_sd) ** 4) - 3.0)

    # EMG high-band ratio with the mains band excised
    def _band_sum(lo, hi):
        m = (freqs >= lo) & (freqs < hi) & (
            (freqs < 48.0) | (freqs >= 52.0))
        return float(power[m].sum())
    if fs > 120:
        hf_ratio = (_band_sum(45.0, min(fs / 2, 250.0))
                    / (_band_sum(20.0, 45.0) + 1e-20))
        above20_frac = _band_fraction(freqs, power, 20.0, fs / 2)
    else:
        hf_ratio = 0.0
        above20_frac = 0.0

    t = np.abs(np.asarray(topo, np.float64))
    t_norm = t / (np.linalg.norm(t) + 1e-20)
    top = np.sort(t_norm)[::-1]
    line_band = _band_fraction(freqs, power, 49.0, 51.0) \
        if fs > 102 else 0.0
    neighbor = _band_fraction(freqs, power, 44.0, 49.0) \
        + _band_fraction(freqs, power, 51.0, 56.0) if fs > 112 else 1.0

    sd = src.std() + 1e-20
    return {
        "topo_max": float(top[0]),
        "topo_top2_ratio": float(top[0] / (top[1] + 1e-20)),
        "frontal_frac": (float((t_norm[frontal_idx] ** 2).sum())
                         if len(frontal_idx) else 0.0),
        "low_frac": _band_fraction(freqs, power, 0.5, 4.0),
        "high_frac": _band_fraction(freqs, power, 30.0,
                                    min(fs / 2, 250.0)),
        "line_frac": line_band,
        "line_contrast": float(line_band / (neighbor + 1e-20)),
        "spectral_slope": _spectral_slope(freqs, power),
        "hf_ratio": hf_ratio,
        "above20_frac": above20_frac,
        "kurtosis": (float(override_kurtosis)
                     if override_kurtosis is not None else
                     float(np.mean(((src - src.mean()) / sd) ** 4) - 3.0)),
        "qrs_kurtosis": qrs_kurtosis,
        "abs_skew": (float(override_abs_skew)
                     if override_abs_skew is not None else
                     float(abs(np.mean(((src - src.mean()) / sd) ** 3)))),
        "qrs_score": _qrs_periodicity(qrs_sig, fs),
    }


def class_scores(feats: dict, n_ch: int) -> dict:
    """Soft per-class scores ∈ [0, 1] from the evidence features."""
    s = {}
    if n_ch > 2:
        _ratio = _sigmoid(feats["topo_top2_ratio"], 3.0, 0.5)
        # topography alone cannot separate a background-blurred one-hot
        # topo (max|w|/‖w‖ ≈ 0.85) from a sharply focal brain dipole, so
        # the softer-topo path additionally requires the impulsive
        # (high-kurtosis) time course of pops/steps
        s["channel noise"] = max(
            _sigmoid(feats["topo_max"], 0.87, 0.03) * _ratio,
            (_sigmoid(feats["topo_max"], 0.80, 0.03) * _ratio
             * _sigmoid(feats["kurtosis"], 2.0, 0.8)))
    else:
        s["channel noise"] = 0.0
    s["line noise"] = min(_sigmoid(feats["line_frac"], 0.25, 0.05),
                          _sigmoid(feats["line_contrast"], 4.0, 1.0))
    s["eye blink"] = (_sigmoid(feats["frontal_frac"], 0.45, 0.08)
                      * _sigmoid(feats["low_frac"], 0.35, 0.08)
                      * _sigmoid(feats["abs_skew"], 0.25, 0.15))
    s["heart beat"] = (feats["qrs_score"]
                       * _sigmoid(feats["qrs_kurtosis"], 1.0, 0.5))
    s["muscle artifact"] = (_sigmoid(feats["hf_ratio"], 2.2, 0.4)
                            * _sigmoid(feats["above20_frac"], 0.35, 0.08))
    return s


def classify_components(sources: np.ndarray, mixing: np.ndarray, fs: float,
                        channel_names: list[str] | None = None,
                        artifact_threshold: float = 0.5,
                        full_moments: dict | None = None) -> dict:
    """Label every IC with the ICLabel vocabulary.

    sources : (n_samples, n_components); mixing : (n_channels,
    n_components) scalp projections; returns the mne-icalabel-shaped
    contract {'labels': [...], 'y_pred_proba': [...]} plus the full
    per-class score table under 'scores' and features under 'features'.

    ``full_moments``: optional {'kurtosis': (n_comp,), 'abs_skew':
    (n_comp,)} arrays computed externally over the complete recording
    (device-resident path) — ``sources`` may then be just the leading
    spectral-feature segment.
    """
    n_comp = sources.shape[1]
    n_ch = mixing.shape[0]
    frontal_idx = []
    if channel_names is not None:
        frontal_idx = [i for i, ch in enumerate(channel_names)
                       if str(ch).startswith(("Fp", "AF"))]

    labels, probas, all_scores, all_feats = [], [], [], []
    for k in range(n_comp):
        feats = component_features(
            sources[:, k], mixing[:, k], fs, frontal_idx,
            override_kurtosis=(full_moments["kurtosis"][k]
                               if full_moments else None),
            override_abs_skew=(full_moments["abs_skew"][k]
                               if full_moments else None))
        scores = class_scores(feats, n_ch)
        best = max(scores, key=scores.get)
        if scores[best] >= artifact_threshold:
            labels.append(best)
            probas.append(scores[best])
        else:
            labels.append("brain")
            probas.append(1.0 - max(scores.values()))
        all_scores.append(scores)
        all_feats.append(feats)
    return {"labels": labels, "y_pred_proba": probas,
            "scores": all_scores, "features": all_feats}


def auto_exclude_components(result: dict,
                            exclude_classes=EXCLUDE_CLASSES) -> list[int]:
    """Indices to exclude — the reference's class set
    (preprocessing.py:707): heart beat, muscle artifact, channel noise,
    eye blink (line noise is notch-filtered upstream instead)."""
    return [i for i, lab in enumerate(result["labels"])
            if lab in exclude_classes]
