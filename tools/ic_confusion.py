"""IC-classifier confusion matrix on realistic messy mixtures.

The injection tests planted *clean* synthetic components; real
ICs are messy — 1/f EEG background leaking into artifact sources,
blurred topographies, varying fs / montage / SNR (the reference's
ICLabel is a trained classifier for exactly that reason,
reference pipeline/preprocessing.py:685-720).  This tool generates
semi-realistic components per class:

- every source is contaminated with a mixture of pink-noise EEG
  background sources at a swept leak level (0.1 / 0.25 / 0.4 of
  variance), and every topography is blurred with random leakage;
- fs ∈ {250, 512, 1024, 2048}, montages of 19 / 32 / 64 standard
  channels, several seeds per cell;

then runs ``ops.ic_classify.classify_components`` on each and writes the
per-class confusion matrix + precision/recall for the exclude decision
to ``tests/data/ic_confusion.json``.  ``tests/test_ic_classify.py``
asserts the committed floors.

Run: ``JAX_PLATFORMS=cpu python tools/ic_confusion.py`` (~2 min).
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SECONDS = 60.0
FS_LIST = (250.0, 512.0, 1024.0, 2048.0)
LEAKS = (0.10, 0.25, 0.40)
SEEDS = range(4)

MONTAGES = {
    19: ['Fp1', 'Fp2', 'F7', 'F3', 'Fz', 'F4', 'F8', 'T7', 'C3', 'Cz',
         'C4', 'T8', 'P7', 'P3', 'Pz', 'P4', 'P8', 'O1', 'O2'],
    32: ['Fp1', 'Fpz', 'Fp2', 'AF3', 'AF4', 'F7', 'F3', 'Fz', 'F4',
         'F8', 'FC5', 'FC1', 'FC2', 'FC6', 'T7', 'C3', 'Cz', 'C4',
         'T8', 'CP5', 'CP1', 'CP2', 'CP6', 'P7', 'P3', 'Pz', 'P4',
         'P8', 'PO3', 'PO4', 'O1', 'O2'],
}
MONTAGES[64] = MONTAGES[32] + [
    'AF7', 'AF8', 'F5', 'F1', 'F2', 'F6', 'FT7', 'FC3', 'FCz', 'FC4',
    'FT8', 'C5', 'C1', 'C2', 'C6', 'TP7', 'CP3', 'CPz', 'CP4', 'TP8',
    'P5', 'P1', 'P2', 'P6', 'PO7', 'POz', 'PO8', 'O9', 'Oz', 'O10',
    'Iz', 'FT9']

CLASSES = ('brain', 'eye blink', 'heart beat', 'muscle artifact',
           'channel noise', 'line noise')
EXCLUDE = {'eye blink', 'heart beat', 'muscle artifact', 'channel noise'}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def pink_noise(rng, n, fs, alpha=1.2, alpha_bump=True):
    """1/f^alpha background with an optional ~10 Hz alpha bump."""
    f = np.fft.rfftfreq(n, 1 / fs)
    mag = np.zeros_like(f)
    mag[1:] = f[1:] ** (-alpha / 2)
    if alpha_bump:
        mag += 3.0 * np.exp(-0.5 * ((f - 10.0) / 1.5) ** 2) * mag.max() \
            * 0.02
    spec = mag * np.exp(1j * rng.uniform(0, 2 * np.pi, len(f)))
    x = np.fft.irfft(spec, n=n)
    return x / (x.std() + 1e-12)


def smooth_topo(rng, ch_names, centers=1):
    """Random smooth dipolar-ish topography (no electrode geometry
    needed: smooth = spread over a random subset with graded weights)."""
    n = len(ch_names)
    w = np.zeros(n)
    for _ in range(centers):
        c = rng.integers(n)
        spread = rng.uniform(2.0, 6.0)
        idx = np.arange(n)
        w += rng.choice([-1, 1]) * np.exp(-0.5 * ((idx - c) / spread) ** 2)
    w += 0.05 * rng.standard_normal(n)
    return w / (np.abs(w).max() + 1e-12)


def make_component(cls, fs, ch_names, rng):
    """(source (n,), topo (C,)) for one clean class instance."""
    n = int(SECONDS * fs)
    t = np.arange(n) / fs
    n_ch = len(ch_names)

    if cls == 'brain':
        src = pink_noise(rng, n, fs)
        f0 = rng.uniform(8, 24)
        src += rng.uniform(0.5, 1.5) * np.sin(
            2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
        topo = smooth_topo(rng, ch_names, centers=rng.integers(1, 3))

    elif cls == 'eye blink':
        src = np.zeros(n)
        t_next = rng.uniform(0.5, 3.0)
        while t_next < SECONDS - 0.5:
            w = int(rng.uniform(0.2, 0.4) * fs)
            i0 = int(t_next * fs)
            src[i0:i0 + w] += rng.uniform(0.7, 1.3) * np.hanning(w)[
                :len(src[i0:i0 + w])]
            t_next += rng.uniform(1.5, 6.0)
        src *= 10.0
        topo = 0.08 * rng.standard_normal(n_ch)
        for i, ch in enumerate(ch_names):
            if ch.startswith(('Fp', 'AF')):
                topo[i] = rng.uniform(0.7, 1.0)
            elif ch.startswith('F'):
                topo[i] = rng.uniform(0.15, 0.35)

    elif cls == 'heart beat':
        src = np.zeros(n)
        rr = rng.uniform(0.65, 1.0)                 # 60-92 bpm
        beat = rr
        while beat < SECONDS - 0.3:
            i0 = int(beat * fs)
            qw = max(int(0.09 * fs), 3)
            qrs = np.sin(np.linspace(0, np.pi, qw)) \
                * np.array([1.0])                    # R wave
            src[i0:i0 + qw] += 8.0 * qrs[:len(src[i0:i0 + qw])]
            # small Q/S dips and T wave
            tw = max(int(0.16 * fs), 4)
            i_t = i0 + int(0.25 * fs)
            src[i_t:i_t + tw] += 1.5 * np.hanning(tw)[
                :len(src[i_t:i_t + tw])]
            beat += rr * rng.normal(1.0, 0.05)
        topo = smooth_topo(rng, ch_names, centers=1) * 0.6

    elif cls == 'muscle artifact':
        base = rng.standard_normal(n)
        f = np.fft.rfftfreq(n, 1 / fs)
        spec = np.fft.rfft(base)
        lo = rng.uniform(18, 25)
        spec[f < lo] = 0
        src = np.fft.irfft(spec, n=n)
        # phasic bursts on top of tonic activity
        env = 0.4 + 0.6 * (rng.random(n) < 0.002)
        env = np.convolve(env, np.ones(int(0.5 * fs)) / int(0.5 * fs),
                          mode='same')
        src *= env
        src /= src.std() + 1e-12
        # edge/temporal concentration
        topo = 0.05 * rng.standard_normal(n_ch)
        edge = [i for i, ch in enumerate(ch_names)
                if ch.startswith(('T', 'FT', 'TP', 'F7', 'F8', 'P7',
                                  'P8'))]
        take = rng.choice(edge if edge else np.arange(n_ch),
                          size=min(3, n_ch), replace=False)
        topo[take] = rng.uniform(0.5, 1.0, len(take))

    elif cls == 'channel noise':
        src = np.zeros(n)
        # random pops / steps
        for _ in range(rng.integers(8, 25)):
            i0 = rng.integers(n - int(0.1 * fs))
            w = int(rng.uniform(0.01, 0.08) * fs)
            src[i0:i0 + w] += rng.choice([-1, 1]) * rng.uniform(3, 10)
        src += 0.3 * rng.standard_normal(n)
        topo = 0.02 * rng.standard_normal(n_ch)
        topo[rng.integers(n_ch)] = 1.0

    elif cls == 'line noise':
        am = 1.0 + 0.1 * np.sin(2 * np.pi * 0.2 * t)
        src = am * np.sin(2 * np.pi * 50.0 * t + rng.uniform(0, 2 * np.pi))
        src += 0.05 * rng.standard_normal(n)
        topo = smooth_topo(rng, ch_names, centers=2)

    else:
        raise ValueError(cls)
    return src / (src.std() + 1e-12), topo


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")   # the classifier runs on host
    from mba_tpu.ops.ic_classify import classify_components, EXCLUDE_CLASSES

    t0 = time.perf_counter()
    confusion = {c: {lab: 0 for lab in CLASSES + ('other',)}
                 for c in CLASSES}
    exclude_tp = {c: 0 for c in CLASSES}
    n_cells = {c: 0 for c in CLASSES}
    per_leak = {f"{lk:g}": {"n": 0, "correct_exclude_decision": 0}
                for lk in LEAKS}

    for fs in FS_LIST:
        for n_ch, ch_names in MONTAGES.items():
            for leak in LEAKS:
                for seed in SEEDS:
                    rng = np.random.default_rng(
                        hash((fs, n_ch, leak, seed)) % 2 ** 32)
                    n = int(SECONDS * fs)
                    # background pool shared by all components this cell
                    bg = np.stack([pink_noise(rng, n, fs)
                                   for _ in range(3)], axis=1)
                    sources, topos, truth = [], [], []
                    for cls in CLASSES:
                        src, topo = make_component(cls, fs, ch_names,
                                                   rng)
                        mix = bg @ rng.standard_normal(3)
                        mix /= mix.std() + 1e-12
                        src = np.sqrt(1 - leak) * src \
                            + np.sqrt(leak) * mix
                        topo = topo + leak * 0.5 * smooth_topo(
                            rng, ch_names)
                        sources.append(src)
                        topos.append(topo)
                        truth.append(cls)
                    out = classify_components(
                        np.stack(sources, axis=1),
                        np.stack(topos, axis=1), fs,
                        channel_names=list(ch_names))
                    for cls, lab in zip(truth, out["labels"]):
                        confusion[cls][lab if lab in confusion[cls]
                                       else 'other'] += 1
                        n_cells[cls] += 1
                        should = cls in EXCLUDE
                        did = lab in EXCLUDE_CLASSES
                        if should == did:
                            per_leak[f"{leak:g}"][
                                "correct_exclude_decision"] += 1
                            if should:
                                exclude_tp[cls] += 1
                        per_leak[f"{leak:g}"]["n"] += 1
        log(f"fs={fs:g} done ({time.perf_counter() - t0:.0f}s)")

    # per-class label recall + exclude-decision precision/recall
    metrics = {}
    for cls in CLASSES:
        total = n_cells[cls]
        metrics[cls] = {
            "n": total,
            "label_recall": round(confusion[cls][cls] / total, 3),
            "exclude_decision_accuracy": round(
                (exclude_tp[cls] / total) if cls in EXCLUDE
                else 1.0 - sum(confusion[cls][l]
                               for l in EXCLUDE) / total, 3),
        }
    # precision of the exclude decision: of everything excluded, how
    # much was truly an artifact?
    excluded_total = sum(confusion[c][l] for c in CLASSES
                         for l in EXCLUDE)
    excluded_true = sum(confusion[c][l] for c in CLASSES
                        for l in EXCLUDE if c in EXCLUDE)
    result = {
        "description": "IC classifier confusion on messy mixtures "
                       "(background leak, blurred topographies, fs x "
                       "montage x SNR sweep)",
        "config": {"fs": FS_LIST, "montages": sorted(MONTAGES),
                   "leaks": LEAKS, "seeds": len(list(SEEDS)),
                   "seconds": SECONDS},
        "confusion": confusion,
        "per_class": metrics,
        "exclude_precision": round(
            excluded_true / max(excluded_total, 1), 3),
        "per_leak": {k: {"n": v["n"],
                         "exclude_decision_accuracy": round(
                             v["correct_exclude_decision"]
                             / max(v["n"], 1), 3)}
                     for k, v in per_leak.items()},
        "measured_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                      time.gmtime()),
    }
    out_path = REPO / "tests" / "data" / "ic_confusion.json"
    out_path.write_text(json.dumps(result, indent=2) + "\n")
    log(f"[done] {out_path} in {time.perf_counter() - t0:.0f}s")
    print(json.dumps({k: result[k] for k in
                      ("per_class", "exclude_precision", "per_leak")},
                     indent=2))


if __name__ == "__main__":
    main()
