"""Attribute the pipeline PSD stage's device time.

Stage 3a of the pipeline (three multitaper-PSD passes + band
aggregation) is timed as a whole by tools/bench_pipeline.py.  This probe
times each leg at the study shape on the device, twice (compile vs
steady):

  1. frame gather       (frame_signal — full (W, S, C) materialize)
  2. PSD kernel         (_mt_psd_kernel chunked map over frames)
  3. band aggregation   (band_aggregate_spectrogram epilogue)
  4. end-to-end         (multitaper_psd device_output=True)

Run on the card:  python tools/profile_psd.py [minutes]
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FS = 2048.0
N_CH = 64
WINDOW_SEC = 1.0


def main():
    minutes = float(sys.argv[1]) if len(sys.argv) > 1 else 28.4
    import jax
    import jax.numpy as jnp
    from mba_tpu.ops.framing import frame_signal, window_grid
    from mba_tpu.ops import spectral
    from mba_tpu.pipeline import signal_features as features

    n = int(minutes * 60 * FS)
    print(f"[setup] {minutes:.1f} min x {N_CH} ch on "
          f"{jax.devices()[0].platform}", file=sys.stderr)
    # synthesize ON DEVICE — the probe measures compute, not the upload
    x_d = jax.jit(lambda k: jax.random.normal(k, (n, N_CH), jnp.float32))(
        jax.random.PRNGKey(0))
    jax.block_until_ready(x_d)

    ws = int(WINDOW_SEC * FS)
    hop = ws // 2
    starts, _tc = window_grid(n, ws, hop, FS, convention="psd")
    print(f"[setup] {len(starts)} windows of {ws}", file=sys.stderr)

    def timed(label, fn, reps=2):
        outs = []
        for r in range(reps):
            t0 = time.perf_counter()
            out = fn()
            jax.block_until_ready(out)
            outs.append(time.perf_counter() - t0)
        print(f"{label}: first {outs[0]:.2f}s"
              + "".join(f", rep{r} {t:.2f}s"
                        for r, t in enumerate(outs[1:], 1)),
              file=sys.stderr)
        return out

    # 1. gather only
    frames = timed("frame gather (W,S,C)",
                   lambda: frame_signal(x_d, starts, ws))

    # 2. PSD kernel over the pre-framed tensor (chunked like production)
    from mba_tpu.ops.dpss import dpss_windows
    tapers = jnp.asarray(dpss_windows(ws, 3, 5), jnp.float32)
    onesided = jnp.asarray(spectral._onesided_scale(ws // 2 + 1, ws))
    inv_fs_n = np.float32(1.0 / (FS * ws))

    def psd_pass(chunk=128):
        outs = []
        for i in range(0, frames.shape[0], chunk):
            outs.append(spectral._mt_psd_kernel(
                frames[i:i + chunk], tapers, onesided, inv_fs_n, True))
        return jnp.concatenate(outs, axis=0)

    spec = timed("PSD kernel (chunked 128)", psd_pass)

    # 3. band aggregation epilogue
    fr = np.fft.rfftfreq(ws, d=1.0 / FS)
    agg = timed("band aggregate", lambda:
                features.band_aggregate_spectrogram(spec, fr)[0])
    del agg, spec, frames

    # 4. end to end (production entry)
    def e2e():
        s_dev, tc, fr2 = features.multitaper_psd(
            x_d, FS, nw=3, window_length_sec=WINDOW_SEC,
            overlap_frac=0.5, axis=0, apply_log_scale=True,
            device_output=True)
        payload, names, edges = features.band_aggregate_spectrogram(
            s_dev, fr2)
        return payload

    timed("end-to-end multitaper_psd + band_agg", e2e)


if __name__ == "__main__":
    main()
