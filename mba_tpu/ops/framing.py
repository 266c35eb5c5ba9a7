"""Sliding-window framing and resampling as static-shape batch operations.

The reference extracts sliding windows with Python-level fancy indexing
(signal_features.py:398,412) and iterates windows in a hot Python loop
(signal_features.py:725).  On the device, windows become a leading batch axis
materialised by a single gather, so the per-window kernel can be ``vmap``-ed
or scanned with static shapes (SURVEY.md §5 "long-context" note).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def window_grid(n_samples: int, window_samples: int, hop_samples: int,
                sampling_freq: float, convention: str = "cmc"):
    """Host-side global sliding-window grid.

    Two conventions exist in the reference and both are preserved:

    - ``"psd"``: ``starts = arange(0, n_samples - window_samples, hop)``
      (signal_features.py:398) — exclusive stop, so a window starting exactly
      at ``n_samples - window_samples`` is NOT included.
    - ``"cmc"``: ``n_windows = (n_samples - window_samples)//hop + 1``
      (signal_features.py:682) — that window IS included.

    Returns (window_starts int64 array, time_centers float64 array).
    """
    if window_samples > n_samples:
        raise ValueError("window longer than signal")
    if convention == "psd":
        starts = np.arange(0, n_samples - window_samples, hop_samples,
                           dtype=np.int64)
    elif convention == "cmc":
        n_windows = (n_samples - window_samples) // hop_samples + 1
        starts = np.arange(n_windows, dtype=np.int64) * hop_samples
    else:
        raise ValueError(f"unknown window-grid convention: {convention}")
    time_centers = (starts + window_samples / 2) / sampling_freq
    return starts, time_centers


def frame_signal(x: jnp.ndarray, window_starts, window_samples: int
                 ) -> jnp.ndarray:
    """Extract windows as a leading batch axis.

    x : (n_samples, n_channels)  →  (n_windows, window_samples, n_channels)

    Implemented as one gather (indices are a host constant), which XLA turns
    into efficient strided HBM reads.
    """
    starts = jnp.asarray(window_starts, dtype=jnp.int32)
    idx = starts[:, None] + jnp.arange(window_samples, dtype=jnp.int32)[None, :]
    return x[idx]


def resample_linear(data: jnp.ndarray, original_sampling_freq: float,
                    new_sampling_freq: float) -> jnp.ndarray:
    """Linear-interpolation resampling along axis 0.

    Parity: reference signal_features.py:40-56 — time grids are
    ``linspace(0, duration, n)`` on both sides, linear interpolation with
    extrapolation (endpoints coincide so extrapolation never triggers).
    data may be (n_samples,) or (n_samples, n_channels).
    """
    n_timesteps = data.shape[0]
    original_duration = n_timesteps / original_sampling_freq
    new_n = int(round(original_duration * new_sampling_freq))

    old_t = jnp.linspace(0.0, original_duration, n_timesteps)
    new_t = jnp.linspace(0.0, original_duration, new_n)

    # fractional index of each new time on the old grid:
    pos = new_t / (old_t[1] - old_t[0]) if n_timesteps > 1 else jnp.zeros_like(new_t)
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, n_timesteps - 2)
    frac = pos - lo
    if data.ndim == 1:
        return data[lo] * (1 - frac) + data[lo + 1] * frac
    return data[lo] * (1 - frac)[:, None] + data[lo + 1] * frac[:, None]
