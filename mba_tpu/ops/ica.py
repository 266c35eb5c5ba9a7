"""Extended-Infomax ICA as a jitted device kernel + heuristic IC labeling.

The reference delegates ICA to MNE (preprocessing.py:654-682: extended
infomax, 25 components, seed 42) and component labeling to the pretrained
mne-icalabel classifier (:685-720).  Neither is available here, so both are
implemented natively:

- :class:`InfomaxICA` — PCA whitening + extended-Infomax natural-gradient
  learning (Lee, Girolami & Sejnowski 1999) with kurtosis-based sub/super-
  Gaussian switching, learning-rate annealing and weight-change convergence.
  The epoch loop is a ``lax.while_loop`` over a ``lax.scan`` of mini-batch
  natural-gradient steps — one compiled program, matmuls throughout.
- :func:`label_components` — a transparent rule-based classifier emitting
  the same label vocabulary the reference excludes on
  ('eye blink', 'heart beat', 'muscle artifact', 'channel noise', 'brain',
  'other'): frontal low-frequency topographies → blink, periodic
  sharp-peaked sources → heart beat, high-frequency power → muscle,
  single-channel topographies → channel noise.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.partial(jax.jit,
                   static_argnames=("n_comp", "block", "max_iter",
                                    "ext_blocks", "batch_layout"))
def _extended_infomax(key, x_white, n_comp, block, max_iter,
                      l_rate, ext_blocks=1, w_change_tol=1e-7,
                      anneal_deg=60.0, anneal_step=0.9,
                      batch_layout="comb"):
    """Run extended Infomax on whitened data (T, n_comp) → W (n_comp²)."""
    n_samples = x_white.shape[0]
    n_blocks = n_samples // block
    eye = jnp.eye(n_comp, dtype=jnp.float32)

    # Batch layout.  MNE permutes SAMPLES each epoch; on a device that
    # is a 3.5M-key sort plus a row gather of the whole (n, C) array at
    # 100 B granularity per epoch, several times the cost of the actual
    # natural-gradient scan.  Instead the blocks are built
    # ONCE as a decimated comb — block b = samples {i·n_blocks + b},
    # each block spanning the whole recording with its samples
    # ~n_blocks (≈1.6 s) apart — which decorrelates better than an iid
    # draw packs into contiguous memory; per epoch only the (cheap,
    # contiguous) block ORDER is rotated.  Convergence quality is
    # pinned by the planted-source recovery tests (tests/test_ops_ica
    # .py) and the study-scale sweep (BENCH_ICA.json).
    # ``batch_layout='reference'`` opts back into the MNE-style
    # per-epoch sample permutation (full gather per epoch) for
    # exact-parity investigations against the upstream framework.
    x_comb = x_white[: n_blocks * block].reshape(
        (block, n_blocks, n_comp)).transpose(1, 0, 2)

    def epoch(state):
        key, w, signs, lrate, old_w, old_d_w, angle_delta, step, done = state
        key, sub = jax.random.split(key)
        if batch_layout == "reference":
            perm = jax.random.permutation(sub, n_blocks * block)
            data = x_white[perm].reshape((n_blocks, block, n_comp))
        else:
            shift = jax.random.randint(sub, (), 0, n_blocks)
            data = jnp.roll(x_comb, shift, axis=0)

        def batch_step(w, xb):
            u = xb @ w                                     # (block, n)
            y = jnp.tanh(u)
            # extended-infomax natural gradient (Lee et al. 1999; with the
            # u = XW right-multiplication convention the relative gradient
            # multiplies W from the left):
            w = w + lrate * (w @ (block * eye
                                  - signs[None, :] * (u.T @ y)
                                  - u.T @ u))
            return w, jnp.sum(u ** 2)  # carry source energy for diagnostics

        # unroll: the chain is serial either way, but unrolling lets XLA
        # overlap the (block,C) HBM reads of step i+1 with step i's tiny
        # matmuls instead of paying the loop turnaround per step
        w_new, _ = jax.lax.scan(batch_step, w, data, unroll=8)

        # kurtosis-based sign update (sub- vs super-Gaussian components)
        u_all = x_white[:min(n_samples, 6000)] @ w_new
        m2 = jnp.mean(u_all ** 2, axis=0)
        m4 = jnp.mean(u_all ** 4, axis=0)
        kurt = m4 / jnp.maximum(m2 ** 2, 1e-12) - 3.0
        new_signs = jnp.where(kurt >= 0, 1.0, -1.0).astype(jnp.float32)

        # convergence / annealing (MNE-style angle criterion)
        d_w = w_new - w
        change = jnp.sum(d_w * d_w)
        dot = jnp.sum(d_w * old_d_w)
        denom = jnp.sqrt(jnp.maximum(change, 1e-30)
                         * jnp.maximum(jnp.sum(old_d_w * old_d_w), 1e-30))
        angle = jnp.degrees(jnp.arccos(jnp.clip(dot / denom, -1.0, 1.0)))
        anneal = angle > anneal_deg
        lrate = jnp.where(anneal, lrate * anneal_step, lrate)
        old_d_w = jnp.where(anneal, d_w, old_d_w)

        blowup = ~jnp.isfinite(change) | (change > 1e9)
        w_new = jnp.where(blowup, eye, w_new)
        lrate = jnp.where(blowup, lrate * 0.5, lrate)

        done = (change < w_change_tol) & (step > 1)
        return (key, w_new, new_signs, lrate, w, old_d_w, angle, step + 1,
                done)

    def cond(state):
        *_, step, done = state
        return (~done) & (step < max_iter)

    init = (key, eye, jnp.ones((n_comp,), jnp.float32),
            jnp.float32(l_rate), eye, eye.copy(), jnp.float32(0.0),
            jnp.int32(0), jnp.bool_(False))
    final = jax.lax.while_loop(cond, epoch, init)
    return final[1], final[7]  # W, n_iter


@jax.jit
def _mean_cov(x):
    """Channel mean + covariance on device (x: (T, C) f32).

    One matmul replaces the host's O(T·C²) pass — at the
    preprocessing hot-spot scale (64 ch × ≥20 min @ 2048 Hz,
    reference preprocessing.py:654-682) the host pass alone costs
    seconds on a 1-core machine.
    """
    mean = x.mean(axis=0)
    xc = x - mean
    cov = xc.T @ xc / x.shape[0]
    return mean, cov


@jax.jit
def _project(x, mean, proj_t):
    """(x - mean) @ proj_t.T on device."""
    return (x - mean) @ proj_t.T


@jax.jit
def _source_moments(src):
    """Per-column excess kurtosis and |skewness| (device reduction).

    Matches the host formulas in ``ic_classify.component_features``
    (z-scored central moments with a +1e-20 σ guard)."""
    mu = src.mean(axis=0, keepdims=True)
    sd = src.std(axis=0, keepdims=True) + 1e-20
    z = (src - mu) / sd
    return (jnp.mean(z ** 4, axis=0) - 3.0,
            jnp.abs(jnp.mean(z ** 3, axis=0)))


class InfomaxICA:
    """Extended-Infomax ICA with PCA whitening (MNE-equivalent role).

    All heavy linear algebra (covariance, whitening, source projection,
    artifact reconstruction) runs on device; the host only does the
    C×C eigendecomposition.  ``n_components`` is capped at the data's
    numerical rank (relative eigenvalue threshold 1e-10): whitening a
    null-space direction would amplify float noise into a fake
    component — the effective count is exposed as ``n_components_``.

    Deliberate behavioral deviation from MNE's extended infomax
    (reference preprocessing.py:654-682): the default mini-batch layout
    is a fixed decimated comb whose block ORDER is re-rolled per epoch,
    not MNE's per-epoch sample permutation — epoch trajectories and
    ``n_iter_`` therefore differ from MNE on identical data/seed even
    though planted-source recovery matches.  Pass
    ``batch_layout='reference'`` to opt into the MNE-style per-epoch
    sample permutation (full gather per epoch, ~3-10× slower epochs at
    study scale) when investigating exact parity against the upstream
    framework.
    """

    def __init__(self, n_components: int, max_iter: int = 500,
                 random_state: int = 42, l_rate: float | None = None,
                 block: int | None = None,
                 batch_layout: str = "comb"):
        if batch_layout not in ("comb", "reference"):
            raise ValueError("batch_layout must be 'comb' or "
                             f"'reference', got {batch_layout!r}")
        self.n_components = n_components
        self.max_iter = max_iter
        self.random_state = random_state
        self.l_rate = l_rate
        self.block = block
        self.batch_layout = batch_layout
        self.exclude: list[int] = []

    def fit(self, data: np.ndarray) -> "InfomaxICA":
        """data: (n_samples, n_channels) — numpy or device-resident."""
        x_d = jnp.asarray(data, jnp.float32)
        n_samples, n_ch = x_d.shape

        mean_d, cov_d = _mean_cov(x_d)
        cov = np.asarray(cov_d, np.float64)
        self._mean = np.asarray(mean_d, np.float64)
        eigval, eigvec = np.linalg.eigh(cov)
        order = np.argsort(eigval)[::-1]
        eigval = eigval[order]
        eigvec = eigvec[:, order]
        # numerical-rank cap (rank-deficient recordings: bridged/flat
        # channels, interpolated montages).  The covariance is an f32
        # device matmul, so null-space eigenvalues land at ~n·eps_f32
        # relative (measured ~2e-8 for rank-3 toy data); the standard
        # n·eps threshold sits well above that noise floor and below
        # any component resolvable in f32 at all.
        tol = max(eigval[0], 0.0) * n_ch * np.finfo(np.float32).eps
        rank = int((eigval > tol).sum())
        n_comp = min(self.n_components, n_ch, max(rank, 1))
        self.n_components_ = n_comp
        eigval = np.maximum(eigval[:n_comp], 1e-12)
        eigvec = eigvec[:, :n_comp]
        self._whitener = (eigvec / np.sqrt(eigval)).T      # (n_comp, C)
        self._dewhitener = (eigvec * np.sqrt(eigval))      # (C, n_comp)
        x_white = _project(x_d, mean_d,
                           jnp.asarray(self._whitener, jnp.float32))

        # MNE/EEGLAB block heuristic √(n/3).  With the roll+strided
        # batch layout the epoch is data-bound, not step-bound
        # (tools/profile_ica.py: ~10 µs/step at the default block,
        # per-epoch scan ≈ constant across block sizes), so the
        # MNE-equivalent default stays; ``block`` is exposed for
        # experiments.
        if self.block is not None:
            block = int(self.block)
        else:
            block = int(np.floor(np.sqrt(n_samples / 3.0)))
        block = max(8, min(block, n_samples))
        self.block_ = block
        l_rate = self.l_rate or 0.01 / np.log(n_comp ** 2.0)
        w, n_iter = _extended_infomax(
            jax.random.PRNGKey(self.random_state),
            x_white, n_comp, block, self.max_iter,
            np.float32(l_rate), batch_layout=self.batch_layout)
        self._w = np.asarray(w, np.float64)                # (n_comp, n_comp)
        self.n_iter_ = int(n_iter)

        # unmixing: sources = (x - mean) @ unmixing.T
        self.unmixing_ = self._w.T @ self._whitener        # (n_comp, C)
        self.mixing_ = np.linalg.pinv(self.unmixing_)      # (C, n_comp)
        return self

    def get_sources(self, data: np.ndarray) -> np.ndarray:
        """(n_samples, n_components) source estimates (device matmul)."""
        x_d = jnp.asarray(data, jnp.float32)
        return np.asarray(_project(
            x_d, jnp.asarray(self._mean, jnp.float32),
            jnp.asarray(self.unmixing_, jnp.float32)), np.float64)

    def apply(self, data: np.ndarray,
              exclude: list[int] | None = None) -> np.ndarray:
        """Reconstruct data with the excluded components removed.

        Mirrors ``mne.preprocessing.ICA.apply`` (reference
        preprocessing.py:718): the artifact subspace is projected out, the
        remainder (including any non-retained PCA subspace) is kept.
        A device-resident input stays on device (float32); numpy input
        returns numpy float64 as before.
        """
        exclude = exclude if exclude is not None else self.exclude
        on_device = isinstance(data, jax.Array)
        if not len(exclude):
            return data if on_device else np.asarray(data,
                                                     np.float64).copy()
        x_d = jnp.asarray(data, jnp.float32)
        mean_d = jnp.asarray(self._mean, jnp.float32)
        # artifact = sources[:, exclude] @ mixing[:, exclude].T, fused:
        # (x - mean) @ (unmixing[exclude].T @ mixing[:, exclude].T)
        proj = (self.unmixing_[exclude].T
                @ self.mixing_[:, exclude].T)              # (C, C)
        artifact = _project(x_d, mean_d, jnp.asarray(proj.T, jnp.float32))
        if on_device:
            return x_d - artifact
        return np.asarray(data, np.float64) - np.asarray(artifact,
                                                         np.float64)


# --------------------------------------------------------------------------
# component labeling (ICLabel-equivalent vocabulary)
# --------------------------------------------------------------------------
def label_components(ica: InfomaxICA, data: np.ndarray, fs: float,
                     channel_names: list[str] | None = None) -> dict:
    """Per-class feature-based IC labels (mne-icalabel contract).

    Same output contract as mne_icalabel.label_components (reference
    preprocessing.py:701-705): per component one of 'brain', 'eye blink',
    'heart beat', 'muscle artifact', 'channel noise', 'line noise',
    'other'.  Delegates to :mod:`mba_tpu.ops.ic_classify`, whose per-class
    evidence (topography concentration, frontal dominance, spectral slope,
    QRS periodicity, line-frequency contrast) is validated by per-class
    injection tests (tests/test_ic_classify.py).
    """
    from mba_tpu.ops.ic_classify import classify_components

    if isinstance(data, jax.Array):
        # device-resident path: sources are projected on device; the host
        # receives only the 120-s spectral-feature segment (the
        # classifier's spectral cost cap) plus the per-component
        # full-length moments — ~25 MB instead of the ~700 MB full
        # source download at study scale (28 min × 25 components)
        src_d = _project(jnp.asarray(data, jnp.float32),
                         jnp.asarray(ica._mean, jnp.float32),
                         jnp.asarray(ica.unmixing_, jnp.float32))
        n_use = min(src_d.shape[0], int(120 * fs))
        kurt_d, skew_d = _source_moments(src_d)
        seg = np.asarray(src_d[:n_use], np.float64)
        moments = {"kurtosis": np.asarray(kurt_d, np.float64),
                   "abs_skew": np.asarray(skew_d, np.float64)}
        out = classify_components(seg, ica.mixing_, fs, channel_names,
                                  full_moments=moments)
    else:
        sources = ica.get_sources(data)
        out = classify_components(sources, ica.mixing_, fs, channel_names)
    return {'y_pred_proba': out['y_pred_proba'], 'labels': out['labels']}
