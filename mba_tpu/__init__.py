"""mba_tpu — accelerator-native multimodal biosignal analysis framework.

A ground-up JAX/XLA re-design of the capabilities of
paulruesing/multimodal-biosignal-analysis: real-time multimodal acquisition,
OTB4 import, multimodal time alignment, preprocessing, multitaper PSD /
cortico-muscular-coherence (CMC) feature extraction, surrogate + permutation
statistics, mixed-effects omnibus testing, cluster-based permutation post-hoc
analysis, heterogeneity / mediation / power analyses and report generation.

Layering (bottom → top), mirroring the reference's layer map (SURVEY.md §1):

- ``mba_tpu.ops``        — jitted array kernels (filtering, DPSS multitaper,
                           fused CSD/coherence, wavelets, surrogates,
                           permutation statistics).  The reference's
                           scipy/numpy hot loops live here as XLA code.
- ``mba_tpu.parallel``   — ``jax.sharding.Mesh`` utilities; cohort / surrogate
                           sharding over device meshes.
- ``mba_tpu.models``     — statistical models: closed-form OLS with Kish
                           design effects, batched profiled-REML mixed models,
                           FDR, mediation, power simulation, heterogeneity.
- ``mba_tpu.pipeline``   — the user-facing pipeline layer mirroring the
                           reference's ``src/pipeline`` public API.
- ``mba_tpu.io``         — OTB4 tar/XML/binary import, artifact store.
- ``mba_tpu.utils``      — timestamped-file artifact store, TxtConfig, IPC.
- ``mba_tpu.workflows``  — the 14 stage scripts of the reference study.
"""

__version__ = "0.1.0"

from mba_tpu import _config  # noqa: F401  (enables XLA compile cache)
from mba_tpu import channel_layout  # noqa: F401
