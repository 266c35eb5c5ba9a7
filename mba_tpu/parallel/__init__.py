"""Device-mesh parallelism utilities.

The reference is single-machine Python (SURVEY.md §2.5): its only
parallelism is multiprocessing for acquisition and joblib inside MNE
permutations.  Here, scale comes from ``jax.sharding`` over a device mesh:

- cohort axis (subjects)  → data parallel
- window axis (time)      → sequence parallel (windows are independent)
- surrogate axis          → embarrassingly parallel null realisations

Collectives (``psum`` for cohort reductions, all-gathers inserted by XLA
from sharding constraints) run between the devices.
"""
from mba_tpu.parallel.mesh import make_mesh, cohort_sharding  # noqa: F401
from mba_tpu.parallel.cohort import (  # noqa: F401
    cohort_multitaper_msc, time_sharded_msc,
)
