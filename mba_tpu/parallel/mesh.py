"""Mesh construction helpers."""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None,
              axis_shapes: dict[str, int] | None = None) -> Mesh:
    """Create a named device mesh.

    Default layout is 2-D ``('subjects', 'windows')``: subjects (cohort
    members / independent recordings) on the outer axis, sliding windows
    (sequence-parallel) on the inner axis.  Every device reaches every
    other at the same rate, so the factorisation follows the algorithm
    alone: the windows axis takes 2 or 4 devices, whichever is larger and
    leaves at least two subject shards.
    """
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if axis_shapes is None:
        # widest 2-D factorisation: subjects outer, windows inner
        inner = 1
        for cand in (2, 4):
            if n % cand == 0 and n // cand >= 2:
                inner = cand
        axis_shapes = {"subjects": n // inner, "windows": inner}
    names = tuple(axis_shapes)
    shape = tuple(axis_shapes[k] for k in names)
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, names)


def cohort_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for cohort arrays shaped (subjects, windows, ...)."""
    spec = [None] * 2
    if "subjects" in mesh.axis_names:
        spec[0] = "subjects"
    if "windows" in mesh.axis_names:
        spec[1] = "windows"
    return NamedSharding(mesh, P(*spec))
