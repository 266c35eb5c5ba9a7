"""Per-stage timing + JAX profiler tracing.

The reference's observability is tqdm bars, verbose prints and the
exponential-backoff heartbeat decorator (function_decorators.py:6-66).
This module is the JAX build's upgrade (SURVEY.md §5): a stage timer
that understands JAX's async dispatch, and a thin wrapper over
``jax.profiler`` for on-demand device traces.
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from pathlib import Path


def _block(result):
    """Wait for async JAX work so wall times mean what they say."""
    import jax
    return jax.block_until_ready(result)


class StageTimer:
    """Accumulates named stage wall times; prints / saves a summary.

    >>> timer = StageTimer()
    >>> with timer.stage("filtering"):
    ...     filtered = bandpass_filter(x, fs, 1, 100)
    >>> timer.report()
    """

    def __init__(self, name: str = "pipeline", sync_jax: bool = True):
        self.name = name
        self.sync_jax = sync_jax
        self.stages: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, label: str, result_getter=None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if self.sync_jax and result_getter is not None:
                _block(result_getter())
            self.stages.append((label, time.perf_counter() - t0))

    def timed(self, label: str):
        """Decorator variant: blocks on the function's (JAX) result."""
        def deco(fn):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if self.sync_jax:
                    _block(out)
                self.stages.append((label,
                                    time.perf_counter() - t0))
                return out
            return wrapper
        return deco

    @property
    def total(self) -> float:
        return sum(t for _, t in self.stages)

    def report(self, printer=print) -> str:
        total = max(self.total, 1e-12)
        lines = [f"[{self.name}] stage timings:"]
        for label, t in self.stages:
            lines.append(f"  {label:<32s} {t:9.3f} s "
                         f"({100 * t / total:5.1f} %)")
        lines.append(f"  {'TOTAL':<32s} {total:9.3f} s")
        text = "\n".join(lines)
        if printer is not None:
            printer(text)
        return text

    def save(self, save_dir: str | Path) -> Path:
        from mba_tpu.utils import file_management as filemgmt
        save_dir = Path(save_dir)
        filemgmt.assert_dir(save_dir)
        path = save_dir / filemgmt.file_title(
            f"Stage Timings {self.name}", ".json")
        with open(path, "w") as f:
            json.dump({"name": self.name,
                       "stages": [{"label": lb, "seconds": t}
                                  for lb, t in self.stages],
                       "total_seconds": self.total}, f, indent=2)
        return path


@contextlib.contextmanager
def device_trace(trace_dir: str | Path, enabled: bool = True):
    """Capture a ``jax.profiler`` trace (TensorBoard/Perfetto format).

    Wrap the hot section once compilation is warm:

    >>> with device_trace("/tmp/trace"):
    ...     multitaper_msc(eeg, emg, fs)

    ``enabled=False`` makes it a no-op so call sites can keep the
    context manager unconditionally.
    """
    if not enabled:
        yield
        return
    import jax
    trace_dir = str(trace_dir)
    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(label: str):
    """Named region inside a trace (shows up on the device timeline)."""
    import jax
    return jax.profiler.TraceAnnotation(label)


def trace_summary(trace_dir: str | Path,
                  plane_prefix: str = "/device:GPU") -> dict:
    """Reduce the newest ``jax.profiler`` trace under ``trace_dir``.

    For every line of every plane whose name starts with ``plane_prefix``:
    its event count, the union of its event intervals (busy seconds) and
    the summed seconds of each event name.  Returns
    ``{plane: {line: {"events", "busy_sec", "span_sec", "ops"}}}``.
    """
    from jax.profiler import ProfileData
    paths = sorted(glob.glob(os.path.join(
        str(trace_dir), "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = ProfileData.from_file(paths[-1])
    out = {}
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        lines = {}
        for line in plane.lines:
            spans, ops = [], {}
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                ops[ev.name] = ops.get(ev.name, 0.0) + ev.duration_ns * 1e-9
            busy, end = 0.0, None
            for a, b in sorted(spans):
                if end is None or a > end:
                    busy += b - a
                    end = b
                elif b > end:
                    busy += b - end
                    end = b
            lines[line.name] = {
                "events": len(spans), "busy_sec": busy * 1e-9,
                "span_sec": ((max(b for _, b in spans)
                              - min(a for a, _ in spans)) * 1e-9
                             if spans else 0.0),
                "ops": ops}
        out[plane.name] = lines
    return out
