"""Opt-in device profiling — ``torch.profiler`` trace capture.

The registry/tracer pair measures *host-side* wall time; what the card
did lives in the profiler's trace.  While :func:`device_trace` captures,
every :class:`~repro_torch.obs.tracer.SpanTracer` span of the process
tracer (build, serve, fleet, net) also opens a profiler range of its name,
and the fleet's stacked pass adds its :func:`trace_annotation` ranges
(``fleet.mesh.query``, ``fleet.mesh.dispatch``), so a captured trace lines
the two views up.  Under any other capture the spans open no range.

Capture is strictly opt-in (profiling is not free)::

    with engine.capture_device_trace("build/trace"):
        engine.run(queries)

then open ``build/trace/trace.json`` in Perfetto or ``chrome://tracing``.
"""
from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path

from repro_torch.obs.tracer import TRACER

__all__ = ["device_trace", "trace_annotation"]


@contextmanager
def device_trace(log_dir):
    """Capture a ``torch.profiler`` trace (host and, where there is a card,
    device activity) of the enclosed block into ``log_dir/trace.json``
    (the directory is created if missing), with every span of ``TRACER``
    opened inside the block drawn as a range of its name.  Reentrant use
    raises: the profiler allows one active trace per process."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        TRACER.profiling = True
        try:
            yield prof
        finally:
            TRACER.profiling = False
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def trace_annotation(name: str):
    """A ``torch.profiler.record_function`` range: a host-side marker that
    shows up on captured traces."""
    from torch.profiler import record_function
    return record_function(name)
