"""The traced run: the program's ``serve.tick`` / ``query.*`` spans mirrored
as profiler ranges, one ``torch.profiler`` capture of the window, and its
reduction to the numbers the per-layer readers take.

The program opens its spans through ``repro_torch.obs.TRACER``; for the
traced window the benchmark wraps that tracer's ``span`` so that each span
of a name in :data:`SPANS` also opens a ``record_function`` range of the
same name, and the profiler's host ranges and device operations then share
one clock.  A device operation belongs to the stage whose range was open
when the host launched it (the runtime call and the operation share a
correlation id); each stage span of the engine ends in a synchronize, so
its operations also finish inside it.
The profile stays in memory; only the summary leaves this module.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Tuple

SPANS = ("serve.tick", "query.featurize", "query.plan", "query.refine")
WINDOW = "climbench.window"
STAGES = ("query.featurize", "query.plan", "query.refine")
OUTSIDE = "outside_any_span"


@contextmanager
def mirrored_spans(tracer):
    """Within the block, ``tracer.span(name)`` of a name in :data:`SPANS`
    also opens a profiler range ``name``."""
    from torch.profiler import record_function
    original = tracer.span

    @contextmanager
    def span(name, **attrs):
        if name in SPANS:
            with record_function(name), original(name, **attrs) as sp:
                yield sp
        else:
            with original(name, **attrs) as sp:
                yield sp

    tracer.span = span
    try:
        yield
    finally:
        del tracer.span


@contextmanager
def capture():
    """Profile the block (host and device activity); yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=False,
                 profile_memory=False, with_stack=False) as prof:
        with record_function(WINDOW):
            yield prof


def _events(prof):
    """(host ranges of :data:`SPANS` and the window, device operations).
    A host range is (name, start_ns, end_ns); a device operation is (name,
    start_ns, end_ns, launched_ns), where ``launched_ns`` is the host time
    of the runtime call that launched it (matched by correlation id), or
    its start where none matches."""
    from torch.autograd import DeviceType
    ranges = set(SPANS) | {WINDOW}
    host, launches, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if name in ranges:
                host.append((name, start, end))
            elif name.startswith("cu") and e.correlation_id():
                launches[e.correlation_id()] = start
        elif name not in ranges and not getattr(e, "is_user_annotation", bool)():
            # the profiler also draws each range on the device's timeline:
            # those are no operations of the device
            device.append((name, start, end, e.correlation_id()))
    matched = sum(1 for *_, c in device if c in launches)
    device = [(n, a, b, launches.get(c, a)) for n, a, b, c in device]
    return host, device, matched


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def reduce(prof) -> dict:
    """The traced window's summary:

    * ``window_s``, ``busy_s``: the window's length and the seconds in it
      in which some device operation ran (the union of their intervals);
    * ``stage_device_s[name]``, ``stage_kernels[name]``: per stage span, in
      order, the device seconds of the operations launched inside it and
      the number of kernels among them;
    * ``device_ops``: device seconds by operation name;
    * ``idle_by_span``: the device's idle seconds by the innermost host span
      open at the middle of each gap (:data:`OUTSIDE` between calls);
    * ``launch_share``: the share of device operations matched to their
      launch (the rest are placed by their own start).
    """
    host, device, matched = _events(prof)
    launch_share = matched / len(device) if device else 1.0
    windows = [(a, b) for n, a, b in host if n == WINDOW]
    if not windows:
        raise RuntimeError("the profile holds no window range")
    w0, w1 = windows[0]
    device = [(n, max(a, w0), min(b, w1), t) for n, a, b, t in device
              if b > w0 and a < w1]
    device.sort(key=lambda d: d[3])
    launched = [d[3] for d in device]

    ops: Dict[str, float] = defaultdict(float)
    for n, a, b, _ in device:
        ops[n] += (b - a) * 1e-9
    busy = _union([(a, b) for _, a, b, _ in device])

    # a stage's operations are those launched inside its span: attributed
    # by the launch's host time, so no skew between the host's and the
    # device's clocks moves one across a boundary
    stage_device_s: Dict[str, List[float]] = {s: [] for s in STAGES}
    stage_kernels: Dict[str, List[int]] = {s: [] for s in STAGES}
    spans = sorted((a, b, n) for n, a, b in host if n in SPANS)
    for a, b, n in spans:
        if n not in stage_device_s:
            continue
        i, j = bisect.bisect_left(launched, a), bisect.bisect_left(launched, b)
        inside = device[i:j]
        stage_device_s[n].append(sum(e - s for _, s, e, _ in inside) * 1e-9)
        stage_kernels[n].append(sum(1 for nm, _, _, _ in inside if _is_kernel(nm)))

    # idle gaps, each put down to the innermost span open at its middle
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    depth = {"serve.tick": 0, "query.featurize": 1, "query.plan": 1,
             "query.refine": 1}
    span_starts = [s[0] for s in spans]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        owner, level = OUTSIDE, -1
        k = bisect.bisect_right(span_starts, mid)
        # spans are short and sequential: look back over the last few
        for s0, s1, n in spans[max(0, k - 4):k]:
            if s0 <= mid < s1 and depth[n] > level:
                owner, level = n, depth[n]
        idle[owner] += (b - a) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(b - a for a, b in busy) * 1e-9,
            "stage_device_s": stage_device_s, "stage_kernels": stage_kernels,
            "device_ops": dict(ops), "idle_by_span": dict(idle),
            "launch_share": launch_share}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time and the longest idle time by host span, ``[name, seconds]``."""
    def best(d):
        return [[n[:120], s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": best(summary["device_ops"]),
            "idle_gaps": best(summary["idle_by_span"])}
