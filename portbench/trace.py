"""Reading a ``torch.profiler`` capture of the traced window: the device's
busy time (the union of its kernels, copies and sets), its time by kernel
name, and the idle gaps between device activity named by what the host's
main thread was doing then (the innermost host event open at the gap's
middle: an operator, a runtime call or one of the benchmark's own ranges).

A host range (``record_function``: the benchmark's own ``portbench.*``, or
any the program opens) also appears on the device's timeline, spanning the
work it enqueued; it is not device activity. Such an event is left out: it
is flagged as a user annotation, or it bears the name of a host event of
the same capture (no kernel, copy or set is named like a host event), or
it is one of the benchmark's ranges.

Timestamps are the profiler's, in host nanoseconds (``time.time_ns``'s
clock), so the window is clipped to the benchmark's own clock readings.
"""
from __future__ import annotations

import bisect
import collections

import torch

RANGE_PREFIX = "portbench."


def read(prof, t0_ns: int, t1_ns: int, main_thread: int | None = None, top: int = 10) -> dict:
    """``reduce`` over the capture's events."""
    return reduce(prof.profiler.kineto_results.events(), t0_ns, t1_ns, main_thread, top)


def _annotation(e, host_names: set) -> bool:
    flagged = getattr(e, "is_user_annotation", None)
    return (e.name() in host_names or e.name().startswith(RANGE_PREFIX)
            or bool(flagged is not None and flagged()))


def reduce(events, t0_ns: int, t1_ns: int, main_thread: int | None = None,
           top: int = 10) -> dict:
    """{"busy_s", "window_s", "kernels": {name: seconds}, "counts": {name:
    launches}, "device_ops": [[name, s]] (top), "idle_gaps": [[name, s]]
    (top)} of the window [t0_ns, t1_ns], from the profiler's events."""
    on_device, host, host_names = [], [], set()
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            on_device.append(e)
            continue
        host_names.add(e.name())
        start, dur = e.start_ns(), e.duration_ns()
        if dur > 0 and (main_thread is None or e.start_thread_id() == main_thread):
            host.append((start, start + dur, e.name()))
    dev = []
    for e in on_device:
        start, dur = e.start_ns(), e.duration_ns()
        s, f = max(start, t0_ns), min(start + dur, t1_ns)
        if dur > 0 and f > s and not _annotation(e, host_names):
            dev.append((s, f, e.name()))
    kernels, counts = collections.Counter(), collections.Counter()
    for s, f, name in dev:
        kernels[name] += (f - s) * 1e-9
        counts[name] += 1
    # the union of device activity, and the gaps between its runs
    busy, gaps, end = 0, [], t0_ns
    for s, f, _ in sorted(dev):
        if s > end:
            gaps.append((end, s))
        if f > end:
            busy += f - max(s, end)
            end = f
    if t1_ns > end:
        gaps.append((end, t1_ns))
    return {"busy_s": busy * 1e-9, "window_s": (t1_ns - t0_ns) * 1e-9,
            "kernels": dict(kernels), "counts": dict(counts),
            "device_ops": [[n, s] for n, s in kernels.most_common(top)],
            "idle_gaps": [[n, s] for n, s in name_gaps(gaps, host).most_common(top)]}


def _innermost(events: list, starts: list, mid: int, reach: int) -> str | None:
    """The latest-starting of ``events`` (sorted by start) open at ``mid``,
    looking back over at most ``reach`` events: on one thread events nest,
    so that is the innermost one."""
    i = bisect.bisect_right(starts, mid)
    for j in range(i - 1, max(i - reach, 0) - 1, -1):
        if events[j][1] > mid:
            return events[j][2]
    return None


def name_gaps(gaps: list, host: list) -> collections.Counter:
    """Idle seconds summed by the innermost host event open at each gap's
    middle: among the nearest few thousand events, else among the ranges
    (the benchmark's own, which are few), else "host idle"."""
    host.sort()
    ranges = [h for h in host if h[2].startswith(RANGE_PREFIX)]
    starts, r_starts = [h[0] for h in host], [h[0] for h in ranges]
    out: collections.Counter = collections.Counter()
    for s, f in gaps:
        mid = (s + f) // 2
        name = (_innermost(host, starts, mid, 4096)
                or _innermost(ranges, r_starts, mid, len(ranges)) or "host idle")
        out[name] += (f - s) * 1e-9
    return out
