"""The traced window: a few whole calls under ``torch.profiler``, reduced in
memory to the device's kernels and the window's ends (nothing is exported),
and from them the busy time, the idle gaps and the breakdown.

The window opens after one call under the profiler whose events are
dropped (kernels launched in the first milliseconds of a trace can go
unrecorded), and holds ``calls`` calls, each ending in a device
synchronise, inside one ``record_function`` range.
"""

from __future__ import annotations

import time

WINDOW = "perfbench_window"
GLCM_KERNEL = "glcm_stats"  # the substring of the GLCM statistics kernels' names


def profile_calls(call, calls: int) -> dict | None:
    """Runs ``call`` ``calls + 1`` times under the profiler. Returns the
    kernels ([(name, start_us, end_us)]), the window (start_us, end_us), the
    host's seconds and the last call's result; None where the profiler
    recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        call()
        prof.step()
        t0 = time.perf_counter()
        with record_function(WINDOW):
            for _ in range(calls):
                result = call()
        seconds = time.perf_counter() - t0
    events = prof.events()
    window = next((e.time_range for e in events
                   if e.name == WINDOW and e.device_type == DeviceType.CPU), None)
    kernels = [(e.name, e.time_range.start, e.time_range.end) for e in events
               if e.device_type == DeviceType.CUDA and e.name != WINDOW
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("Memcpy", "Memset"))]
    if window is None or not kernels:
        return None
    return {"kernels": kernels, "window": (window.start, window.end), "host_s": seconds,
            "calls": calls, "result": result}


def timeline(kernels, window) -> dict:
    """The device's busy seconds inside the window (the union of the
    kernels' intervals) and every idle stretch of it, longest first, each
    named by the kernels around it."""
    lo, hi = window
    spans = sorted((max(s, lo), min(e, hi), name) for name, s, e in kernels if e > lo and s < hi)
    busy, gaps, end, last = 0.0, [], lo, "window start"
    for s, e, name in spans:
        if s > end:
            gaps.append((s - end, last, name))
        if e > end:
            busy += e - max(s, end)
            end, last = e, name
    if hi > end:
        gaps.append((hi - end, last, "window end"))
    gaps.sort(key=lambda g: -g[0])
    return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
            "gaps": [(f"after {a[:56]} before {b[:56]}", g / 1e6) for g, a, b in gaps]}


def breakdown(kernels, tl: dict, top: int = 10) -> dict:
    """The device operations that took most time (seconds summed by name)
    and the longest idle gaps."""
    by_name: dict[str, float] = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [list(g) for g in tl["gaps"][:top]]}
