"""The program's own spans and counters in a traced window: host seconds a
call inside each stage span, the card's idle seconds put down to the stage
span the host was in, runtime launches per Adam step and per sweep
evaluation, host syncs a call, and the longest idle gaps named by the host
spans open when they began.

    python3 perfbench/spans.py --workload <cell> --seed <n>

runs a cell as ``run.py --trace 1`` does (the same collection, warm-up
calls, ``harness.TRACED_CALLS`` calls in the profiled window, and a profile
short of the entry's ``expected_kernels`` retaken up to
``harness.PROFILE_TRIES`` times, then exit 5) on one card and prints one
JSON line of these readings; it judges nothing. The runner (:func:`main`,
:func:`profile_calls`) is a stopgap beside ``harness.run`` and
``trace.profile_calls`` until those pass the program's ranges and runtime
calls to the metrics: then it goes, and ``trace.py`` keeps the one kernel
filter. The readers below take plain lists, so a profile of another
program (one that opens none of these spans) reads None, never an error:

- ``kernels``: [(name, start_us, end_us)] of the device's kernels;
- ``ranges``: [(name, start_us, end_us)] of the program's spans (CPU
  ranges named as :data:`SPANS`), any thread;
- ``runtime``: [(name, start_us, end_us)] of the CUDA runtime calls named
  in :data:`LAUNCHES` and :data:`SYNCS`, any thread (the autograd engine
  launches a backward from a thread of its own).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time

ROOT_SPAN = "run_pipeline"
# the program's stage spans, named as utils.profiling.StageTimer's stages
STAGE_SPANS = ("inputs", "synth", "stats_kernel", "wire_features", "head_sweeps",
               "d2h_assembly", "finalize", "host_matrix_upload", "head", "importance")
SPANS = (ROOT_SPAN, *STAGE_SPANS, "adam", "sweep")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cudaGraphLaunch")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
WINDOW = "perfbench_window"  # trace.WINDOW


def from_events(events) -> dict:
    """``torch.profiler``'s events -> the kernels, the program's ranges and
    the runtime calls. A range's device-side annotation (a user annotation,
    or an event on the device named as a span or the window) is not a
    kernel; nor are copies and memsets."""
    from torch.autograd import DeviceType

    kernels, ranges, runtime = [], [], []
    for e in events:
        item = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if (e.name != WINDOW and e.name not in SPANS
                    and not getattr(e, "is_user_annotation", False)
                    and not e.name.startswith(("Memcpy", "Memset"))):
                kernels.append(item)
        elif e.name in SPANS:
            ranges.append(item)
        elif e.name in LAUNCHES or e.name in SYNCS:
            runtime.append(item)
    return {"kernels": kernels, "ranges": ranges, "runtime": runtime}


class Busy:
    """The union of the kernels' intervals, for the busy time inside any
    host interval."""

    def __init__(self, kernels):
        merged = []
        for s, e in sorted((s, e) for _, s, e in kernels):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.before = [0.0]  # busy time before each interval
        for s, e in merged:
            self.before.append(self.before[-1] + e - s)

    def _upto(self, t) -> float:
        i = bisect.bisect_right(self.starts, t)  # intervals starting at or before t
        if i == 0:
            return 0.0
        return self.before[i - 1] + min(t, self.ends[i - 1]) - self.starts[i - 1]

    def within(self, a, b) -> float:
        return self._upto(b) - self._upto(a)

    def gaps(self, a, b):
        """The idle stretches inside [a, b]: [(start, end)]."""
        out, t = [], a
        i = bisect.bisect_right(self.ends, a)
        while i < len(self.starts) and self.starts[i] < b:
            if self.starts[i] > t:
                out.append((t, self.starts[i]))
            t = max(t, self.ends[i])
            i += 1
        if t < b:
            out.append((t, b))
        return out


def _named(ranges, names):
    return [r for r in ranges if r[0] in names]


def _holds(outer, inner) -> bool:
    return outer is not inner and outer[1] <= inner[1] and inner[2] <= outer[2]


def span_s(ranges, name, calls) -> float | None:
    """Host seconds a call inside the spans called ``name``."""
    own = _named(ranges, (name,))
    return sum(e - s for _, s, e in own) / 1e6 / calls if own else None


def idle_s(kernels, ranges, calls) -> dict:
    """Seconds a call in which the card ran no kernel while each stage span
    was the host's innermost stage span: a span's idle time less its stage
    children's. Only stages inside a ``run_pipeline`` span count."""
    busy = Busy(kernels)
    roots = _named(ranges, (ROOT_SPAN,))
    stages = [r for r in _named(ranges, STAGE_SPANS) if any(_holds(p, r) for p in roots)]
    out: dict[str, float] = {}
    for r in stages:
        idle = (r[2] - r[1]) - busy.within(r[1], r[2])
        for c in stages:
            if _holds(r, c) and not any(_holds(r, m) and _holds(m, c) for m in stages):
                idle -= (c[2] - c[1]) - busy.within(c[1], c[2])
        out[r[0]] = out.get(r[0], 0.0) + idle / 1e6 / calls
    return out


def root_idle_s(kernels, ranges, calls) -> float | None:
    """Seconds a call in which the card ran no kernel inside the
    ``run_pipeline`` spans."""
    busy, roots = Busy(kernels), _named(ranges, (ROOT_SPAN,))
    if not roots:
        return None
    return sum((e - s) - busy.within(s, e) for _, s, e in roots) / 1e6 / calls


def _count_inside(runtime, names, spans) -> int:
    return sum(1 for n, s, _ in runtime if n in names and any(a <= s <= b for _, a, b in spans))


def launches_per_adam_step(runtime, ranges, adam_steps) -> float | None:
    """Runtime launch calls made inside ``adam`` spans over the Adam steps
    the program counted in the same calls."""
    adam = _named(ranges, ("adam",))
    if not adam or not adam_steps:
        return None
    return _count_inside(runtime, LAUNCHES, adam) / adam_steps


def launches_per_sweep_eval(runtime, ranges, sweep_evals) -> float | None:
    """Runtime launch calls made inside ``sweep`` spans over the head
    evaluations the program counted in the same sweeps: the sweeps' share
    of the head's launches, apart from the Adam steps'."""
    sweeps = _named(ranges, ("sweep",))
    if not sweeps or not sweep_evals:
        return None
    return _count_inside(runtime, LAUNCHES, sweeps) / sweep_evals


def syncs_per_call(runtime, ranges, calls) -> float | None:
    """Runtime calls that block the host on the card, inside ``run_pipeline``
    spans, a call."""
    roots = _named(ranges, (ROOT_SPAN,))
    return _count_inside(runtime, SYNCS, roots) / calls if roots else None


def by_call(runtime, ranges, names, inner=None) -> list[int]:
    """The runtime calls named ``names`` in each ``run_pipeline`` span, call
    by call (only those inside its ``inner`` spans, where given)."""
    out = []
    for root in _named(ranges, (ROOT_SPAN,)):
        own = [r for r in _named(ranges, (inner,)) if _holds(root, r)] if inner else [root]
        out.append(_count_inside(runtime, names, own))
    return out


def syncs_by_path(runtime, ranges, calls) -> dict:
    """Sync calls a call inside ``run_pipeline`` spans, by the path of the
    program's spans open when each was made."""
    roots, out = _named(ranges, (ROOT_SPAN,)), {}
    for n, s, _ in runtime:
        if n in SYNCS and any(a <= s <= b for _, a, b in roots):
            path = host_path(ranges, s)
            out[path] = out.get(path, 0) + 1 / calls
    return out


def host_path(ranges, t) -> str:
    """The program's spans open at ``t``, outermost first, joined by '/'."""
    open_ = sorted((r for r in ranges if r[1] <= t < r[2]), key=lambda r: (r[1], -r[2]))
    return "/".join(r[0] for r in open_) or "outside the program's spans"


def labelled_gaps(kernels, ranges, window, top=10) -> list:
    """The ``top`` longest idle gaps of the window, each [seconds, the host
    path when it began]."""
    gaps = sorted(Busy(kernels).gaps(*window), key=lambda g: g[0] - g[1])[:top]
    return [[(b - a) / 1e6, host_path(ranges, a)] for a, b in gaps]


def readings(host: dict, calls: int, window, adam_steps, sweep_evals=None) -> dict:
    """Every reading of one traced window."""
    k, r, rt = host["kernels"], host["ranges"], host["runtime"]
    idle = idle_s(k, r, calls)
    root_idle = root_idle_s(k, r, calls)
    seconds = {n: span_s(r, n, calls) for n in SPANS}
    return {
        "span_s": {n: v for n, v in seconds.items() if v is not None},
        "idle_s": idle,
        "root_idle_s": root_idle,
        "stage_idle_share_of_root": sum(idle.values()) / root_idle if root_idle else None,
        "launches_per_adam_step": launches_per_adam_step(rt, r, adam_steps),
        "launches_per_sweep_eval": launches_per_sweep_eval(rt, r, sweep_evals),
        "syncs_per_call": syncs_per_call(rt, r, calls),
        "syncs_by_call": by_call(rt, r, SYNCS),
        "adam_launches_by_call": by_call(rt, r, LAUNCHES, "adam"),
        "sweep_launches_by_call": by_call(rt, r, LAUNCHES, "sweep"),
        "syncs_by_path": syncs_by_path(rt, r, calls),
        "launches_per_call": len(k) / calls,
        "gaps": labelled_gaps(k, r, window),
    }


# ---- the run on a card ------------------------------------------------------

def _counters():
    """The program's counters, or None where it keeps none."""
    try:
        from tpumcia_torch.utils.profiling import COUNTERS
    except ImportError:
        return None
    return COUNTERS


def profile_calls(call, calls: int) -> dict:
    """``trace.profile_calls``'s window (one dropped call, then ``calls``
    calls inside one range), keeping the host's side as well, with what the
    program's counters counted inside it (None without counters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    counters = _counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        call()
        prof.step()
        before = dict(counters) if counters else None
        t0 = time.perf_counter()
        with record_function(WINDOW):
            for _ in range(calls):
                call()
        host_s = time.perf_counter() - t0
        counted = {k: counters[k] - before[k] for k in before} if counters else {}
    events = prof.events()
    window = next(e.time_range for e in events
                  if e.name == WINDOW and e.device_type == DeviceType.CPU)
    return {"host": from_events(events), "window": (window.start, window.end),
            "host_s": host_s, "adam_steps": counted.get("adam_steps"),
            "sweep_evals": counted.get("sweep_evals")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--untimed", type=int, default=8,
                    help="untimed calls before the window, for their median")
    args = ap.parse_args(argv)
    os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(1)
    from perfbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    spec = harness.load_cell(args.workload)
    entry = harness.load_entry(spec)
    device = torch.device("cuda", torch.cuda.current_device())
    inputs = harness.make_inputs(spec, args.seed, device)

    def call():
        out = entry.call(inputs, spec["pipeline"], device)
        torch.cuda.synchronize(device)
        return out

    for _ in range(harness.WARMUP_CALLS):
        call()
    untimed = []
    for _ in range(args.untimed):
        t0 = time.perf_counter()
        call()
        untimed.append(time.perf_counter() - t0)
    calls = harness.TRACED_CALLS
    want = entry.expected_kernels(spec, calls)
    for attempt in range(harness.PROFILE_TRIES):
        prof = profile_calls(call, calls)
        got = harness.kernel_counts(prof["host"]["kernels"], want)
        print(f"profile attempt {attempt}: launches {json.dumps(got)} of {json.dumps(want)}",
              file=sys.stderr)
        if got == want:
            break
    else:
        print(f"refused: every one of {harness.PROFILE_TRIES} profiles lacks kernels",
              file=sys.stderr)
        return 5
    line = readings(prof["host"], calls, prof["window"], prof["adam_steps"], prof["sweep_evals"])
    per_call = {k: (prof[k] / calls if prof[k] is not None else None)
                for k in ("adam_steps", "sweep_evals")}
    line.update(workload=args.workload, seed=args.seed, calls=calls,
                launches=got, profile_attempts=attempt + 1,
                adam_steps_per_call=per_call["adam_steps"],
                sweep_evals_per_call=per_call["sweep_evals"],
                traced_call_s=prof["host_s"] / calls,
                untimed_call_s=untimed, untimed_median_s=statistics.median(untimed),
                gpu=torch.cuda.get_device_name(device))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
