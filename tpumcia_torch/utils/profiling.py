"""Profiling and throughput instrumentation (counterpart of
``tpumcia.utils.profiling``).

A :class:`StageTimer` handed to ``run_pipeline(timer=...)`` synchronises the
device at every stage boundary and adds the wall time since the previous
boundary to that stage's total. The synchronisations serialise host and
device, so a timed run is slower than an untimed one: use it for the split
between stages, and untimed runs for the throughput.

:func:`trace` names a region for ``torch.profiler`` (and for NVTX tools on a
CUDA build), :func:`capture_trace` records a Chrome trace of what runs
inside it, and :class:`ThroughputMeter` counts items per second per stage.

The program opens its own spans with :func:`trace`, at each layer boundary
of a ``run_pipeline`` call, so a profiled call splits on the profiler's
clock without being synchronised: ``run_pipeline`` (one a call), one span a
stage, named as the ``StageTimer`` stage (a stage's span exits where the
timer stamps it, see :func:`stage`), ``adam`` (the head's Adam fit),
``sweep`` (one permutation sweep), ``forest_level`` (one level of the
forest fit), ``forest_layout`` (a fitted forest laid out for inference) and
``forest_apply`` (one scoring of rows by the forest). :data:`COUNTERS`
counts the head's work where it is done: ``adam_steps`` (Adam steps, added
once a fit), ``adam_graph_steps`` (those of them run by replaying a
captured CUDA graph), ``sweep_evals`` (evaluations of the head in the
permutation sweeps, the baseline included), ``forest_levels`` (levels
grown, each chunk of trees counting its own), ``forest_fit_waits`` (the
host's blocking waits on the device in the forest fit: one a level, for the
level's records, counted on every device), ``forest_nodes`` (tree nodes
grown), ``forest_lanes`` ((tree, row) pairs the forest scored) and
``forest_kernel_launches`` (the walk kernel's launches: it scores every
pair on the card, none elsewhere); :func:`reset_counters` zeroes them.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

ROOT_SPAN = "run_pipeline"
COUNTERS = {"adam_steps": 0, "adam_graph_steps": 0, "sweep_evals": 0, "forest_levels": 0,
            "forest_fit_waits": 0, "forest_nodes": 0, "forest_lanes": 0, "forest_kernel_launches": 0}


def reset_counters() -> None:
    for k in COUNTERS:
        COUNTERS[k] = 0


class StageTimer:
    def __init__(self, device):
        self.device = torch.device(device)
        self.totals: dict[str, float] = {}
        self._last: float | None = None

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def start(self) -> None:
        self._last = self._now()

    def stamp(self, stage: str) -> None:
        """Close ``stage``: add the time since the previous stamp (or
        :meth:`start`) to its total."""
        now = self._now()
        if self._last is None:
            raise RuntimeError("StageTimer.stamp before start")
        self.totals[stage] = self.totals.get(stage, 0.0) + now - self._last
        self._last = now


@contextlib.contextmanager
def trace(name: str):
    """A named region: a ``torch.profiler.record_function`` range (it costs
    next to nothing while no profiler records) and, where CUDA is present,
    an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def stage(name: str, timer: StageTimer | None = None):
    """A stage of a ``run_pipeline`` call: a :func:`trace` span whose exit
    closes the stage ``name`` on ``timer`` (a started :class:`StageTimer`,
    or None)."""
    with trace(name):
        yield
        if timer is not None:
            timer.stamp(name)


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Record a ``torch.profiler`` trace (CPU activity, and CUDA activity
    where a CUDA device is present) of the enclosed code and write it as
    ``log_dir/trace.json``, a Chrome trace (``chrome://tracing``, Perfetto).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class ThroughputMeter:
    """Accumulates (items, seconds) per stage; reports items/sec (a copy of
    tpumcia's; the caller synchronises the device inside ``measure`` where
    the stage ends in device work)."""

    totals: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def measure(self, stage: str, items: int):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        n, t = self.totals.get(stage, (0, 0.0))
        self.totals[stage] = (n + items, t + dt)

    def rate(self, stage: str) -> float:
        n, t = self.totals.get(stage, (0, 0.0))
        return n / t if t > 0 else 0.0

    def report(self) -> dict:
        return {s: {"items": n, "seconds": t, "per_second": self.rate(s)}
                for s, (n, t) in self.totals.items()}
