"""The readers of the program's spans (``perfbench/spans.py``) on hand-built
event lists: idle time put down to the innermost stage span, idle never past
its span, the stages' idle inside the root's, launches and syncs counted
only inside their spans, and no device-side annotation taken for a kernel.

    python -m pytest perfbench/tests -q
"""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench import spans

# one call, in microseconds: run_pipeline [0, 100]; the head stage [10, 60]
# with adam [12, 50] inside; importance [60, 95] with a sweep [62, 90];
# a stats_kernel stage [95, 100]; kernels busy [0, 10], [20, 30], [70, 75]
RANGES = [("run_pipeline", 0, 100), ("head", 10, 60), ("adam", 12, 50),
          ("importance", 60, 95), ("sweep", 62, 90), ("stats_kernel", 95, 100)]
KERNELS = [("k0", 0, 10), ("k1", 20, 30), ("k2", 70, 75)]


def test_busy_merges_and_cuts():
    busy = spans.Busy([("a", 0, 10), ("b", 5, 12), ("c", 20, 30)])
    assert busy.within(0, 100) == 22
    assert busy.within(8, 25) == 9  # 8..12 and 20..25
    assert busy.gaps(0, 40) == [(12, 20), (30, 40)]
    assert busy.gaps(6, 11) == []


def test_idle_goes_to_the_innermost_stage_span():
    """A stage inside a stage takes its own idle time; the outer stage keeps
    only the rest. adam and sweep are not stages: their idle stays with
    the stage around them."""
    ranges = RANGES + [("finalize", 40, 55)]  # a stage inside the head stage
    idle = spans.idle_s(KERNELS, ranges, calls=1)
    assert idle["finalize"] == pytest.approx(15e-6)
    assert idle["head"] == pytest.approx((50 - 10 - 15) * 1e-6)
    assert idle["importance"] == pytest.approx(30e-6)
    assert idle["stats_kernel"] == pytest.approx(5e-6)
    assert "adam" not in idle and "sweep" not in idle


def test_idle_never_exceeds_its_span():
    idle = spans.idle_s(KERNELS, RANGES, calls=2)
    for name, seconds in idle.items():
        assert 0 <= seconds <= spans.span_s(RANGES, name, calls=2)


def test_stage_idle_within_the_root_idle():
    stray = RANGES + [("head", 200, 260)]  # a stage span outside any call
    idle = spans.idle_s(KERNELS, stray, calls=1)
    root = spans.root_idle_s(KERNELS, stray, calls=1)
    assert root == pytest.approx(75e-6)
    assert sum(idle.values()) <= root + 1e-12
    assert idle["head"] == pytest.approx(40e-6)  # the stray span not counted


def test_launches_and_syncs_counted_only_inside_their_spans():
    runtime = [("cudaLaunchKernel", 13, 14), ("cudaLaunchKernel", 30, 31),
               ("cudaGraphLaunch", 49, 50), ("cudaLaunchKernel", 55, 56),  # after adam
               ("cudaLaunchKernel", 150, 151),  # outside the call
               ("cudaStreamSynchronize", 91, 92), ("cudaMemcpy", 96, 97),
               ("cudaStreamSynchronize", 120, 121),  # the harness's sync after the call
               ("cudaMemcpyAsync", 80, 81)]  # not a sync
    assert spans.launches_per_adam_step(runtime, RANGES, adam_steps=3) == pytest.approx(1.0)
    assert spans.syncs_per_call(runtime, RANGES, calls=1) == 2
    assert spans.syncs_by_path(runtime, RANGES, calls=1) == {
        "run_pipeline/importance": 1, "run_pipeline/stats_kernel": 1}


def test_sweep_launches_counted_over_the_sweep_evaluations():
    """Launches inside a ``sweep`` span, over the evaluations the program
    counted; the Adam loop's and the stage's own are not the sweep's."""
    runtime = [("cudaLaunchKernel", 13, 14),  # adam
               ("cudaLaunchKernel", 61, 62),  # importance, before the sweep
               ("cudaLaunchKernel", 63, 64), ("cuLaunchKernel", 70, 71),
               ("cudaLaunchKernelExC", 89, 90), ("cudaStreamSynchronize", 80, 81)]
    assert spans.launches_per_sweep_eval(runtime, RANGES, sweep_evals=6) == pytest.approx(0.5)
    assert spans.launches_per_sweep_eval(runtime, RANGES, sweep_evals=None) is None
    assert spans.launches_per_sweep_eval(runtime, [r for r in RANGES if r[0] != "sweep"], 6) is None


def test_counts_call_by_call():
    """Each call's own count, so two calls can be held equal."""
    second = [(n, s + 1000, e + 1000) for n, s, e in RANGES]
    runtime = [("cudaLaunchKernel", 13, 14), ("cudaLaunchKernel", 1013, 1014),
               ("cudaLaunchKernel", 1055, 1056), ("cudaStreamSynchronize", 1091, 1092)]
    assert spans.by_call(runtime, RANGES + second, spans.LAUNCHES, "adam") == [1, 1]
    assert spans.by_call(runtime, RANGES + second, spans.LAUNCHES) == [1, 2]
    assert spans.by_call(runtime, RANGES + second, spans.SYNCS) == [0, 1]


def test_a_program_without_spans_reads_nothing():
    assert spans.span_s([], "head", 1) is None
    assert spans.idle_s(KERNELS, [], 1) == {}
    assert spans.root_idle_s(KERNELS, [], 1) is None
    assert spans.launches_per_adam_step([("cudaLaunchKernel", 1, 2)], [], 300) is None
    assert spans.syncs_per_call([("cudaStreamSynchronize", 1, 2)], [], 1) is None
    assert spans.launches_per_adam_step([], RANGES, None) is None


def test_gaps_named_by_the_host_path_where_they_began():
    gaps = spans.labelled_gaps(KERNELS, RANGES, (0, 120), top=3)
    assert gaps == [[pytest.approx(45e-6), "run_pipeline/importance/sweep"],
                    [pytest.approx(40e-6), "run_pipeline/head/adam"],
                    [pytest.approx(10e-6), "run_pipeline/head"]]
    assert spans.host_path(RANGES, 110) == "outside the program's spans"


def _event(name, device, start, end, annotation=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("annotation", [False, True])
def test_device_annotations_never_enter_the_kernels(annotation):
    """A span's or the window's range seen on the device (flagged as a user
    annotation or not) is not a kernel; copies and memsets are not
    either."""
    events = [_event(n, DeviceType.CUDA, 0, 100, annotation) for n in spans.SPANS]
    events += [_event(spans.WINDOW, DeviceType.CUDA, 0, 100, annotation),
               _event("MemcpyDtoH", DeviceType.CUDA, 5, 6),
               _event("glcm_stats_kernel", DeviceType.CUDA, 1, 4),
               _event("head", DeviceType.CPU, 0, 50),
               _event("cudaLaunchKernel", DeviceType.CPU, 0, 1),
               _event("aten::mm", DeviceType.CPU, 2, 3)]
    got = spans.from_events(events)
    assert got["kernels"] == [("glcm_stats_kernel", 1, 4)]
    assert got["ranges"] == [("head", 0, 50)]
    assert got["runtime"] == [("cudaLaunchKernel", 0, 1)]


def test_readings_of_one_window():
    host = {"kernels": KERNELS, "ranges": RANGES,
            "runtime": [("cudaLaunchKernel", 13, 14), ("cudaStreamSynchronize", 91, 92)]}
    line = spans.readings(host, calls=1, window=(0, 100), adam_steps=1)
    assert line["span_s"]["head"] == pytest.approx(50e-6)
    assert line["stage_idle_share_of_root"] == pytest.approx((40 + 30 + 5) / 75)
    assert line["launches_per_adam_step"] == 1 and line["syncs_per_call"] == 1
    assert line["launches_per_call"] == 3
    assert line["launches_per_sweep_eval"] is None  # no sweep evaluations counted
