"""The port's own spans and counters (``tpumcia_torch.utils.profiling``),
read from ``torch.profiler``'s CPU events of ``run_pipeline`` calls on the
CPU at a tiny size, on the fused path and on the classic path.

Each call is one ``run_pipeline`` span; inside it the stage spans, named as
``StageTimer``'s stages and in their order (the fused path's first four once
a batch); ``adam`` inside the head's stage and ``sweep`` inside the stage
that runs the sweeps. ``COUNTERS`` counts the head's Adam steps (none of
them replayed from a CUDA graph on the CPU) and the sweeps' evaluations a
call. No span synchronises the device. A forest head's classic call stamps
the classic stages and adds the spans ``forest_level`` and
``forest_layout`` (inside ``head``) and ``forest_apply``, and counters of
the levels and nodes grown and the (tree, row) pairs scored. This file
imports no jax.
"""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpumcia_torch.io.synthetic import synthetic_mednist
from tpumcia_torch.models import forest_fit
from tpumcia_torch.pipeline.run import run_pipeline
from tpumcia_torch.utils import profiling

N_PER_CLASS = 30  # 180 images, 6 classes
BATCH = 64  # three fused batches, the last wrap-padded
STEPS = 12
REPEATS = 2
CHANNELS, FEATURES = 3, 69  # the grayscale image and 2 noise channels
CALLS = 2
# StageTimer's stages of each path, in the order a call runs them
TIMER_STAGES = {
    "fast": ["inputs", "synth", "stats_kernel", "wire_features", "head_sweeps", "d2h_assembly"],
    "classic": ["synth", "inputs", "stats_kernel", "finalize", "host_matrix_upload", "head",
                "importance"],
}
PER_BATCH = {"inputs", "synth", "stats_kernel", "wire_features"}
HEAD_STAGE = {"fast": "head_sweeps", "classic": "head"}
SWEEP_STAGE = {"fast": "head_sweeps", "classic": "importance"}
SPANS = {profiling.ROOT_SPAN, "adam", "sweep"} | {s for v in TIMER_STAGES.values() for s in v}


def _config(path):
    return {
        "head": {"kind": "logistic", "num_steps": STEPS},
        "importance": {"n_repeats": REPEATS},
        "split": {"test_size": 0.25, "seed": 0, "stratify": True},
        "synth": {"noise_channels": 2, "seed": 0},
        "fast_path": "always" if path == "fast" else "never",
        "batch_size": BATCH,
    }


@pytest.fixture(scope="module")
def gray():
    images, labels, _ = synthetic_mednist(N_PER_CLASS, num_classes=6, seed=3)
    return images, labels


def _call(gray, path, timer=None):
    images, labels = gray
    return run_pipeline(images, labels, config=_config(path), device="cpu", timer=timer)


@pytest.fixture(scope="module")
def traced(gray):
    """Per path: the program's spans of ``CALLS`` profiled calls, as
    (name, start_us, end_us) by start, and the counters of each call."""
    out = {}
    for path in TIMER_STAGES:
        _call(gray, path)  # warm
        counters = []
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(CALLS):
                profiling.reset_counters()
                _call(gray, path)
                counters.append(dict(profiling.COUNTERS))
        spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                        if e.device_type == DeviceType.CPU and e.name in SPANS),
                       key=lambda s: (s[1], -s[2]))
        out[path] = {"spans": spans, "counters": counters}
    return out


def _parent(spans, span):
    """The innermost other span that holds ``span``."""
    name, s, e = span
    holders = [h for h in spans if h is not span and h[1] <= s and e <= h[2]]
    return max(holders, key=lambda h: h[1], default=None)


def _calls(spans):
    """The spans of each call, the root's own first."""
    roots = [s for s in spans if s[0] == profiling.ROOT_SPAN]
    return [[s for s in spans if r[1] <= s[1] and s[2] <= r[2]] for r in roots]


def _n_batches(path):
    return -(-6 * N_PER_CLASS // BATCH) if path == "fast" else 1


@pytest.mark.parametrize("path", sorted(TIMER_STAGES))
def test_every_span_once_a_call_or_a_batch(traced, path):
    calls = _calls(traced[path]["spans"])
    assert len(calls) == CALLS
    for call in calls:
        names = [s[0] for s in call]
        want = {profiling.ROOT_SPAN: 1, "adam": 1, "sweep": 2}
        for st in TIMER_STAGES[path]:
            want[st] = _n_batches(path) if path == "fast" and st in PER_BATCH else 1
        assert {n: names.count(n) for n in set(names)} == want


@pytest.mark.parametrize("path", sorted(TIMER_STAGES))
def test_each_span_sits_under_its_parent(traced, path):
    spans = traced[path]["spans"]
    want = {"adam": HEAD_STAGE[path], "sweep": SWEEP_STAGE[path]}
    for span in spans:
        parent = _parent(spans, span)
        if span[0] == profiling.ROOT_SPAN:
            assert parent is None
        else:
            assert parent[0] == want.get(span[0], profiling.ROOT_SPAN), (span, parent)


@pytest.mark.parametrize("path", sorted(TIMER_STAGES))
def test_stage_spans_in_the_timer_order(traced, path):
    stages = TIMER_STAGES[path]
    want = (stages[:4] * _n_batches(path) + stages[4:]) if path == "fast" else stages
    for call in _calls(traced[path]["spans"]):
        assert [s[0] for s in call if s[0] in stages] == want


@pytest.mark.parametrize("path", sorted(TIMER_STAGES))
def test_stage_timer_keys_unchanged(gray, path):
    """A timed call gives the same stages, in the same order, as before the
    spans, each with a time."""
    timer = profiling.StageTimer("cpu")
    _call(gray, path, timer)
    assert list(timer.totals) == TIMER_STAGES[path]
    assert all(t > 0 for t in timer.totals.values())


@pytest.mark.parametrize("path", sorted(TIMER_STAGES))
def test_adam_steps_a_call_are_the_head_steps(traced, path):
    assert [c["adam_steps"] for c in traced[path]["counters"]] == [STEPS] * CALLS


@pytest.mark.parametrize("path", sorted(TIMER_STAGES))
def test_a_cpu_fit_replays_no_graph(traced, path):
    """On the CPU every Adam step runs eagerly: no step is a graph replay."""
    assert [c["adam_graph_steps"] for c in traced[path]["counters"]] == [0] * CALLS


@pytest.mark.parametrize("path", sorted(TIMER_STAGES))
def test_sweep_evals_a_call_follow_the_configuration(traced, path):
    """The channel sweep and the per-feature sweep: each permuted copy
    (groups x repeats) and the baseline, the same on every call."""
    want = (CHANNELS * REPEATS + 1) + (FEATURES * REPEATS + 1)
    assert [c["sweep_evals"] for c in traced[path]["counters"]] == [want] * CALLS


def test_reset_counters_zeroes_every_counter():
    profiling.COUNTERS["adam_steps"] += 3
    profiling.COUNTERS["forest_lanes"] += 5
    profiling.reset_counters()
    assert profiling.COUNTERS == {"adam_steps": 0, "adam_graph_steps": 0, "sweep_evals": 0,
                                  "forest_levels": 0, "forest_fit_waits": 0, "forest_nodes": 0,
                                  "forest_lanes": 0, "forest_kernel_launches": 0}


@pytest.mark.parametrize("timed", [False, True])
@pytest.mark.parametrize("path", sorted(TIMER_STAGES))
def test_spans_never_synchronise(gray, path, timed, monkeypatch):
    """``torch.cuda.synchronize`` is never called by an untimed call; a
    timer on a CUDA device calls it at its start and every stamp (which shows
    the patch sees the calls)."""
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: seen.append(device))
    timer = profiling.StageTimer("cuda") if timed else None
    _call(gray, path, timer)
    if timed:
        stamps = _n_batches(path) * 4 + 2 if path == "fast" else len(TIMER_STAGES[path])
        assert len(seen) == stamps + 1
    else:
        assert seen == []


def test_stage_closes_its_timer_at_exit():
    timer = profiling.StageTimer("cpu")
    timer.start()
    with profiling.stage("inputs", timer):
        assert timer.totals == {}
    with profiling.stage("inputs", None):
        pass
    assert list(timer.totals) == ["inputs"]
    with pytest.raises(RuntimeError), profiling.stage("head", timer):
        raise RuntimeError("no stamp on the way out of an error")
    assert list(timer.totals) == ["inputs"]



# ---- the forest head on the classic path ------------------------------------

FOREST_TREES = 4
FOREST_STAGES = TIMER_STAGES["classic"]
FOREST_SPANS = set(FOREST_STAGES) | {"forest_level", "forest_layout", "forest_apply", "sweep"}


def _forest_call(gray, timer=None):
    images, labels = gray
    config = {**_config("classic"),
              "head": {"kind": "random_forest", "n_estimators": FOREST_TREES, "seed": 0},
              "importance": {"n_repeats": REPEATS, "channel_method": "permutation_features"}}
    return run_pipeline(images, labels, config=config, device="cpu", timer=timer)


@pytest.fixture(scope="module")
def forest_traced(gray):
    """One profiled forest call: its spans (name, start_us, end_us) by start,
    its counters and its result."""
    _forest_call(gray)  # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiling.reset_counters()
        result = _forest_call(gray)
        counters = dict(profiling.COUNTERS)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.device_type == DeviceType.CPU and e.name in FOREST_SPANS),
                   key=lambda s: (s[1], -s[2]))
    return {"spans": spans, "counters": counters, "result": result}


def test_a_forest_call_stamps_its_stages(gray):
    """The classic stages, as a logistic classic call stamps them."""
    timer = profiling.StageTimer("cpu")
    _forest_call(gray, timer)
    assert list(timer.totals) == FOREST_STAGES
    assert all(t > 0 for t in timer.totals.values())


def test_forest_counters_follow_its_trees(forest_traced):
    """Levels: each chunk of trees its deepest tree's depth + 1; nodes: the
    trees' nodes; lanes: the trees times the rows scored (the test rows'
    prediction, the sweep's baseline and each column's repeats)."""
    res = forest_traced["result"]
    trees = res.head.trees
    n_train, n_test = len(res.train_idx), len(res.test_idx)
    per = max(1, forest_fit.CHUNK_ELEMS // (FEATURES * n_train))
    levels = sum(max(t.max_depth for t in trees[i:i + per]) + 1 for i in range(0, len(trees), per))
    c = forest_traced["counters"]
    assert c["forest_levels"] == levels > 1
    assert c["forest_nodes"] == sum(t.node_count for t in trees)
    assert c["forest_lanes"] == FOREST_TREES * n_test * (2 + FEATURES * REPEATS)
    # the walk kernel runs on the card only
    assert c["forest_kernel_launches"] == 0
    assert c["sweep_evals"] == FEATURES * REPEATS + 1 and c["adam_steps"] == 0


def test_a_forest_call_waits_once_a_level(forest_traced):
    """The fit inside a forest ``run_pipeline`` call reads the device back
    once a level."""
    c = forest_traced["counters"]
    assert c["forest_fit_waits"] == c["forest_levels"] > 1


def test_forest_spans_sit_under_their_stages(forest_traced):
    spans = forest_traced["spans"]
    names = [s[0] for s in spans]
    assert names.count("forest_level") == forest_traced["counters"]["forest_levels"]
    assert names.count("forest_layout") == 1
    want = {"forest_level": "head", "forest_layout": "head", "sweep": "importance"}
    for span in spans:
        if span[0] in want:
            assert _parent(spans, span)[0] == want[span[0]], span
    applies = [_parent(spans, s)[0] for s in spans if s[0] == "forest_apply"]
    assert applies[0] == "head" and set(applies[1:]) == {"sweep"}
