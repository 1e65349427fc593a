"""The ``forest_mdi`` cell on the CPU at a small size (the kernels' plain
versions): rehearsed through ``run.py`` from a copy of the benchmark's
files beside the program, correct with all eight numbers read; faults
planted in the forest's outputs, and a sweep that skips its permutations
or its evaluations, read as not correct.

Card-only: ``test_forest_controls_on_the_card`` reads both controls at the
cell's own size (``-m cuda``; skipped without a card).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import correct, harness, readings

ROOT = Path(__file__).resolve().parents[2]
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH="")
CELL = "forest_mdi"
OBJECTS = 600
NUMBERS = ("split_rows", "features_gap", "tree_nodes", "proba_gap", "mdi_gap", "column_rows",
           "rank_swaps", "share_gap")
SPANS = {"stage_s.forest_fit", "stage_s.forest_sweep", "forest_fit_ms_per_level"}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A copy of the benchmark's files with the program beside it."""
    tree = tmp_path_factory.mktemp("tree")
    shutil.copy(ROOT / "BENCHMARK.json", tree)
    shutil.copytree(ROOT / "perfbench", tree / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tree / "tpumcia_torch").symlink_to(ROOT / "tpumcia_torch")
    return tree


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_is_correct(tree, trace):
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELL, "--seed", "4294967311",
         "--seconds", "0.2", "--trace", str(trace), "--device", "cpu", "--objects", str(OBJECTS)],
        cwd=tree, capture_output=True, text=True, timeout=900, env=ONE_THREAD)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert list(line["checks"]) == list(NUMBERS)
    assert all(c["value"] is not None for c in line["checks"].values())
    if trace:  # no device trace on the CPU: the program's spans alone
        assert set(line["metrics"]) == SPANS
        m = line["metrics"]
        assert m["forest_fit_ms_per_level"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"objects_per_s", "setup_s"}


@pytest.fixture(scope="module")
def judged():
    """One call at the rehearsal's size: the entry, the limits, the
    program's outputs and the reference's."""
    spec = harness.load_cell(CELL)
    spec["data"]["objects"] = OBJECTS
    entry = harness.load_entry(spec)
    device = torch.device("cpu")
    inputs = harness.make_inputs(spec, 2_300_000_017, device)
    prog = entry.program_outputs(entry.call(inputs, spec["pipeline"], device))
    ref = entry.reference_outputs(spec, inputs, device)
    return entry, spec["traffic"]["limits"], prog, ref, (spec, inputs, device)


def _nudge_threshold(prog, rows):
    t = prog["trees"][0]
    i = int(np.flatnonzero(t["feature"] >= 0)[0])
    t["threshold"] = t["threshold"].copy()
    t["threshold"][i] = np.nextafter(t["threshold"][i], np.inf)


def _shift(key, by):
    def shifted(prog, rows):
        prog[key] = prog[key].copy()
        prog[key].flat[0] += by(rows)
    return shifted


FAULTS = {
    "threshold_nudged": _nudge_threshold,
    "proba_off": _shift("proba", lambda rows: 1e-3),
    "mdi_off": _shift("mdi", lambda rows: 1e-9),
    "column_off": _shift("column", lambda rows: 2.0 / rows),
    "share_off": _shift("share", lambda rows: 1e-4),
}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_fault_in_the_outputs_is_not_correct(judged, fault):
    entry, limits, prog, ref, _ = judged
    prog = dict(prog, trees=[dict(t) for t in prog["trees"]])
    if fault:
        FAULTS[fault](prog, len(ref["test_idx"]) * ref["repeats"])
    ok, checks = correct.judge(entry.readings(prog, ref, limits), limits, entry.NUMBERS)
    assert ok is (fault is None), checks


def _unpermuted(sweep):
    """The program's sweep scoring every draw on the rows as they are."""
    def run(X, y_idx, masks, perms, apply_fn, **kw):
        same = torch.arange(perms.shape[-1], device=perms.device).expand(perms.shape)
        return sweep(X, y_idx, masks, same, apply_fn, **kw)
    return run


def _baseline_only(sweep):
    """The program's sweep that scores the baseline alone: every drop 0."""
    def run(X, y_idx, masks, perms, apply_fn, **kw):
        out = sweep(X, y_idx, masks, perms[:, :, :0][:0], apply_fn, **kw)
        G, R = perms.shape[:2]
        return tuple(v if v.ndim == 0 else v.new_zeros((G, R)) for v in out)
    return run


@pytest.mark.parametrize("fault", [_unpermuted, _baseline_only])
def test_a_sweep_fault_in_the_program_is_not_correct(judged, monkeypatch, fault):
    """A forest whose every vote holds reads each accuracy drop 0, so only
    ``share_gap`` can see the sweep: it reads a sweep that skips its
    permutations, or its evaluations, as not correct."""
    from tpumcia_torch.importance import permutation

    entry, limits, _, ref, (spec, inputs, device) = judged
    monkeypatch.setattr(permutation, "_perm_sweep", fault(permutation._perm_sweep))
    prog = entry.program_outputs(entry.call(inputs, spec["pipeline"], device))
    ok, checks = correct.judge(entry.readings(prog, ref, limits), limits, entry.NUMBERS)
    assert not ok and checks["share_gap"]["value"] > limits["share_gap"], checks


@pytest.mark.cuda
def test_forest_controls_on_the_card():
    """The program correct, and each control (split sums in float32, class
    shares in bfloat16) not correct, on three seeds at the cell's own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    spec = harness.load_cell(CELL)
    limits, names = spec["traffic"]["limits"], harness.load_entry(spec).NUMBERS
    for i in range(3):
        program, *controls = readings.seed_readings(spec, 2_400_000_000 + i, torch.device("cuda"),
                                                    control=True)
        assert correct.judge(program, limits, names)[0], program
        assert len(controls) == 2
        for control in controls:
            assert not correct.judge(control, limits, names)[0], control
