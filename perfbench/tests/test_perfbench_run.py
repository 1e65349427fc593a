"""The benchmark run end to end on the CPU at a tiny size (the kernels'
plain versions), the command without a card, and the comparison that
decides ``correct``: the control (the reference one precision step down)
and the faults the cells can have, planted under the timed path, must come
out as not correct.

Card-only: ``test_control_on_the_card`` reads the control at a cell's own
size (``-m cuda``; skipped without a card).
"""

import argparse
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
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")
TINY = {"mednist_fused_logistic": 240, "classic_8192_levels": 96}
torch.set_num_threads(1)


def _args(cell, *, trace=0, seed=2_300_000_017):
    return argparse.Namespace(workload=cell, seed=seed, seconds=0.5, trace=trace, device="cpu",
                              objects=TINY[cell])


def _last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,trace", [("mednist_fused_logistic", 1), ("classic_8192_levels", 0),
                                        ("classic_8192_levels", 1)])
def test_rehearsal_reaches_the_last_line(cell, trace, capsys):
    assert harness.run(_args(cell, trace=trace), 0.0) == 0
    line = _last_line(capsys)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "cpu" and line["device"]["memory_peak_bytes"] is None
    if trace:  # no device trace on the CPU: only the stage spans read
        spans = {m["name"] for m in harness.cell_metrics(harness.load_cell(cell)["bench"], cell, "per_layer")
                 if m["source"] == "program_span"}
        assert spans and set(line["metrics"]) == spans
    else:  # no peak without a card
        assert set(line["metrics"]) == {"objects_per_s", "setup_s"}


def test_command_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "mednist_fused_logistic",
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300, env=ONE_THREAD)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_alone_in_a_directory_prints_no_result(tmp_path):
    """A checkout of the benchmark's files alone has no program to run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(ONE_THREAD, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "mednist_fused_logistic",
                           "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu",
                           "--objects", "12"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell):
    """The control (features in bfloat16, head in TF32) against the
    reference fails the cell's limits. (TF32 acts on the card alone: the
    head-only control reads as float32 here.)"""
    spec = harness.load_cell(cell)
    spec["data"]["objects"] = TINY[cell]
    lines = readings.seed_readings(spec, 2_300_000_101, torch.device("cpu"), control=True)
    limits, names = spec["traffic"]["limits"], harness.load_entry(spec).NUMBERS
    program, control, _ = lines
    assert correct.judge(program, limits, names)[0], program
    assert not correct.judge(control, limits, names)[0], control


# ---- faults planted under the timed path -----------------------------------

def _unchanged(x, y, w0, b0, **kw):
    """A fit that returns its state unchanged."""
    return {"w": w0.clone(), "b": b0.clone()}


def _half_batch(fit):
    def fitted(x, y, w0, b0, **kw):
        """Half of the rows left out; the mean taken over the rest."""
        h = len(x) // 2
        return fit(x[:h], y[:h], w0, b0, **kw)
    return fitted


def _altered_answer(assemble):
    def assembled(*a, **kw):
        """One feature of one object altered where the matrix is assembled."""
        done = assemble(*a, **kw)
        values = np.array(done.values, copy=True)
        values[0, 0] += 0.5
        return done._replace(values=values)
    return assembled


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_fault_is_not_correct(cell, fault, monkeypatch, capsys):
    """Each fault the cells can have, planted in the program, turns
    ``correct`` false (the exchange between chips does not exist on one
    card)."""
    from tpumcia_torch.features import hybrid
    from tpumcia_torch.models import fused, heads

    if fault == "state_unchanged":
        monkeypatch.setattr(fused, "_fit_logistic", _unchanged)
        monkeypatch.setattr(heads, "_fit_logistic", _unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(fused, "_fit_logistic", _half_batch(heads._fit_logistic))
        monkeypatch.setattr(heads, "_fit_logistic", _half_batch(heads._fit_logistic))
    else:
        monkeypatch.setattr(hybrid, "assemble_reduced", _altered_answer(hybrid.assemble_reduced))
    assert harness.run(_args(cell), 0.0) == 0
    line = _last_line(capsys)
    assert line["correct"] is False, line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_on_the_card(cell):
    """The controls at the cell's own size on the card, on three seeds: the
    bf16 control and the TF32-head control not correct on each, and the
    program correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    spec = harness.load_cell(cell)
    limits, names = spec["traffic"]["limits"], harness.load_entry(spec).NUMBERS
    for i in range(3):
        program, control, tf32_head = readings.seed_readings(
            spec, 2_400_000_000 + i, torch.device("cuda"), control=True)
        assert correct.judge(program, limits, names)[0], program
        assert not correct.judge(control, limits, names)[0], control
        assert not correct.judge(tf32_head, limits, names)[0], tf32_head
