"""A configuration's entry found by name: a new entry, with its own call,
plain reference and numbers, runs and is judged with only new files added
to a copy of the tree; a number over its limit, or with no limit, is not
correct; the traced window is held to the kernels the entry expects.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from perfbench import correct, harness, trace

ROOT = Path(__file__).resolve().parents[2]
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH="")

STUB_FILES = {
    "perfbench/entries/stub_square.py": '''
        """A stub entry: twice its rows plus the traffic's bias."""

        import numpy as np

        from perfbench import reference_stub

        REFERENCE = "reference_stub"
        NUMBERS = ("y_gap",)
        CONTROLS = ()


        def call(inputs, pipeline, device, timer=None):
            return inputs["images"] * 2 + pipeline["bias"]


        def program_outputs(result):
            return {"y": result.double().numpy()}


        def reference_outputs(spec, inputs, device, *, control=None):
            return {"y": reference_stub.double(inputs["images"]).numpy()}


        def readings(prog, ref, limits):
            return {"y_gap": float(np.abs(prog["y"] - ref["y"]).max())}


        def shape(spec, result, labels):
            return {"objects": spec["data"]["objects"]}


        def expected_kernels(spec, calls):
            return {}
        ''',
    "perfbench/reference_stub.py": '''
        """The stub's plain reference."""


        def double(x):
            return 2 * x.double()
        ''',
    "perfbench/generators/stub_rows.py": '''
        """Rows of uniform numbers from the seed."""

        import numpy as np
        import torch


        def make(params, seed, device):
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            x = torch.rand((params["objects"], 4), generator=gen, device=device)
            return {"images": x, "labels": np.zeros(params["objects"], np.int64),
                    "mask": None, "groups": None}
        ''',
    "perfbench/configs/stub_square.json": json.dumps(
        {"generator": "stub_rows", "entry": "stub_square", "data": {"objects": 16},
         "pipeline": {"bias": 0.0}}),
    "perfbench/workloads/stub_square.json": json.dumps({"limits": {"y_gap": 0.0}}),
    "perfbench/workloads/stub_square_off.json": json.dumps(
        {"pipeline": {"bias": 0.5}, "limits": {"y_gap": 0.0}}),
    "perfbench/workloads/stub_square_no_limit.json": json.dumps({"limits": {}}),
}
STUB_CELLS = ("stub_square", "stub_square_off", "stub_square_no_limit")


@pytest.fixture(scope="module")
def stub_tree(tmp_path_factory):
    """A copy of the tree with the stub's files and entries added, and the
    program beside it."""
    tree = tmp_path_factory.mktemp("tree")
    shutil.copytree(ROOT / "perfbench", tree / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tree / "tpumcia_torch").symlink_to(ROOT / "tpumcia_torch")
    for rel, text in STUB_FILES.items():
        (tree / rel).write_text(textwrap.dedent(text).lstrip())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stub_square", "source": "https://example.org/stub",
                             "file": "perfbench/configs/stub_square.json", "reduced": [],
                             "why": "a stub"})
    bench["workloads"] += [{"name": c, "config": "stub_square", "traffic": c, "chips": 1,
                            "why": "a stub"} for c in STUB_CELLS]
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    return tree


def _python(tree, *argv):
    return subprocess.run([sys.executable, *argv], cwd=tree, capture_output=True, text=True,
                          timeout=300, env=ONE_THREAD)


def test_the_copy_edits_no_harness_file(stub_tree):
    for name in ("harness.py", "correct.py", "reference.py", "run.py", "trace.py"):
        assert (stub_tree / "perfbench" / name).read_bytes() == (ROOT / "perfbench" / name).read_bytes()
    assert not (ROOT / "perfbench" / "entries" / "stub_square.py").exists()


@pytest.mark.parametrize("cell,trace_on,ok", [("stub_square", 0, True), ("stub_square", 1, True),
                                              ("stub_square_off", 0, False),
                                              ("stub_square_no_limit", 0, False)])
def test_a_new_entry_is_run_and_judged(stub_tree, cell, trace_on, ok):
    """The stub's cells run through ``run.py`` from the copy: its call, its
    reference and its one number, the limit from its traffic file; an answer
    off by the traffic's bias, or a number with no limit, is not correct."""
    proc = _python(stub_tree, "perfbench/run.py", "--workload", cell, "--seed", "4294967311",
                   "--seconds", "0.2", "--trace", str(trace_on), "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is ok, line
    assert list(line["checks"]) == ["y_gap"]
    if cell == "stub_square_no_limit":
        assert line["checks"]["y_gap"] == {"value": 0.0, "limit": None}
    elif cell == "stub_square_off":
        assert line["checks"]["y_gap"] == {"value": pytest.approx(0.5, abs=1e-6), "limit": 0.0}


def test_no_expected_kernels_takes_the_first_profile(stub_tree):
    """An entry that expects no hand-written kernel gets its result from the
    first profile that recorded the device at all."""
    script = textwrap.dedent('''
        import argparse, json
        from perfbench import harness, trace

        tries = []

        def profile_calls(call, calls):
            tries.append(calls)
            result = [call() for _ in range(calls)][-1]
            return {"kernels": [("stub_kernel", 10.0, 20.0)], "window": (0.0, 100.0),
                    "calls": calls, "result": result}

        trace.profile_calls = profile_calls
        args = argparse.Namespace(workload="stub_square", seed=7, seconds=0.1, trace=1,
                                  device="cpu", objects=0)
        rc = harness.run(args, 0.0)
        print(json.dumps({"rc": rc, "tries": len(tries)}))
        ''')
    proc = _python(stub_tree, "-c", script)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"rc": 0, "tries": 1}
    line = json.loads(lines[-2])
    assert line["correct"] is True
    assert line["device"]["busy_s"] == pytest.approx(1e-5)


@pytest.mark.parametrize("whole", [True, False])
def test_a_profile_short_of_the_expected_kernels_is_retaken(whole, monkeypatch, capsys):
    """The pipeline entry expects one GLCM launch a batch each call: a whole
    profile is taken at once, one short of them retaken ``PROFILE_TRIES``
    times and then refused with no result."""
    spec = harness.load_cell("classic_8192_levels")
    want = harness.load_entry(spec).expected_kernels(spec, harness.TRACED_CALLS)
    assert want == {trace.GLCM_KERNEL: harness.TRACED_CALLS}
    tries = []

    def profile_calls(call, calls):
        tries.append(calls)
        result = [call() for _ in range(calls)][-1]
        glcm = [(f"{trace.GLCM_KERNEL}_level_bands_kernel", 10.0 * i, 10.0 * i + 5)
                for i in range(calls if whole else calls - 1)]
        return {"kernels": glcm + [("reduce_kernel", 50.0, 60.0)], "window": (0.0, 100.0),
                "calls": calls, "result": result}

    monkeypatch.setattr(trace, "profile_calls", profile_calls)
    args = argparse.Namespace(workload="classic_8192_levels", seed=2_300_000_017, seconds=0.1,
                              trace=1, device="cpu", objects=96)
    rc = harness.run(args, 0.0)
    out = capsys.readouterr().out.strip()
    if whole:
        assert rc == 0 and len(tries) == 1
        assert json.loads(out.splitlines()[-1])["metrics"]["launches_per_call"]["value"] == 1.5
    else:
        assert rc == 5 and len(tries) == harness.PROFILE_TRIES and out == ""


def test_kernel_counts_by_name():
    kernels = [("glcm_stats_kernel<false, false>", 0, 1), ("glcm_stats_level_bands_kernel", 2, 3),
               ("void at::native::reduce_kernel", 4, 5)]
    assert harness.kernel_counts(kernels, {"glcm_stats": 2}) == {"glcm_stats": 2}
    assert harness.kernel_counts([], {"glcm_stats": 2}) == {"glcm_stats": 0}
    assert harness.kernel_counts(kernels, {}) == {}


@pytest.mark.parametrize("numbers,limits,ok", [
    ({"a": 0, "b": 1e-7}, {"a": 0, "b": 1e-6}, True),
    ({"a": 1, "b": 1e-7}, {"a": 0, "b": 1e-6}, False),  # over its limit
    ({"a": 0, "b": 1e-7}, {"a": 0}, False),  # no limit
    ({"a": 0}, {"a": 0, "b": 1e-6}, False),  # no reading
    ({"a": 0, "b": float("inf")}, {"a": 0, "b": 1e-6}, False),  # shapes that differ
])
def test_judge(numbers, limits, ok):
    got, checks = correct.judge(numbers, limits, ("a", "b"))
    assert got is ok
    assert list(checks) == ["a", "b"]
    assert checks["b"]["limit"] == limits.get("b")


def test_judge_without_numbers_is_not_correct():
    assert correct.judge({}, {}, ())[0] is False
