"""bench_torch.py, the port's bench, on the CPU: what it imports, its cells'
settings against bench.py's (read from bench.py's source, which imports
jax), its own byte and FLOP counts against the kernel wrapper's rule and
``FlopCounterMode``, its gates, the device timeline it reads from a
profile, and the bench run end to end with ``--device cpu`` at 96 objects
a cell (the plain versions; every device metric "not measured") and
without a card (``NoCUDADevice``).

The card's run is ``tests/test_torch_cuda.py::test_bench_torch_on_the_card``.
Counts are integers and must be equal; the timeline's are sums of a few
floats (``pytest.approx``).
"""

import ast
import copy
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench_torch as bt
from tpumcia_torch.features import cuda_glcm

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "flax", "optax", "tpumcia"}
TINY = 96  # objects a cell in the CPU rehearsal
# one torch thread in this worker and in the bench's processes: the suite
# runs several workers side by side
torch.set_num_threads(1)
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")


# ---- imports ----------------------------------------------------------------

def test_imports_no_jax():
    """Neither bench_torch.py's import statements nor a process that ran
    its MedNIST cell hold jax, flax, optax or tpumcia."""
    tree = ast.parse((ROOT / "bench_torch.py").read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not roots & BANNED, roots & BANNED
    code = (
        f"import sys; sys.path.insert(0, {str(ROOT)!r}); import bench_torch\n"
        f"bench_torch.main(['--device', 'cpu', '--n', '{TINY}', '--reps', '2', "
        "'--cell', 'mednist_fused_logistic'])\n"
        f"bad = {BANNED!r} & set(sys.modules)\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=240, cwd=ROOT,
                   capture_output=True, env=ONE_THREAD)


# ---- the MedNIST cell is bench.py's workload ----------------------------------

def _bench_py():
    """bench.py's module constants (an ``int(os.environ.get(name,
    default))`` read as its default) and the keywords of its
    ``PipelineConfig(...)`` and ``synthetic_mednist(...)`` calls, literals
    only (a nested config call becomes a dict of its literal keywords)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            value = node.value
            if isinstance(value, ast.Call) and getattr(value.func, "id", None) == "int":
                value = value.args[0].args[1]  # int(os.environ.get(name, default))
            try:
                consts[node.targets[0].id] = ast.literal_eval(value)
            except ValueError:
                pass
    calls = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) in ("PipelineConfig", "synthetic_mednist"):
            kws = {}
            for kw in node.keywords:
                if isinstance(kw.value, ast.Call):
                    kws[kw.arg] = {k.arg: ast.literal_eval(k.value) for k in kw.value.keywords}
                elif isinstance(kw.value, ast.Constant):
                    kws[kw.arg] = kw.value.value
            calls[node.func.id] = kws
    return consts, calls


@pytest.mark.parametrize("name,want", [
    ("N_IMAGES", 12_000), ("BATCH", 2_048), ("BASELINE_IMAGES_PER_SEC", 53.46)])
def test_constants_equal_bench_py(name, want):
    consts, _ = _bench_py()
    assert consts[name] == want == getattr(bt, name)


@pytest.mark.parametrize("section,field,want", [
    ("synth", "noise_channels", 2), ("synth", "seed", 0),
    ("head", "kind", "logistic"), ("head", "num_steps", 300),
    ("split", "test_size", 0.25), ("split", "seed", 0), ("split", "stratify", True),
    ("mesh", "data", 1), ("mesh", "model", 1),
])
def test_mednist_config_equals_bench_py(section, field, want):
    _, calls = _bench_py()
    cfg = bt.mednist_config()
    assert calls["PipelineConfig"][section][field] == want == getattr(getattr(cfg, section), field)


def test_mednist_workload_equals_bench_py():
    """fast_path and batch as bench.py sets them; the images are
    bench.py's ``synthetic_mednist`` call with its literal keywords."""
    from tpumcia_torch.io.synthetic import synthetic_mednist

    _, calls = _bench_py()
    cfg = bt.mednist_config()
    assert calls["PipelineConfig"]["fast_path"] == "always" == cfg.fast_path
    assert cfg.batch_size == bt.BATCH
    assert calls["synthetic_mednist"] == {"num_classes": 6, "seed": 0}
    gray, labels = bt.mednist_workload(TINY)
    want, want_labels, _ = synthetic_mednist(TINY // 6, **calls["synthetic_mednist"])
    np.testing.assert_array_equal(gray, want)
    np.testing.assert_array_equal(labels, want_labels)


# ---- counts from the shapes -------------------------------------------------

@pytest.mark.parametrize("shape,levels,offsets,mask_channels,need_diff", [
    ((2048, 3, 64, 64), 256, 1, 0, False),   # B1a, the MedNIST cell's full batch
    ((1760, 3, 64, 64), 256, 1, 0, False),   # its last batch, at its real size
    ((2048, 12, 48, 48), 256, 1, 1, False),  # B1b, the cytometry cell's batch
    ((2048, 3, 64, 64), 256, 4, 3, True),    # B2 with the difference histogram
    ((64, 12, 48, 48), 1024, 1, 1, True),    # B1d
    ((16, 1, 64, 64), 8192, 2, 0, True),     # B1e: no rescale table
])
def test_glcm_bytes_equal_the_wrappers_rule(shape, levels, offsets, mask_channels, need_diff):
    got = bt.glcm_launch_bytes(shape, levels, offsets, mask_channels=mask_channels, need_diff=need_diff)
    assert got == cuda_glcm.traffic_bytes(shape, levels, [(0, 5)] * offsets,
                                          mask_channels=mask_channels, need_diff=need_diff)


def test_glcm_bytes_at_the_main_paths_shapes():
    """PERF.md §6's bytes a launch, and a run's launches at their real
    batches: five of 2,048 and one of 1,760 MedNIST images, eight of 2,048
    cytometry objects."""
    b1a = bt.glcm_launch_bytes((2048, 3, 64, 64), 256, 1)
    b1b = bt.glcm_launch_bytes((2048, 12, 48, 48), 256, 1, mask_channels=1)
    assert (b1a, b1b) == (120_070_144, 308_051_968)
    last = cuda_glcm.traffic_bytes((1760, 3, 64, 64), 256, [(0, 5)])
    assert bt.glcm_run_bytes(12_000, 2048, 3, 64, masked=False) == 5 * b1a + last == 703_572_864
    assert bt.glcm_run_bytes(16_384, 2048, 12, 48, masked=True) == 8 * b1b == 2_464_415_744
    assert bt.launches_per_run(12_000, 2048) == 6 and bt.launches_per_run(16_384, 2048) == 8
    assert bt.launches_per_run(TINY, 2048) == 1


def test_head_flops_equal_the_flop_counter():
    """One full-batch Adam step of the port's logistic head, then the whole
    fused fit with both permutation sweeps, under ``FlopCounterMode``."""
    from tpumcia_torch.config import HeadConfig, ImportanceConfig
    from tpumcia_torch.models.fused import fit_logistic_with_importance
    from tpumcia_torch.models.heads import _fit_logistic

    rng = np.random.default_rng(0)
    n, F, K, C, steps, R = 90, 69, 6, 3, 4, 3
    X = torch.from_numpy(rng.random((n, F), dtype=np.float32))
    y = torch.nn.functional.one_hot(torch.from_numpy(rng.integers(0, K, n)), K).float()
    with FlopCounterMode(display=False) as one:
        _fit_logistic(X, y, torch.zeros(F, K), torch.zeros(K), num_steps=1, lr=0.05, l2=1e-4)
    assert one.get_total_flops() == bt.head_flops(n, F, K, 1)

    labels = np.arange(n) % K
    tr, te = np.arange(60), np.arange(60, n)
    with FlopCounterMode(display=False) as fit:
        fit_logistic_with_importance(
            X, labels, train_idx=tr, test_idx=te,
            groups=[list(range(c, F, C)) for c in range(C)], names=[f"f{i}" for i in range(F)],
            head_config=HeadConfig(kind="logistic", num_steps=steps),
            importance_config=ImportanceConfig(n_repeats=R))
    assert fit.get_total_flops() == bt.head_flops(len(tr), F, K, steps) + bt.sweep_flops(len(te), F, K, C, R)


def test_run_counts_add_up():
    c = bt.run_counts(n=12_000, batch=2048, channels=3, hw=64, masked=False, n_train=9000,
                      n_test=3000, classes=6, repeats=10)
    assert c["glcm_bytes"] == 703_572_864
    assert c["run_bytes"] == c["glcm_bytes"] + 2 * 4 * 12_000 * 69
    assert c["run_flops"] == c["head_flops"] + c["sweep_flops"] == (
        4 * 9000 * 69 * 6 * 300 + 2 * 3000 * 69 * 6 * ((3 + 69) * 10 + 3))


# ---- the gates ----------------------------------------------------------------

@pytest.fixture(scope="module")
def results():
    """One tiny CPU run of each cell's workload and config."""
    import tpumcia_torch as tt

    gray, labels = bt.mednist_workload(TINY)
    mednist = tt.run_pipeline(gray, labels, config=bt.mednist_config(), device="cpu")
    raw, mask, clabels, donors = bt.cytometry_objects(TINY)
    x = tt.quantize_to_levels(torch.from_numpy(raw), levels=bt.LEVELS, src_levels=65536)
    cyto = tt.run_pipeline(x, clabels, mask=mask, groups=donors, config=bt.cytometry_config(),
                           device="cpu")
    return mednist, cyto, donors


def _broken(result, what, signal):
    bad = copy.copy(result)
    if what == "channel":
        total = np.zeros_like(np.asarray(result.channel_result.total))
        total[(signal + 1) % len(total)] = 1.0
        bad.channel_result = dataclasses.replace(result.channel_result, total=total)
    elif what == "accuracy":
        bad.test_accuracy = 0.5
    elif what == "matrix":
        values = result.features.values.copy()
        values[3, 5] = np.nan
        bad.features = dataclasses.replace(result.features, values=values)
    elif what == "donors":  # a test object whose donor also trains
        bad.test_idx = np.concatenate([result.test_idx, result.train_idx[:1]])
    return bad


def test_gates_pass_the_tiny_runs(results):
    mednist, cyto, donors = results
    assert bt.mednist_failures(mednist, TINY) == []
    assert bt.cytometry_failures(cyto, TINY, donors) == []


@pytest.mark.parametrize("cell,what", [
    ("mednist", "channel"), ("mednist", "accuracy"), ("mednist", "matrix"),
    ("cytometry", "channel"), ("cytometry", "accuracy"), ("cytometry", "matrix"),
    ("cytometry", "donors"),
])
def test_gate_refuses(results, cell, what):
    mednist, cyto, donors = results
    if cell == "mednist":
        fails = bt.mednist_failures(_broken(mednist, what, 0), TINY)
    else:
        fails = bt.cytometry_failures(_broken(cyto, what, bt.CYTO_SIGNAL), TINY, donors)
    assert len(fails) == 1, fails


def test_gate_refuses_a_wrong_shape(results):
    mednist, _, _ = results
    assert bt.mednist_failures(mednist, TINY + 1)


def _counts(**got):
    return {f: got.get(f, 0) for f in cuda_glcm.LAUNCHES_BY_FORM}


@pytest.mark.parametrize("launches,ok", [
    ([_counts(B1a=6)] * 3, True),
    ([_counts(B1a=6), _counts(B1a=5)], False),   # a run one launch short
    ([_counts(B1b=6)], False),                   # another form
    ([_counts(B1a=6, B1c=1)], False),            # another form beside it
    ([], False),                                 # no run counted
])
def test_launch_gate(launches, ok):
    assert (bt.launch_failures(launches, "B1a", 6) == []) == ok


# ---- the device timeline ------------------------------------------------------

@pytest.mark.parametrize("kernels,window,busy,gaps", [
    # two overlapping kernels, one apart: gaps before, between, after
    ([("a", 10, 20), ("b", 15, 30), ("c", 50, 60)], (0, 100), 30,
     [(40, "c", "window end"), (20, "b", "c"), (10, "window start", "a")]),
    # a kernel inside another and one straddling the window's end
    ([("a", 0, 100), ("b", 10, 20), ("c", 90, 150)], (0, 120), 120, []),
    # kernels outside the window do not count
    ([("a", -50, -10), ("b", 40, 60), ("c", 200, 300)], (0, 100), 20,
     [(40, "window start", "b"), (40, "b", "window end")]),
])
def test_device_timeline(kernels, window, busy, gaps):
    got = bt.device_timeline(kernels, window)
    assert got["busy_us"] == pytest.approx(busy)
    assert got["idle_share"] == pytest.approx(1 - busy / (window[1] - window[0]))
    assert [(g["ms"] * 1e3, g["after"], g["before"]) for g in got["idle_gaps"]] == [
        (pytest.approx(ms), a, b) for ms, a, b in gaps]


# ---- the bench end to end -----------------------------------------------------

def _bench(*args, timeout=300):
    return subprocess.run([sys.executable, str(ROOT / "bench_torch.py"), *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout, env=ONE_THREAD)


@pytest.fixture(scope="module")
def cpu_lines():
    proc = _bench("--device", "cpu", "--n", str(TINY), "--reps", "2")
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(x) for x in proc.stdout.splitlines()]


def test_cpu_rehearsal_prints_both_lines(cpu_lines):
    assert [x["cell"] for x in cpu_lines] == list(bt.CELLS)
    for line in cpu_lines:
        assert line["correct"] and line["measured_on"] == "cpu" and line["objects"] == TINY
        assert bt.line_failures(line) == [], bt.line_failures(line)
        assert set(line["stages_s"]) == set(bt.STAGES)
        for key in ("device_ms_by_kernel", "longest_kernels", "idle_gaps", "gpu"):
            assert line[key] == bt.NOT_MEASURED
        assert line["profile_attempts"] == 0
        for key in bt.DEVICE_METRICS:
            assert line["metrics"][key]["value"] == bt.NOT_MEASURED
        throughput = line["metrics"][bt.CELLS[line["cell"]][1]]
        assert throughput["samples"] == 2 and "regression_bound" in throughput
    mednist = cpu_lines[0]
    assert mednist["metric"] == "feature_extraction_plus_channel_importance_throughput"
    assert mednist["unit"] == "images/sec" and mednist["value"] > 0
    assert mednist["vs_baseline"] == pytest.approx(mednist["value"] / 53.46)
    assert mednist["metrics"]["images_per_s_ingest"]["samples"] == 4


@pytest.mark.parametrize("key,value", [
    ("glcm_roofline_share", 0.08),   # a device metric with a value from the CPU
    ("median_s", float("nan")),
    ("runs_s", [0.1, None]),
    ("images_per_s", None),          # a line whose gates failed has no throughput
])
def test_line_check_refuses(cpu_lines, key, value):
    line = copy.deepcopy(cpu_lines[0])
    line["metrics"][key]["value"] = value
    assert bt.line_failures(line)


@pytest.mark.parametrize("share", [0.0, 1.2])
def test_line_check_refuses_a_share_outside_its_range(cpu_lines, share):
    line = copy.deepcopy(cpu_lines[1])
    line.update(measured_on="cuda", gpu="NVIDIA H100 80GB HBM3, 700.00 W")
    for key in bt.DEVICE_METRICS:
        line["metrics"][key]["value"] = 0.5
    assert bt.line_failures(line) == []
    line["metrics"]["run_mfu"]["value"] = share
    assert bt.line_failures(line)


def test_no_card_raises():
    """Without --device cpu the bench needs a card and does no work
    without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _bench("--n", str(TINY), "--reps", "2", timeout=120)
    assert proc.returncode != 0 and "NoCUDADevice" in proc.stderr
    assert not proc.stdout.strip()


@pytest.mark.parametrize("args", [["--reps", "1"], ["--cell", "cytometry"], ["--device", "cpu", "--reps", "x"]])
def test_bad_arguments(args):
    with pytest.raises(SystemExit) as e:
        bt.main(args)
    assert e.value.code == 2


def test_profile_run_warms_the_profiler_up():
    """The run is made twice under the profiler, the first time as its
    warm-up; with no device activity recorded (no card) there is no
    profile."""
    calls = []
    assert bt.profile_run(lambda: calls.append(torch.ones(4).sum())) is None
    assert len(calls) == 2
