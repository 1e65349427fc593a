"""The benchmark's files against its contract, on the CPU: ``BENCHMARK.json``'s
keys and names, each metric's cells, the files the harness finds by name,
the frozen counts against the program's own rules, and what the harness
imports and reads.

    python -m pytest perfbench/tests -q
"""

import ast
import json
import re
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
ENTRY_FUNCTIONS = ("call", "program_outputs", "reference_outputs", "readings", "shape",
                   "expected_kernels")
# cells of the pipeline entry, whose settings the tests below hold against the program
PIPELINE_CELLS = [c for c in CELLS if harness.load_cell(c)["entry"] == "pipeline"]
ENTRIES = sorted(p.stem for p in (ROOT / "perfbench" / "entries").glob("*.py"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "tpumcia"}


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", entry["unit"]), entry["unit"]
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = [e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_workloads_name_cells(kind):
    """Each metric's ``workloads`` lists cell names, never configurations."""
    for m in BENCH[kind]:
        for cell in m.get("workloads", []):
            assert cell in CELLS, (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.cell_metrics(BENCH, cell, "per_layer")
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = harness.load_cell(cell)
    assert spec["cell"]["chips"] == 1
    assert (harness.HERE / "generators" / f"{spec['generator']}.py").exists()
    for m in harness.cell_metrics(BENCH, cell, "per_layer"):
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
    assert (harness.HERE / "entries" / f"{spec['entry']}.py").exists(), spec["entry"]
    entry = harness.load_entry(spec)
    for name in ENTRY_FUNCTIONS:
        assert callable(getattr(entry, name)), name
    assert entry.NUMBERS and set(entry.NUMBERS) <= set(spec["traffic"]["limits"])
    if spec["entry"] == "pipeline":
        assert "glcm_need_diff" in spec["traffic"]


def test_a_configuration_without_an_entry_runs_the_pipeline():
    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config.get("entry", "pipeline") == harness.load_cell(
            next(w["name"] for w in BENCH["workloads"] if w["config"] == c["name"]))["entry"]
    assert harness.DEFAULT_ENTRY == "pipeline"


def test_configs_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("perfbench/") and (ROOT / f).exists()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", PIPELINE_CELLS)
def test_pipeline_settings_are_the_program_config(cell):
    """The configuration files state every setting the reference reads, and
    the program reads the same values from them."""
    import tpumcia_torch as tt

    spec = harness.load_cell(cell)
    cfg = tt.PipelineConfig.from_dict(spec["pipeline"]).to_dict()
    st = harness.load_entry(spec).settings(spec["pipeline"])
    assert cfg["features"]["glcm"]["levels"] == st["levels"]
    assert tuple(tt.GLCMConfig(**spec["pipeline"]["features"]["glcm"]).offsets[0]) == st["offset"]
    for key in ("split", "head", "importance", "synth"):
        for k, v in st[key].items():
            assert cfg[key][k] == v, (key, k)
    assert cfg["batch_size"] == st["batch_size"]


# ---- the frozen counts -----------------------------------------------------

@pytest.mark.parametrize("cell", PIPELINE_CELLS)
def test_glcm_bytes_equal_the_port_rule(cell):
    """The frozen byte rule equals the kernel wrapper's ``traffic_bytes`` at
    each of the cell's launch shapes."""
    from tpumcia_torch.features.cuda_glcm import traffic_bytes

    spec = harness.load_cell(cell)
    d, st = spec["data"], harness.load_entry(spec).settings(spec["pipeline"])
    channels = d.get("channels", 1 + st["synth"]["noise_channels"])
    n, batch = d["objects"], min(st["batch_size"], d["objects"])
    mask_channels, need_diff = d["mask_channels"], spec["traffic"]["glcm_need_diff"]
    want = sum(traffic_bytes((min(batch, n - s), channels, d["hw"], d["hw"]), st["levels"],
                             [st["offset"]], mask_channels=mask_channels, need_diff=need_diff)
               for s in range(0, n, batch))
    got = counts.glcm_call_bytes(n, batch, channels, d["hw"], st["levels"],
                                 mask_channels=mask_channels, need_diff=need_diff)
    assert got == want


def test_need_diff_follows_the_form():
    """Past 256 levels the classic path asks for the difference histogram."""
    for cell in PIPELINE_CELLS:
        spec = harness.load_cell(cell)
        st = harness.load_entry(spec).settings(spec["pipeline"])
        assert spec["traffic"]["glcm_need_diff"] == (st["levels"] > 256), cell


def test_head_flops_equal_flop_counter():
    """One Adam step of the port's logistic fit: ``FlopCounterMode`` counts
    exactly the frozen ``head_flops`` (X @ W and X^T @ dlogits)."""
    from tpumcia_torch.models.heads import _fit_logistic

    n, F, k = 64, 23, 3
    X, Y = torch.rand(n, F), torch.nn.functional.one_hot(torch.arange(n) % k, k).float()
    with FlopCounterMode(display=False) as fc:
        _fit_logistic(X, Y, torch.zeros(F, k), torch.zeros(k), num_steps=1, lr=0.05, l2=1e-4)
    assert fc.get_total_flops() == counts.head_flops(n, F, k, 1)


def test_sweep_flops_equal_flop_counter():
    """The port's sweeps on a logistic head: ``FlopCounterMode`` counts the
    frozen ``sweep_flops`` less the one prediction pass the pipeline makes
    outside them."""
    from tpumcia_torch.importance.permutation import _perm_sweep, _scaled_logistic_apply

    n, F, k, G, R = 40, 12, 3, 4, 2
    X = torch.rand(n, F)
    params = {"w": torch.rand(F, k), "b": torch.rand(k)}
    y = torch.arange(n) % k
    masks = torch.zeros(G, F)
    for g in range(G):
        masks[g, g * 3:(g + 1) * 3] = 1
    perms = torch.stack([torch.randperm(n) for _ in range(G * R)]).view(G, R, n)
    perms_f = torch.stack([torch.randperm(n) for _ in range(F * R)]).view(F, R, n)
    apply = lambda x: _scaled_logistic_apply(params, torch.zeros(F), torch.ones(F), x)  # noqa: E731
    with FlopCounterMode(display=False) as fc:
        _perm_sweep(X, y, masks, perms, apply)
        _perm_sweep(X, y, torch.eye(F), perms_f, apply)
        apply(X)
    assert fc.get_total_flops() == counts.sweep_flops(n, F, k, G, R)


# ---- what the harness imports and reads -------------------------------------

def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    return roots


def _literals(path: Path) -> list[str]:
    """The string constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in (ROOT / "perfbench").rglob("*.py")
                                        if "tests" not in p.parts))
def test_no_jax_or_jax_package(path):
    """No module of the harness imports jax, jaxlib, flax or tpumcia (top-level
    names compared whole, so tpumcia_torch is not tpumcia), nor the older
    benches, nor names their files."""
    roots = _imported_roots(ROOT / path)
    assert not roots & (FORBIDDEN | {"bench", "bench_torch", "benchmarks"}), roots
    for text in _literals(ROOT / path):
        for name in ("bench.py", "bench_torch", "benchmarks"):
            assert name not in text, (name, text)


@pytest.mark.parametrize("entry", ENTRIES)
def test_reference_imports_nothing_of_the_program(entry):
    """Each entry's plain reference, and the yardstick's own modules, import
    nothing of the program (nor of the harness, which does)."""
    ref = harness._module(ROOT / "perfbench" / "entries" / f"{entry}.py").REFERENCE
    for name in (f"{ref}.py", "correct.py", "counts.py"):
        roots = _imported_roots(ROOT / "perfbench" / name)
        assert "tpumcia_torch" not in roots, name
        tree = ast.parse((ROOT / "perfbench" / name).read_text())
        local = {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
                 and n.module == "perfbench" for a in n.names}
        assert local <= {"correct", "counts", ref}, (name, local)


def test_forbidden_names_are_whole(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "tpumcia_torch_probe", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.probe", sys)
    assert harness.forbidden_modules() == ["jaxlib"]
