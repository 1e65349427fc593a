"""One run of one cell: the data-driven part of ``run.py``.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is a file found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json``: the collection's generator (``generators/<name>.py``)
  and its parameters, the program's settings (``pipeline``), and the entry
  that runs them (``entry``, ``entries/<entry>.py``; ``pipeline`` where the
  key is left out);
- ``entries/<entry>.py``: one call of the program's public entry (``call``),
  what the judged call produced (``program_outputs``), the same worked out by
  the entry's plain reference (``reference_outputs``, the module named by
  ``REFERENCE``, with the ``CONTROLS`` it can compute one precision step
  down), the numbers that decide ``correct`` (``NUMBERS``, ``readings``), the
  shapes the metric readers count from (``shape``) and the hand-written
  kernels a whole traced window launches (``expected_kernels``);
- ``workloads/<traffic>.json``: what the cell changes of those (``objects``,
  ``levels`` and ``pipeline`` settings, merged over the configuration's)
  and the limits of the entry's numbers;
- ``metrics/<metric>.py``: ``read(ctx)`` returns the metric's number from the
  traced run, or None where it finds nothing to read.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from perfbench import correct, trace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpumcia")  # top-level module names
WARMUP_CALLS = 2  # calls before the window; the first builds and warms every shape
TRACED_CALLS = 2  # calls in the traced window
PROFILE_TRIES = 5  # profiles taken before a run with kernels missing gives up
DEFAULT_ENTRY = "pipeline"  # the entry of a configuration that names none


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its configuration and
    traffic files merged: ``data`` (the generator's parameters), ``pipeline``
    (the program's settings), ``entry`` (its module's name) and the rest of
    the traffic file."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "workloads" / f"{cell['traffic']}.json").read_text())
    data = {**config["data"], **{k: traffic[k] for k in ("objects", "levels") if k in traffic}}
    pipeline = _merge(config["pipeline"], traffic.get("pipeline", {}))
    return {"bench": bench, "cell": cell, "generator": config["generator"], "data": data,
            "pipeline": pipeline, "entry": config.get("entry", DEFAULT_ENTRY), "traffic": traffic}


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def load_entry(spec: dict):
    """The module of the cell's entry, ``entries/<entry>.py``."""
    return _module(HERE / "entries" / f"{spec['entry']}.py")


def kernel_counts(kernels, want: dict) -> dict:
    """Launches among ``kernels`` of each name substring in ``want``."""
    return {k: sum(k in name for name, _, _ in kernels) for k in want}


def make_inputs(spec: dict, seed: int, device) -> dict:
    """The cell's collection from its generator, made on ``device``."""
    return _module(HERE / "generators" / f"{spec['generator']}.py").make(spec["data"], seed, device)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(args, t_start: float) -> int:
    from tpumcia_torch.utils.profiling import StageTimer

    spec = load_cell(args.workload)
    entry = load_entry(spec)
    marks = {"imports": time.perf_counter() - t_start}
    on_card = args.device == "cuda"
    device = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    if args.objects:
        spec["data"]["objects"] = args.objects
    inputs = make_inputs(spec, args.seed, device)
    marks["inputs"] = time.perf_counter() - t_start

    def call(timer=None):
        out = entry.call(inputs, spec["pipeline"], device, timer)
        if on_card:
            torch.cuda.synchronize(device)
        return out

    first = StageTimer(device)  # where the first call's one-time work lies
    for i in range(WARMUP_CALLS):
        call(first if i == 0 else None)
        marks[f"warm-up call {i + 1}"] = time.perf_counter() - t_start
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    print(f"set-up (s since start): {json.dumps(marks)}; the first call's stages (s): "
          f"{json.dumps(first.totals)}", file=sys.stderr)
    n = spec["data"]["objects"]
    metrics, extra = {}, {}
    if not args.trace:
        times, t0 = [], time.perf_counter()
        while True:
            c0 = time.perf_counter()
            result = call()
            times.append(time.perf_counter() - c0)
            if time.perf_counter() - t0 >= args.seconds:
                break
        window_s = time.perf_counter() - t0
        calls = len(times)
        peak = torch.cuda.max_memory_allocated(device) if on_card else None
        print(f"calls (s): {json.dumps(times)}", file=sys.stderr)
        values = {"objects_per_s": n * calls / window_s, "peak_device_bytes": peak, "setup_s": setup_s}
        for m in cell_metrics(spec["bench"], args.workload, "end_to_end"):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        calls = TRACED_CALLS
        prof = None
        want = entry.expected_kernels(spec, calls)
        for attempt in range(PROFILE_TRIES):
            prof = trace.profile_calls(call, calls)
            if prof is None:
                break
            got = kernel_counts(prof["kernels"], want)
            print(f"profile attempt {attempt}: launches {json.dumps(got)} of {json.dumps(want)}",
                  file=sys.stderr)
            if got == want:
                break
        else:
            # the profiler dropped kernels in every try: a share or count read
            # from such a profile would be wrong, so the run gives no result
            print(f"refused: every one of {PROFILE_TRIES} profiles lacks kernels", file=sys.stderr)
            return 5
        if prof is None:  # no device activity recorded (the CPU rehearsal)
            prof = {"kernels": [], "window": None, "calls": calls, "result": call()}
        result = prof["result"]
        peak = torch.cuda.max_memory_allocated(device) if on_card else None
        timer = StageTimer(device)
        call(timer)
        tl = trace.timeline(prof["kernels"], prof["window"]) if prof["kernels"] else None
        ctx = {"kernels": prof["kernels"], "calls": calls, "timeline": tl, "stages": timer.totals,
               "shape": entry.shape(spec, result, inputs["labels"]),
               "tf32": torch.backends.cuda.matmul.allow_tf32}
        for m in cell_metrics(spec["bench"], args.workload, "per_layer"):
            value = _module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tl:
            extra["busy_s"], extra["window_s"] = tl["busy_s"], tl["window_s"]
            extra["breakdown"] = trace.breakdown(prof["kernels"], tl)
        print(f"stages (s): {json.dumps(timer.totals)}", file=sys.stderr)
        del prof

    # the judged call's outputs, then the program's state freed before the
    # reference runs
    prog = entry.program_outputs(result)
    del result
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = entry.reference_outputs(spec, inputs, device)
    print(f"reference (s): {time.perf_counter() - t_ref!r}", file=sys.stderr)
    limits = spec["traffic"].get("limits", {})
    ok, checks = correct.judge(entry.readings(prog, ref, limits), limits, entry.NUMBERS)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)

    found = forbidden_modules()
    if found:
        print(f"refused: the process holds {found}", file=sys.stderr)
        return 4
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if args.trace:
        dev.update(busy_s=extra.get("busy_s"), window_s=extra.get("window_s"))
    line = {"correct": ok, "attempted": calls, "failed": 0, "metrics": metrics, "device": dev}
    if "breakdown" in extra:
        line["breakdown"] = extra["breakdown"]
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0
