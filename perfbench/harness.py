"""One run of one cell: the data-driven part of ``run.py``.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is a file found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json``: the collection's generator (``generators/<name>.py``)
  and its parameters, and the pipeline settings as ``PipelineConfig.from_dict``
  reads them;
- ``workloads/<traffic>.json``: what the cell changes of those (``objects``,
  ``levels`` and ``pipeline`` settings, merged over the configuration's)
  and the limits of ``correct.py``'s numbers;
- ``metrics/<metric>.py``: ``read(ctx)`` returns the metric's number from the
  traced run, or None where it finds nothing to read.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import correct, reference, trace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpumcia")  # top-level module names
WARMUP_CALLS = 2  # calls before the window; the first builds and warms every shape
TRACED_CALLS = 2  # calls in the traced window
PROFILE_TRIES = 5  # profiles taken before a run with kernels missing gives up


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its configuration and
    traffic files merged: ``data`` (the generator's parameters), ``pipeline``
    (the ``PipelineConfig`` dict) and the rest of the traffic file."""
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
            "pipeline": pipeline, "traffic": traffic}


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def reference_settings(pipeline: dict) -> dict:
    """What the reference takes of the configuration, as its files state it
    (every key the reference reads is written out there)."""
    glcm = pipeline["features"]["glcm"]
    angle, dist = glcm["angle"], glcm["distance"]
    return {
        "levels": glcm["levels"],
        "offset": (int(round(math.sin(angle) * dist)), int(round(math.cos(angle) * dist))),
        "split": pipeline["split"], "head": pipeline["head"],
        "importance": pipeline["importance"], "synth": pipeline["synth"],
        "batch_size": pipeline["batch_size"],
    }


def program_outputs(result) -> dict:
    """What the judged call produced, in the reference's terms: the host
    feature matrix, the split, the head's class probabilities on the test
    rows (its scaler and weights applied to the matrix it was fitted on) and
    both sweeps' mean drops."""
    fm = result.features
    X = fm.device_values
    if X is None:
        X = torch.from_numpy(np.nan_to_num(np.asarray(fm.values, dtype=np.float32)))
    te = torch.as_tensor(result.test_idx)
    with torch.no_grad():
        proba = result.head.predict_proba(X[te.to(X.device)])
    return {
        "features": np.asarray(fm.values, dtype=np.float64),
        "train_idx": np.asarray(result.train_idx), "test_idx": np.asarray(result.test_idx),
        "proba": proba.double().cpu().numpy(),
        "channel": np.asarray(result.channel_result.total, dtype=np.float64),
        "column": np.asarray(result.feature_result.feature_importances, dtype=np.float64),
    }


def reference_outputs(spec: dict, inputs: dict, device, *, control=None) -> dict:
    """The plain reference over the same inputs (``control``: as
    ``reference.analyze`` takes it)."""
    st = reference_settings(spec["pipeline"])
    images = inputs["images"]
    if st["synth"]["noise_channels"] > 0:
        levels = reference.noise_stack(images, num_noise=st["synth"]["noise_channels"],
                                       var=st["synth"]["var"], seed=st["synth"]["seed"],
                                       batch=st["batch_size"])
    else:
        levels = images.permute(0, 3, 1, 2)
    return reference.analyze(levels, inputs["mask"], inputs["labels"], inputs["groups"],
                             pipeline=st, control=control)


def shape_of(spec: dict, result, labels) -> dict:
    """The cell's shapes, for the frozen counts."""
    d, p = spec["data"], reference_settings(spec["pipeline"])
    channels = d.get("channels", 1 + p["synth"]["noise_channels"])
    feats = 23 * channels
    return {
        "objects": d["objects"], "batch": p["batch_size"], "channels": channels, "hw": d["hw"],
        "levels": p["levels"], "mask_channels": d["mask_channels"],
        "need_diff": spec["traffic"]["glcm_need_diff"], "features": feats,
        "n_train": len(result.train_idx), "n_test": len(result.test_idx),
        "classes": len(np.unique(labels[result.train_idx])),
        "repeats": p["importance"]["n_repeats"], "steps": p["head"]["num_steps"],
        "head_kind": p["head"]["kind"],
    }


def make_inputs(spec: dict, seed: int, device) -> dict:
    """The cell's collection from its generator, made on ``device``."""
    return _module(HERE / "generators" / f"{spec['generator']}.py").make(spec["data"], seed, device)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(args, t_start: float) -> int:
    import tpumcia_torch as tt
    from tpumcia_torch.utils.profiling import StageTimer

    marks = {"imports": time.perf_counter() - t_start}
    spec = load_cell(args.workload)
    on_card = args.device == "cuda"
    device = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    if args.objects:
        spec["data"]["objects"] = args.objects
    inputs = make_inputs(spec, args.seed, device)
    marks["inputs"] = time.perf_counter() - t_start
    cfg = tt.PipelineConfig.from_dict(spec["pipeline"])
    kw = {} if on_card else {"device": "cpu"}

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def call(timer=None):
        out = tt.run_pipeline(inputs["images"], inputs["labels"], mask=inputs["mask"],
                              groups=inputs["groups"], config=cfg, timer=timer, **kw)
        sync()
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
        want = calls * -(-n // min(cfg.batch_size, n))
        for attempt in range(PROFILE_TRIES):
            prof = trace.profile_calls(call, calls)
            if prof is None:
                break
            glcm = sum(trace.GLCM_KERNEL in k[0] for k in prof["kernels"])
            print(f"profile attempt {attempt}: {glcm} GLCM launches of {want}", file=sys.stderr)
            if glcm == want:
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
               "shape": shape_of(spec, result, inputs["labels"]), "tf32": torch.backends.cuda.matmul.allow_tf32}
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
    prog = program_outputs(result)
    del result
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_outputs(spec, inputs, device)
    print(f"reference (s): {time.perf_counter() - t_ref!r}", file=sys.stderr)
    limits = spec["traffic"]["limits"]
    ok, checks = correct.judge(correct.readings(prog, ref, limits), limits)
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
