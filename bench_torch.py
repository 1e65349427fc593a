"""The port's bench: tpumcia_torch's main path on one NVIDIA GPU, in two cells.

    python3 bench_torch.py [--cell {mednist_fused_logistic,cytometry_masked_12ch,all}]
                           [--seed 0] [--reps 8] [--device cuda|cpu] [--n N]

The counterpart of ``bench.py``, which measures tpumcia on the TPU. Each
cell times tpumcia's own public call, ``run_pipeline(images, labels,
config=cfg)`` (the card is the port's default device), and prints one JSON
line. The cells:

- ``mednist_fused_logistic`` (configuration ``mednist64_gray_2noise_logistic``):
  ``bench.py``'s workload unchanged: 12,000 ``synthetic_mednist`` 64x64
  grayscale images, 6 classes, 2 noise channels synthesized on the card,
  69 features at 256 levels and offset (0, 5), a 300-step logistic head,
  batch 2048, ``fast_path="always"``: 6 launches of kernel form B1a a run;
- ``cytometry_masked_12ch`` (``cytometry48_12ch_uint16_donors``): BASELINE
  config 4 at full width: 16,384 seeded 48x48x12 uint16 objects with cell
  masks, quantized on the card to 256 levels, a donor-grouped split, the
  same head and batch: 8 launches of form B1b a run.

What a cell measures, in order: the kernels' build and a warm-up run
(untimed; the warm-up also keeps the GLCM kernel's inputs); ``--reps``
timed runs, each ending in ``torch.cuda.synchronize()``, with the inputs on
the card (median, quartiles, every run; MedNIST also ``max(4, reps // 2)``
runs from the host, the upload timed, as ``bench.py``'s ingest-inclusive
scope, spread among the others); one run split into
stages by ``utils.profiling.StageTimer``; one run under ``torch.profiler``
(the device time of each kernel by name, the idle share of the run's
window, the longest kernels and idle gaps); the GLCM wrapper alone on the
kept inputs (CUDA events); the bytes and FLOPs the run must move and do,
counted from the shapes by this file's own rule, and from them the GLCM
kernel's roofline share and the whole run's share of its least time; the
peak device memory; the correctness gates.

``--cell all`` runs each cell in a process of its own. A run that fails a
gate has no throughput: its line says ``"correct": false`` with the
reasons, and the bench exits 1. Without a CUDA device the
bench raises ``NoCUDADevice``; ``--device cpu`` runs the plain versions at
a small size (``--n``) for a rehearsal, and there every device metric reads
"not measured".
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import tpumcia_torch as tt
from tpumcia_torch import _build
from tpumcia_torch.config import MeshConfig
from tpumcia_torch.features import cuda_glcm
from tpumcia_torch.io.synthetic import synthetic_mednist
from tpumcia_torch.utils.device import require_device
from tpumcia_torch.utils.profiling import StageTimer

BASELINE_IMAGES_PER_SEC = 53.46  # the reference notebook on one CPU core (bench.py)
N_IMAGES = 12_000
BATCH = 2_048
HEAD_STEPS = 300
LEVELS = 256
FEATURES_PER_CHANNEL = 23
CYTO_N, CYTO_HW, CYTO_CH, CYTO_SIGNAL = 16_384, 48, 12, 4
MEDNIST_ACCURACY, CYTOMETRY_ACCURACY = 0.90, 0.95
KERNEL_REPS = 20  # the GLCM wrapper's CUDA-event timings a kept launch (their median)
MAX_SHARE = 1.05  # a roofline share above this is a counting error
PROFILE_ATTEMPTS = 3

# an H100 SXM at 700 W (NVIDIA's data sheet): device memory, float32 outside
# the tensor cores, TF32 on them
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12

# How far each end-to-end metric's median may fall below the parent's, as
# a fraction of the parent's, before a change counts as a regression: twice
# the largest fall (1 - smallest / largest) between the medians of three
# `--cell all` runs in one call on an NVIDIA H100 80GB HBM3 at 700 W, and
# at least 5 % (PERF.md §2 has the runs).
REGRESSION_BOUNDS = {"images_per_s": 0.3861, "images_per_s_ingest": 0.4166, "objects_per_s": 0.4574}
# each cell's configuration and throughput metric
CELLS = {
    "mednist_fused_logistic": ("mednist64_gray_2noise_logistic", "images_per_s"),
    "cytometry_masked_12ch": ("cytometry48_12ch_uint16_donors", "objects_per_s"),
}
GLCM_KERNEL = "glcm_stats"  # the substring of the kernel forms' names
STAGES = ("inputs", "synth", "stats_kernel", "wire_features", "head_sweeps", "d2h_assembly")
NOT_MEASURED = "not measured"
# every line's metrics; the MedNIST line adds images_per_s_ingest
METRICS = (
    "throughput", "median_s", "q1_s", "q3_s", "runs_s", "build_s", "warmup_s",
    "peak_device_bytes", "glcm_launches", "glcm_bytes", "glcm_bound_ms", "glcm_ms",
    "glcm_events_ms", "glcm_roofline_share", "run_bytes", "run_flops", "head_flops",
    "sweep_flops", "run_bound_ms", "run_bound_by", "run_mfu", "idle_share",
    "profiled_run_s",
)
DEVICE_METRICS = (
    "peak_device_bytes", "glcm_ms", "glcm_events_ms", "glcm_roofline_share", "run_mfu",
    "idle_share", "profiled_run_s",
)


# ---- workloads ------------------------------------------------------------

def mednist_workload(n: int = N_IMAGES, seed: int = 0):
    """bench.py's images: (n, 64, 64) uint8 grayscale and their labels."""
    gray, labels, _ = synthetic_mednist(max(n // 6, 1), num_classes=6, seed=seed)
    return gray[:n], labels[:n]


def mednist_config(batch: int = BATCH) -> tt.PipelineConfig:
    """bench.py's PipelineConfig (the mesh pinned to one device, as there)."""
    return tt.PipelineConfig(
        mesh=MeshConfig(data=1, model=1),
        synth=tt.SynthConfig(noise_channels=2, seed=0),
        head=tt.HeadConfig(kind="logistic", num_steps=HEAD_STEPS),
        split=tt.SplitConfig(test_size=0.25, seed=0, stratify=True),
        fast_path="always",
        batch_size=batch,
    )


def cytometry_objects(n, hw=CYTO_HW, channels=CYTO_CH, signal_ch=CYTO_SIGNAL, seed=0):
    """Imaging-flow-cytometry-like objects (BASELINE config 4), shaped like
    examples/cytometry_h5.py: uint16 (n, hw, hw, channels) with background
    U[200, 1500), a cell disk of radius U(10, 16)*hw/48 centred in
    [0.35, 0.65]*hw, signal on ``signal_ch`` only (activated:
    exp(-r/(8*hw/48))*38000, resting: disk*6000). Returns (images, shared
    disk mask, labels (i // 8) % 2 with 0 = activated, donors
    "donor{i % 8}"): every donor holds both classes."""
    rng = np.random.default_rng(seed)
    scale = hw / 48.0
    img = rng.integers(200, 1500, size=(n, hw, hw, channels)).astype(np.uint16)
    cy, cx = rng.uniform(hw * 0.35, hw * 0.65, size=(2, n, 1, 1))
    yy, xx = np.mgrid[:hw, :hw]
    r = np.hypot(yy[None] - cy, xx[None] - cx)
    cell = r < rng.uniform(10, 16, size=(n, 1, 1)) * scale
    labels = (np.arange(n) // 8) % 2
    boost = np.where(
        labels[:, None, None] == 0, np.exp(-r / (8 * scale)) * 38000, cell * 6000.0
    ).astype(np.uint16)
    img[..., signal_ch] = np.clip(
        img[..., signal_ch].astype(np.int64) + boost, 0, 65535
    ).astype(np.uint16)
    donors = np.array([f"donor{i % 8}" for i in range(n)])
    return img, cell, labels, donors


def cytometry_config(batch: int = BATCH) -> tt.PipelineConfig:
    return tt.PipelineConfig(
        mesh=MeshConfig(data=1, model=1),
        head=tt.HeadConfig(kind="logistic", num_steps=HEAD_STEPS),
        split=tt.SplitConfig(test_size=0.25, seed=0, group_by="donor"),
        fast_path="always",
        batch_size=batch,
    )


# ---- gates ----------------------------------------------------------------

def launches_per_run(n: int, batch: int) -> int:
    return math.ceil(n / min(batch, n))


def launch_failures(launches: list[dict], form: str, per_run: int) -> list[str]:
    """Each run's launches by form (``cuda_glcm.LAUNCHES_BY_FORM``) must be
    ``per_run`` of ``form`` and none of any other."""
    want = {f: (per_run if f == form else 0) for f in cuda_glcm.LAUNCHES_BY_FORM}
    bad = [i for i, got in enumerate(launches) if got != want]
    if not launches or bad:
        got = launches[bad[0]] if launches else "nothing"
        return [f"run {bad[0] if bad else 0} launched {got}, want {per_run} {form} and no other form"]
    return []


def _matrix_failures(result, n: int, columns: int) -> list[str]:
    X = result.features.values
    if X.shape != (n, columns) or not np.isfinite(X).all():
        return [f"feature matrix {X.shape} is not finite at ({n}, {columns})"]
    return []


def signal_first(result) -> bool:
    """Channel 0 first by the channel sweep and by the summed per-feature
    importances (bench.py's ranking check)."""
    by_feature = [result.feature_result.feature_importances[cols].sum()
                  for cols in result.features.channel_columns()]
    return int(np.argmax(result.channel_result.total)) == 0 and int(np.argmax(by_feature)) == 0


def mednist_failures(result, n: int) -> list[str]:
    """bench.py's gates and PERF.md §2's: the accuracy, channel 0 first,
    the feature matrix finite at (n, 69)."""
    fails = _matrix_failures(result, n, 3 * FEATURES_PER_CHANNEL)
    if not result.test_accuracy >= MEDNIST_ACCURACY:
        fails.append(f"test accuracy {result.test_accuracy} < {MEDNIST_ACCURACY}")
    if not signal_first(result):
        fails.append(f"channel 0 not first: {np.asarray(result.channel_result.total).tolist()}")
    return fails


def cytometry_failures(result, n: int, donors) -> list[str]:
    """The accuracy, the signal channel first, disjoint train and test
    donors, the feature matrix finite at (n, 276)."""
    fails = _matrix_failures(result, n, CYTO_CH * FEATURES_PER_CHANNEL)
    if not result.test_accuracy >= CYTOMETRY_ACCURACY:
        fails.append(f"test accuracy {result.test_accuracy} < {CYTOMETRY_ACCURACY}")
    total = np.asarray(result.channel_result.total)
    if int(np.argmax(total)) != CYTO_SIGNAL or not total[CYTO_SIGNAL] > 0:
        fails.append(f"channel {CYTO_SIGNAL} not first: {total.tolist()}")
    train = {str(d) for d in donors[result.train_idx]}
    test = {str(d) for d in donors[result.test_idx]}
    if train & test or not test:
        fails.append(f"donor split leaks: train {sorted(train)}, test {sorted(test)}")
    return fails


# ---- counts from the shapes -----------------------------------------------

def glcm_launch_bytes(shape, levels: int, num_offsets: int, *, mask_channels: int = 0,
                      need_diff: bool = False) -> int:
    """The bytes one GLCM statistics launch must move, each input read once
    and each output written once: the int32 levels, the (B, mask_channels,
    H, W) uint8 mask and one rescale-table row of L int32 per (image,
    channel) up to L rows (none past 4096 levels) in; the histogram, count
    and vmax, and per offset both marginals, the difference histogram (2L-1
    bins) or dstats (4 words), 4 limbs and the pair count out, 4 bytes each.
    The bench's own copy of the rule, so that a change to the kernel or its
    wrapper cannot move the yardstick."""
    B, C, H, W = shape
    n = B * C
    table = 0 if levels > 4096 else 4 * levels * min(n, levels)
    read = 4 * n * H * W + B * mask_channels * H * W + table
    written = 4 * n * (levels + 2)
    per_offset = 4 * n * (2 * levels + (2 * levels - 1 if need_diff else 4) + 4 + 1)
    return read + written + num_offsets * per_offset


def glcm_run_bytes(n: int, batch: int, channels: int, hw: int, *, masked: bool) -> int:
    """Over a run's launches, each at its real batch (the last one holds
    what is left: 1,760 of the 12,000 MedNIST images; the wrapper pads it)."""
    b = min(batch, n)
    return sum(glcm_launch_bytes((min(b, n - s), channels, hw, hw), LEVELS, 1,
                                 mask_channels=int(masked))
               for s in range(0, n, b))


def head_flops(n_train: int, features: int, classes: int, steps: int) -> int:
    """The logistic head's matrix products: per full-batch Adam step the
    logits X @ W and the weight gradient X^T @ dlogits, 2 n F K each (the
    features take no gradient)."""
    return 4 * n_train * features * classes * steps


def sweep_flops(n_test: int, features: int, classes: int, groups: int, repeats: int) -> int:
    """Both permutation sweeps: one forward pass (2 n F K) over the test rows
    per (group, repeat) and per (feature, repeat), two baselines and the
    test predictions."""
    return 2 * n_test * features * classes * ((groups + features) * repeats + 3)


def run_counts(*, n, batch, channels, hw, masked, n_train, n_test, classes, repeats) -> dict:
    """What one run must move and compute, from its shapes: the GLCM
    launches' bytes, the feature matrix written once and read once by the
    head and the sweeps, and the head's and sweeps' FLOPs."""
    F = channels * FEATURES_PER_CHANNEL
    glcm = glcm_run_bytes(n, batch, channels, hw, masked=masked)
    head = head_flops(n_train, F, classes, HEAD_STEPS)
    sweeps = sweep_flops(n_test, F, classes, channels, repeats)
    return {"glcm_bytes": glcm, "run_bytes": glcm + 2 * 4 * n * F,
            "head_flops": head, "sweep_flops": sweeps, "run_flops": head + sweeps}


def flops_per_s() -> tuple[float, str]:
    """The peak of the head's dtype: float32 unless TF32 is on."""
    if torch.backends.cuda.matmul.allow_tf32:
        return TF32_FLOPS_PER_S, "tf32"
    return FP32_FLOPS_PER_S, "float32"


# ---- the device timeline --------------------------------------------------

def device_timeline(kernels, window) -> dict:
    """``kernels``: (name, start_us, end_us) of each kernel on the device;
    ``window``: (start_us, end_us) of the run. The idle share is 1 minus the
    union of the kernels' intervals inside the window over its length; the
    gaps are the stretches of the window no kernel covers, each between the
    kernel that ended last before it and the one that starts it."""
    lo, hi = window
    spans = sorted((max(s, lo), min(e, hi), name) for name, s, e in kernels if e > lo and s < hi)
    busy, gaps, end, last = 0.0, [], lo, "window start"
    for s, e, name in spans:
        if s > end:
            gaps.append((s - end, last, name, end - lo))
        if e > end:
            busy += e - max(s, end)
            end, last = e, name
    if hi > end:
        gaps.append((hi - end, last, "window end", end - lo))
    gaps.sort(key=lambda g: -g[0])
    return {
        "busy_us": busy,
        "idle_share": 1.0 - busy / (hi - lo),
        "idle_gaps": [{"ms": g / 1e3, "after": a, "before": b, "at_ms": at / 1e3}
                      for g, a, b, at in gaps[:5]],
    }


RUN_RANGE = "bench_run"


def profile_run(run) -> dict | None:
    """One run under torch.profiler (CPU and CUDA activities), after a
    warm-up run under it whose events are dropped (kernels launched in the
    first milliseconds of a trace can go unrecorded); None where the
    profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        run()
        prof.step()
        t0 = time.perf_counter()
        with record_function(RUN_RANGE):
            run()
        seconds = time.perf_counter() - t0
    events = prof.events()
    ranges = {e.name for e in events if getattr(e, "is_user_annotation", False)} | {RUN_RANGE}
    window = next(e.time_range for e in events
                  if e.name == RUN_RANGE and e.device_type == DeviceType.CPU)
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in ranges
              and not getattr(e, "is_user_annotation", False)]
    kernels = [(e.name, e.time_range.start, e.time_range.end) for e in device
               if not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        return None
    by_name: dict[str, list] = {}
    for name, s, e in kernels:
        rec = by_name.setdefault(name, [0.0, 0])
        rec[0] += (e - s) / 1e3
        rec[1] += 1
    longest = sorted(kernels, key=lambda k: k[1] - k[2])[:10]  # the longest first
    glcm = [(e - s) / 1e3 for name, s, e in kernels if GLCM_KERNEL in name]
    return {
        "profiled_run_s": seconds,
        "glcm_ms": sum(glcm),
        "glcm_profiled_launches": len(glcm),
        "copy_ms": sum(e.time_range.end - e.time_range.start for e in device
                       if e.name.startswith(("Memcpy", "Memset"))) / 1e3,
        "device_ms_by_kernel": {name: {"ms": ms, "launches": k} for name, (ms, k)
                                in sorted(by_name.items(), key=lambda kv: -kv[1][0])},
        "longest_kernels": [{"name": name, "ms": (e - s) / 1e3, "at_ms": (s - window.start) / 1e3}
                            for name, s, e in longest],
        **device_timeline(kernels, (window.start, window.end)),
    }


class KernelInputs:
    """Keeps the GLCM kernel's inputs of one run (a shim around
    ``cuda_glcm.sufficient_stats`` while it is entered) and times the
    wrapper's call on them again, outside any run, with CUDA events: the
    kernel and its outputs' allocation and zeroing."""

    def __enter__(self):
        self.calls, self._orig = [], cuda_glcm.sufficient_stats

        def keep(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self._orig(*args, **kwargs)

        cuda_glcm.sufficient_stats = keep
        return self

    def __exit__(self, *exc):
        cuda_glcm.sufficient_stats = self._orig

    def kernel_ms(self, reps: int = KERNEL_REPS) -> float:
        """The sum over the kept launches of each one's median ms."""
        total = 0.0
        for args, kwargs in self.calls:
            times = []
            for i in range(reps + 3):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                cuda_glcm.sufficient_stats(*args, **kwargs)
                b.record()
                b.synchronize()
                if i >= 3:
                    times.append(a.elapsed_time(b))
            total += statistics.median(times)
        self.calls = []
        return total


# ---- one cell -------------------------------------------------------------

def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _quartiles(times) -> dict:
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    return {"median_s": float(med), "q1_s": float(q1), "q3_s": float(q3), "runs_s": list(times)}


def interleave(reps: int, ingest: int) -> list[bool]:
    """The order of the timed runs: ``reps`` compute-scope runs (False) with
    ``ingest`` ingest-scope runs (True) spread evenly among them, so that a
    drift of the host over the runs weighs on both scopes alike."""
    slots = [((j + 0.5) / reps, False) for j in range(reps)]
    slots += [((j + 0.5) / ingest, True) for j in range(ingest)]
    return [is_ingest for _, is_ingest in sorted(slots)]


def _counted(run):
    """(seconds, result, launches by form) of one run."""
    cuda_glcm.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    return time.perf_counter() - t0, out, dict(cuda_glcm.LAUNCHES_BY_FORM)


def measure_cell(cell: str, *, device: torch.device, n: int | None, seed: int, reps: int) -> dict:
    """Runs one cell (module doc) and returns its line."""
    on_card = device.type == "cuda"
    kw = {} if on_card else {"device": device}  # on the card: tpumcia's call, unchanged
    mask = donors = None
    if cell == "mednist_fused_logistic":
        gray, labels = mednist_workload(n or N_IMAGES, seed)
        n, channels, hw, unit = len(gray), 3, gray.shape[1], "images/s"
        cfg = mednist_config()
        images = torch.from_numpy(gray).to(device)
    else:
        raw, cell_mask, labels, donors = cytometry_objects(n or CYTO_N, seed=seed)
        n, channels, hw, unit = len(raw), CYTO_CH, CYTO_HW, "objects/s"
        cfg = cytometry_config()
        images = tt.quantize_to_levels(torch.from_numpy(raw).to(device), levels=LEVELS, src_levels=65536)
        mask = torch.from_numpy(cell_mask).to(device)
        del raw
    per_run = launches_per_run(n, cfg.batch_size)

    def run(x=None, timer=None):
        out = tt.run_pipeline(images if x is None else x, labels, mask=mask, groups=donors,
                              config=cfg, timer=timer, **kw)
        _sync(device)
        return out

    line = {"cell": cell, "configuration": CELLS[cell][0], "correct": False, "reasons": [],
            "measured_on": device.type, "gpu": gpu_line() if on_card else NOT_MEASURED,
            "device": torch.cuda.get_device_name(device) if on_card else "cpu",
            "seed": seed, "objects": n, "batch": cfg.batch_size, "reps": reps,
            "timed_scope": "run_pipeline with the inputs on the device, ending in a device "
                           "synchronise; data generation, upload and quantization excluded"}
    m, result = {"build_s": 0.0}, None
    launches: list[dict] = []
    if on_card:
        _, m["build_s"] = _build.build_library()
        _build.load_library()
        kept = KernelInputs()
        t0 = time.perf_counter()
        with kept:
            run()
        m["warmup_s"] = time.perf_counter() - t0
        m["glcm_events_ms"] = kept.kernel_ms()
        del kept
        torch.cuda.reset_peak_memory_stats(device)
    else:
        t0 = time.perf_counter()
        run()
        m["warmup_s"], m["glcm_events_ms"] = time.perf_counter() - t0, NOT_MEASURED

    times = {False: [], True: []}  # compute scope, ingest scope (MedNIST: the images on the host)
    for is_ingest in interleave(reps, max(4, reps // 2) if cell == "mednist_fused_logistic" else 0):
        seconds, out, counts = _counted(lambda: run(gray) if is_ingest else run())
        times[is_ingest].append(seconds)
        launches.append(counts)
        if not is_ingest:
            result = out
    m["peak_device_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else NOT_MEASURED
    m.update(_quartiles(times[False]))
    m["throughput"] = n / m["median_s"]
    if times[True]:
        m["ingest"] = _quartiles(times[True])
        m["images_per_s_ingest"] = n / m["ingest"]["median_s"]

    timer = StageTimer(device)
    launches.append(_counted(lambda: run(timer=timer))[2])
    line["stages_s"] = {s: timer.totals.get(s, 0.0) for s in STAGES}

    counts = run_counts(n=n, batch=cfg.batch_size, channels=channels, hw=hw, masked=mask is not None,
                        n_train=len(result.train_idx), n_test=len(result.test_idx),
                        classes=len(np.unique(labels[result.train_idx])),
                        repeats=cfg.importance.n_repeats)
    m.update(counts)
    m["glcm_launches"] = per_run
    m["glcm_bound_ms"] = counts["glcm_bytes"] / HBM_BYTES_PER_S * 1e3
    peak, dtype = flops_per_s()
    by_flops, by_bytes = counts["run_flops"] / peak, counts["run_bytes"] / HBM_BYTES_PER_S
    m["run_bound_ms"] = max(by_flops, by_bytes) * 1e3
    m["run_bound_by"] = f"operations ({dtype})" if by_flops > by_bytes else "bytes"
    m["run_mfu"] = m["run_bound_ms"] / 1e3 / m["median_s"] if on_card else NOT_MEASURED

    def counted_run():
        _, out, counts = _counted(run)
        launches.append(counts)
        return out

    # the profiler can drop a stretch of a run's kernels (≈ 20 of 11,000):
    # a profile short of the run's GLCM launches is taken again
    prof, attempts = None, 0
    while on_card and attempts < PROFILE_ATTEMPTS:
        prof, attempts = profile_run(counted_run), attempts + 1
        if prof is None or prof["glcm_profiled_launches"] == per_run:
            break
    line["profile_attempts"] = attempts
    for key in ("glcm_ms", "idle_share", "profiled_run_s"):
        m[key] = prof[key] if prof else NOT_MEASURED
    for key in ("device_ms_by_kernel", "longest_kernels", "idle_gaps", "copy_ms",
                "glcm_profiled_launches"):
        line[key] = prof[key] if prof else NOT_MEASURED
    if on_card:  # the profiler's sum over the run's launches; else the kernel alone
        m["glcm_roofline_share"] = m["glcm_bound_ms"] / (prof["glcm_ms"] if prof else m["glcm_events_ms"])
    else:
        m["glcm_roofline_share"] = NOT_MEASURED

    if cell == "mednist_fused_logistic":
        fails, form = mednist_failures(result, n), "B1a"
    else:
        fails, form = cytometry_failures(result, n, donors), "B1b"
    # the CPU runs the plain version, which counts no launch
    fails += launch_failures(launches, form, per_run if on_card else 0)
    if prof and prof["glcm_profiled_launches"] != per_run:
        fails.append(f"the profile shows {prof['glcm_profiled_launches']} GLCM launches, want {per_run}")
    for key in ("glcm_roofline_share", "run_mfu"):
        if on_card and not 0 < m[key] <= MAX_SHARE:
            fails.append(f"{key} {m[key]} outside (0, {MAX_SHARE}]: a counting error")
    line["correct"], line["reasons"] = not fails, fails
    line["test_accuracy"] = result.test_accuracy
    line["channel_totals"] = np.asarray(result.channel_result.total).tolist()
    line["metrics"] = _with_units(cell, m, unit, reps, correct=not fails)
    if cell == "mednist_fused_logistic":
        rate = line["metrics"]["images_per_s"]["value"]
        line.update({
            "metric": "feature_extraction_plus_channel_importance_throughput",
            "value": rate, "unit": "images/sec",
            "vs_baseline": None if rate is None else rate / BASELINE_IMAGES_PER_SEC,
        })
    return line


def _with_units(cell: str, m: dict, unit: str, reps: int, *, correct: bool) -> dict:
    """Each metric as {"value", "unit", "samples"}; the end-to-end metrics
    also carry their regression bound, and have no value when a gate
    failed."""
    name = CELLS[cell][1]
    units = {"median_s": "s", "q1_s": "s", "q3_s": "s", "runs_s": "s", "build_s": "s",
             "warmup_s": "s", "peak_device_bytes": "B", "glcm_launches": "launches",
             "glcm_bytes": "B", "glcm_bound_ms": "ms", "glcm_ms": "ms", "glcm_events_ms": "ms",
             "glcm_roofline_share": "1", "run_bytes": "B", "run_flops": "FLOP",
             "head_flops": "FLOP", "sweep_flops": "FLOP", "run_bound_ms": "ms",
             "run_bound_by": "", "run_mfu": "1", "idle_share": "1", "profiled_run_s": "s"}
    samples = {"median_s": reps, "q1_s": reps, "q3_s": reps, "runs_s": reps,
               "peak_device_bytes": reps, "glcm_events_ms": KERNEL_REPS}
    out = {}
    for key in METRICS:
        if key == "throughput":
            out[name] = {"value": m[key] if correct else None, "unit": unit, "samples": reps,
                         "regression_bound": REGRESSION_BOUNDS[name]}
        else:
            out[key] = {"value": m[key], "unit": units[key], "samples": samples.get(key, 1)}
    if "ingest" in m:
        ing = m["ingest"]
        out["images_per_s_ingest"] = {
            "value": m["images_per_s_ingest"] if correct else None, "unit": unit,
            "samples": len(ing["runs_s"]),
            "regression_bound": REGRESSION_BOUNDS["images_per_s_ingest"],
            "median_s": ing["median_s"], "q1_s": ing["q1_s"], "q3_s": ing["q3_s"],
            "runs_s": ing["runs_s"]}
    return out


def line_failures(line: dict) -> list[str]:
    """What is wrong with a printed line: a failed gate, a metric missing or
    not finite, a device metric with a value from the CPU, or a share
    outside (0, MAX_SHARE]."""
    fails = [] if line["correct"] else ["not correct: " + "; ".join(line["reasons"])]
    on_card = line["measured_on"] == "cuda"
    names = [CELLS[line["cell"]][1], *METRICS[1:]]
    if line["cell"] == "mednist_fused_logistic":
        names.append("images_per_s_ingest")
    for key in names:
        value = line["metrics"].get(key, {}).get("value", "missing")
        if key in DEVICE_METRICS and not on_card:
            ok = value == NOT_MEASURED
        elif key == "run_bound_by":
            ok = value in ("bytes", "operations (float32)", "operations (tf32)")
        else:
            ok = all(isinstance(v, (int, float)) and math.isfinite(v)
                     for v in (value if isinstance(value, list) else [value]))
        if not ok:
            fails.append(f"metric {key}: {value!r}")
    if on_card:
        for key in ("glcm_roofline_share", "run_mfu"):
            value = line["metrics"][key]["value"]
            if isinstance(value, float) and not 0 < value <= MAX_SHARE:
                fails.append(f"{key} {value} outside (0, {MAX_SHARE}]")
        if not line["gpu"] or line["gpu"] == NOT_MEASURED:
            fails.append("no card name and power limit")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", choices=(*CELLS, "all"), default="all")
    ap.add_argument("--seed", type=int, default=0, help="the workload seed (images and objects)")
    ap.add_argument("--reps", type=int, default=48,
                    help="timed runs a cell (at least 2); MedNIST adds max(4, reps // 2) from the host")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu' for a rehearsal at a small --n")
    ap.add_argument("--n", type=int, default=None,
                    help="images or objects a cell (default: the cell's own size)")
    args = ap.parse_args(argv)
    if args.reps < 2:
        ap.error("--reps must be at least 2")
    device = torch.device(require_device(args.device, "bench_torch.py"))
    if args.cell == "all":
        # each cell in a process of its own, one after the other: a cell
        # measured after another in one process reads up to 1.3x slower
        # (PERF.md §6)
        rest = ["--seed", str(args.seed), "--reps", str(args.reps), "--device", args.device]
        rest += [] if args.n is None else ["--n", str(args.n)]
        rcs = [subprocess.run([sys.executable, os.path.abspath(__file__), "--cell", cell, *rest]).returncode
               for cell in CELLS]
        return 0 if not any(rcs) else 1
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    line = measure_cell(args.cell, device=device, n=args.n, seed=args.seed, reps=args.reps)
    print(json.dumps(line), flush=True)
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
