"""Smoke run of tpumcia_torch on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py

Phases (any failure exits nonzero, and no result line is printed):
  1. environment: a CUDA device must be present; prints the card's name and
     power limit (nvidia-smi) and the torch / CUDA versions;
  2. build: compiles the CUDA kernels from the sources in this checkout;
  3. kernel vs plain: each form of the GLCM statistics kernel (B1a
     maskless, B1b masked, B1c difference histogram, B2 several offsets, B1d
     at 65536 pixels or more than 256 levels) against its plain PyTorch
     version at the main paths' shapes and at edge cases (integer fields
     bit-equal, dstats[3] to rel 1e-6), both versions' median times, and per
     main-path shape the bytes it must move, its bound at the card's memory
     rate, its layout, dynamic shared memory and resident blocks per SM
     (gated: >= 3 at the bench and cytometry shapes, >= 2 at 1024 levels);
  4. the slice: ``run_pipeline`` over 12,000 synthetic 64x64 images with 2
     synthesized noise channels, a 300-step logistic head and permutation
     importance, as bench.py drives the JAX package. It checks the launch
     count, the accuracy and the channel ranking, times untimed runs (img/s)
     and one staged run, and checks a small run's features against the same
     run on the CPU with the plain version;
  5. the cytometry slice (BASELINE config 4): ``run_pipeline`` over 16,384
     masked 12-channel 48x48 uint16 objects quantized to 256 levels on the
     card, donor-grouped split; checks launches, donors, accuracy and the
     signal channel, times it like phase 4;
  6. extract_features: the exact, masked hybrid and 4-offset hybrid forms
     of the public extraction on the card, against each other and against
     the same calls on the CPU;
  7. the classic slice at 1024 levels (B1d): the cytometry objects of phase
     5 quantized to 1024 levels on the card, ``run_pipeline`` with
     fast_path='auto', which routes them to the classic path (packed f32
     wire, logistic head, both permutation views); checks launches, donors,
     accuracy, the signal channel and a card-vs-CPU feature check, times it;
  8. the classic slice on 256x256 fields (B1d): 1,200 synthetic 256x256
     images with 2 noise channels synthesized on the card, the host f64
     backend that hybrid becomes at 65536 pixels, logistic head; then an
     MLP head, ablation and coefficient importance on its feature matrix;
  9. the notebook's forest slice (BASELINE config 2 with the random-forest
     head, the reference's own method): the bench workload of phase 4
     through ``run_pipeline`` with ``head.kind='random_forest'`` at
     tpumcia's defaults (100 trees, no depth cap, seed 0) and
     fast_path='auto', so the classic path: the forest grown on the card,
     the channel sweep through it on the card, MDI as the feature view;
     checks launches, accuracy, the signal channel in both views, MDI, the
     inference form, both forms against each other, and a small forest
     grown on the card and on the CPU from one seed (bit-equal trees), times
     it (objects/s) and one staged run;
 10. cytometry with morphology: phase 5's objects with
     ``include_morphology=True`` (12 x (23 + 8) columns, the classic path),
     the forest head and MDI (``channel_method='auto'``); checks launches,
     donors, accuracy, the signal channel, the morphology block against the
     CPU and against the shared mask's own values, and ``glcm_matrix`` and
     ``intensity_features_direct`` on the card against the CPU; times it;
 11. prints the kernels' JSON line and, last, the device JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

N_IMAGES = 12_000
BATCH = 2048
TIMED_RUNS = 5
KERNEL_REPS = 20
BENCH_SHAPE = (2048, 3, 64, 64)
LEVELS = 256
OFFSET = (0, 5)
DSTATS3_RTOL = 1e-6  # f32 homogeneity sum: the kernel and plain version sum in another order
FEATURE_ATOL = 1e-5  # f32 moment/entropy/homogeneity words summed in another order
CYTO_N, CYTO_HW, CYTO_CH, CYTO_SIGNAL = 16_384, 48, 12, 4
CLASSIC_LEVELS = 1024  # phase 7: 16-bit data at 4x finer levels than 256
FIELD_PER_CLASS, FIELD_HW = 200, 256  # phase 8: 1,200 256x256 fields
FOUR_OFFSETS = ((0, 5), (4, 4), (5, 0), (4, -4))  # distance 5 at 0, 45, 90, 135 degrees
FOREST_SMALL = (600, 10)  # phase 9's card-vs-CPU forest: rows, trees
FOREST_PROBA_ATOL = 1e-6  # GEMM vs lock-step: the same leaves, f32 sums in another order
SOURCE = "tpumcia_torch/csrc/glcm_stats.cu"
# each kernel form and the TPU kernel it replaces
FORMS = {
    "B1a": ("glcm_stats maskless", "tpumcia/features/pallas_glcm.py:400"),
    "B1b": ("glcm_stats masked", "tpumcia/features/pallas_glcm.py:400"),
    "B1c": ("glcm_stats need_diff", "tpumcia/features/pallas_glcm.py:400"),
    "B2": ("glcm_stats multi-offset", "tpumcia/features/pallas_glcm.py:878"),
    "B1d": ("glcm_stats_large (u64 pair table or u32 G in bands; also replaces :878 at these sizes)",
            "tpumcia/features/pallas_glcm.py:400"),
}
LIBRARY = "none: no single PyTorch call computes these statistics"


def log(*a):
    print(*a, flush=True)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _cuda_events_ms(fn, reps, warm):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _stats_error(got, want) -> float:
    """Max abs difference over all fields; raises unless every integer field
    is bit-equal and dstats[3] agrees to DSTATS3_RTOL."""
    import torch

    worst = 0.0
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if g is None or w is None:
            if not (g is None and w is None):
                raise AssertionError(f"{name}: one side is None")
            continue
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        if name == "dstats":
            if not torch.equal(g[..., :3], w[..., :3]):
                raise AssertionError("dstats[0..2] not bit-equal")
            d = (g[..., 3] - w[..., 3]).abs()
            if bool((d > DSTATS3_RTOL * w[..., 3].abs()).any()):
                raise AssertionError(f"dstats[3] off by {d.max().item()}")
            worst = max(worst, d.max().item() if d.numel() else 0.0)
        elif not torch.equal(g, w):
            diff = (g.double() - w.double()).abs().max().item()
            raise AssertionError(f"{name} not bit-equal (max abs diff {diff})")
    return worst


def _timed_pair(run_kernel, run_plain):
    """Median ms of the kernel and of the plain version, in turns plain,
    kernel, kernel, plain. The plain version is warmed up once (eager
    PyTorch: the first run fills the allocator's cache; its slowest case
    takes 1.5 s), the kernel three times."""
    p1 = _cuda_events_ms(run_plain, max(3, KERNEL_REPS // 4), 1)
    k1 = _cuda_events_ms(run_kernel, KERNEL_REPS, 3)
    k2 = _cuda_events_ms(run_kernel, KERNEL_REPS, 3)
    p2 = _cuda_events_ms(run_plain, max(3, KERNEL_REPS // 4), 1)
    return (k1, k2), (p1, p2)


def cytometry_objects(n, hw=CYTO_HW, channels=CYTO_CH, signal_ch=CYTO_SIGNAL, seed=0):
    """Imaging-flow-cytometry-like objects (BASELINE config 4), shaped like
    examples/cytometry_h5.py: uint16 (n, hw, hw, channels) with background
    U[200, 1500), a cell disk of radius U(10, 16)*hw/48 centred in
    [0.35, 0.65]*hw, signal on ``signal_ch`` only (activated:
    exp(-r/(8*hw/48))*38000, resting: disk*6000). Returns (images, shared
    disk mask, labels (i // 8) % 2 with 0 = activated, donors
    "donor{i % 8}"): every donor holds both classes."""
    import numpy as np

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


def field_batch(device):
    """Phase 8's data: 1,200 synthetic 256x256 grayscale fields, their
    labels, and the (N, H, W, 3) uint8 batch on ``device`` with the 2 noise
    channels synthesized as run_pipeline's classic path synthesizes them
    (seed 0, batch BATCH), which is what its one B1d launch is given."""
    from tpumcia_torch.io.synthetic import synthetic_mednist
    from tpumcia_torch.preprocess.synth import add_noise_channels_batched

    gray, labels, _ = synthetic_mednist(FIELD_PER_CLASS, num_classes=6, hw=FIELD_HW, seed=0)
    return gray, labels, add_noise_channels_batched(gray, seed=0, batch_size=BATCH, device=device)


def timed_cases(device):
    """The shapes phase 3 times, with their data, one at a time (kernel_ab.py
    times the same ones against another checkout's kernel): dicts of
    ``form``, ``x`` ((B, C, H, W) int32 levels on ``device``), ``offsets``,
    ``mask`` (None or a channels-last numpy mask), ``need_diff``,
    ``levels``, ``note``, ``per_run`` (the launches of a main-path run at
    this shape) and ``min_blocks`` (the resident blocks per SM its layout
    must give). Each form's main-path shapes come first."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def rand(shape, levels=LEVELS):
        return dev(rng.integers(0, levels, size=shape, dtype=np.int32))

    def item(form, x, offsets=(OFFSET,), mask=None, need_diff=False, levels=LEVELS, note="",
             per_run=0, min_blocks=0):
        return {"form": form, "x": x, "offsets": list(offsets), "mask": mask, "need_diff": need_diff,
                "levels": levels, "note": note, "per_run": per_run, "min_blocks": min_blocks}

    bench_x = rand(BENCH_SHAPE)
    mask80 = rng.random((BENCH_SHAPE[0], 64, 64, 3)) > 0.2  # config 1: 80 % of pixels
    raw, cell, _, _ = cytometry_objects(BENCH_SHAPE[0], seed=1)
    cyto = dev((raw >> 8).astype(np.int32).transpose(0, 3, 1, 2))  # its own levels, v >> 8
    yield item("B1a", bench_x, per_run=6, min_blocks=3)
    yield item("B1b", cyto, mask=cell, note="cytometry levels", per_run=8, min_blocks=3)
    yield item("B1b", rand(cyto.shape), mask=cell, note="random levels")  # every key distinct
    del cyto
    yield item("B1b", bench_x, mask=mask80)
    yield item("B1c", bench_x, need_diff=True)
    yield item("B1c", bench_x, mask=mask80, need_diff=True)
    yield item("B2", bench_x, offsets=FOUR_OFFSETS)
    del bench_x
    # B1d: the two main-path batches first (one of phase 7's 1024-level
    # cytometry batches; phase 8's whole batch, its 1,200 fields with the
    # noise channels synthesized as run_pipeline synthesizes them), then
    # random levels at 64x3x256x256 and the edge cases: a constant 300x300
    # channel whose one G cell holds 89,700 pairs (past u16), a size that is
    # not square, 3 offsets of both signs at 512 levels, 4096 levels, and a
    # per-channel mask at 256x256
    raw, cell, _, _ = cytometry_objects(BENCH_SHAPE[0], seed=2)
    yield item("B1d", dev((raw.astype(np.int32) >> 6).transpose(0, 3, 1, 2)), mask=cell,
               need_diff=True, levels=CLASSIC_LEVELS, note="cytometry levels", per_run=8,
               min_blocks=2)
    del raw
    yield item("B1d", field_batch(device)[2].permute(0, 3, 1, 2).to(torch.int32).contiguous(),
               need_diff=True, note="phase 8's fields", per_run=1)
    yield item("B1d", rand((64, 3, 256, 256)), need_diff=True)
    yield item("B1d", dev(np.full((2, 1, 300, 300), 200, np.int32)), offsets=[(0, 1)],
               need_diff=True, note="constant")
    yield item("B1d", rand((3, 2, 259, 255)), offsets=[(1, 2)], need_diff=True)
    yield item("B1d", rand((8, 2, 64, 64), 512), offsets=[(0, 5), (3, -2), (-4, 1)],
               need_diff=True, levels=512)
    yield item("B1d", rand((8, 1, 64, 64), 4096), need_diff=True, levels=4096)
    pc_mask = rng.random((4, 256, 256, 3)) < 0.7
    pc_mask[0, :, :, 1] = False  # an empty (image, channel)
    yield item("B1d", rand((4, 3, 256, 256)), mask=pc_mask, need_diff=True,
               note="per-channel mask")


def timed_label(shape, offsets, mask, levels, note) -> str:
    """How the kernels line and kernel_ab.py name a timed case."""
    return ("x".join(map(str, shape)) + f" L{levels} offsets {list(offsets)}"
            + (" masked" if mask is not None else "") + (f", {note}" if note else ""))


def phase_kernel(device):
    """Every kernel form vs its plain version on the card; returns the
    forms' records (without launches)."""
    import numpy as np
    import torch

    from tpumcia_torch.features import cuda_glcm
    from tpumcia_torch.features.stats import prepare_mask

    rng = np.random.default_rng(0)
    errs = {form: 0.0 for form in FORMS}

    def case(shape, offsets, fill=None, mask=None, need_diff=False, x=None, levels=LEVELS):
        """``mask``: None or a channels-last numpy mask, laid out with
        prepare_mask as the entry points do."""
        if x is None:
            x = rng.integers(0, levels, size=shape, dtype=np.int32)
        if fill is not None:
            for (b, c), v in fill.items():
                x[b, c] = v
        t = torch.from_numpy(x).to(device) if isinstance(x, np.ndarray) else x
        B, C, H, W = t.shape
        m = None if mask is None else prepare_mask(mask, (B, H, W, C), device)
        if len(offsets) == 1:
            got = [cuda_glcm.sufficient_stats(t, m, levels=levels, offset=offsets[0], need_diff=need_diff)]
            want = [cuda_glcm.sufficient_stats_reference(t, m, levels=levels, offset=offsets[0], need_diff=need_diff)]
        else:
            got = cuda_glcm.sufficient_stats_multi(t, m, levels=levels, offsets=offsets, need_diff=need_diff)
            want = cuda_glcm.sufficient_stats_multi_reference(t, m, levels=levels, offsets=offsets, need_diff=need_diff)
        _sync(device)
        err = max(_stats_error(g, w) for g, w in zip(got, want))
        form = cuda_glcm.kernel_form(hw=H * W, levels=levels, masked=m is not None,
                                     need_diff=need_diff, num_offsets=len(offsets))
        errs[form] = max(errs[form], err)
        log(f"  {form} kernel == plain  shape={tuple(t.shape)} levels={levels} offsets={list(offsets)} "
            f"mask={'none' if mask is None else tuple(np.shape(mask))} max_abs_err={err!r}")
        return t, m, form

    # B1a edge cases: all-zero and constant channels, every offset sign, odd
    # and non-square sizes, and 72x72 (past the cheap-limb gate)
    for off in [(0, 1), (1, 0), (3, -2), (-2, 1), OFFSET]:
        case((3, 2, 64, 64), [off], fill={(0, 0): 0, (1, 1): 77, (2, 0): LEVELS - 1})
    case((2, 3, 37, 53), [(1, 2)])
    case((2, 2, 72, 72), [OFFSET], fill={(1, 1): 0})

    # the other forms' edge cases: an empty mask, a one-pixel mask (no
    # pairs), a mask touching the edge with offsets of both signs, shared
    # (B, H, W) and per-channel masks in bool and uint8, the generic limbs
    # at 72x72, and several offsets re-zeroing G in turn
    edge = rng.random((3, 64, 64, 2)) < 0.8
    edge[0, :, :, 0] = False
    edge[1, :, :, 1] = False
    edge[1, 0, 0, 1] = True
    edge[2, :, :, :] = False
    edge[2, :24, -20:, :] = True
    for off in [(3, -2), (-2, 1), (0, 5)]:
        case((3, 2, 64, 64), [off], fill={(0, 1): 0}, mask=edge)
        case((3, 2, 64, 64), [off], mask=edge[..., 0].astype(np.uint8))
        case((3, 2, 64, 64), [off], mask=edge, need_diff=True)
    case((2, 2, 72, 72), [OFFSET], need_diff=True)
    case((2, 2, 72, 72), [OFFSET], mask=rng.random((2, 72, 72)) < 0.5)
    for nd in (False, True):
        case((3, 2, 64, 64), [(3, -2), (-2, 1), (0, 5), (5, 0)], mask=edge, need_diff=nd)
        case((2, 3, 37, 53), [(0, 1), (1, 1), (-1, 2)], need_diff=nd)

    # the pair table's hazards: one level in every pixel (one key takes
    # every pair: the largest warp groups), a constant 128x128 channel
    # (16,256 pairs in one cell, past the generic a-limb; the table as large
    # as a dense G), random levels at 1024 and 4096 levels (a table nearly
    # full of distinct keys, long probes), an empty and a one-pixel mask, 4
    # offsets reusing the table, and 37x53 (the scalar load path) masked
    for hw in (64, 48):
        one = np.full((2, 3, hw, hw), 9, np.int32)
        case(one.shape, [OFFSET], x=one)
        case(one.shape, [OFFSET], x=one.copy(), mask=np.ones((2, hw, hw), bool), need_diff=True)
    const128 = np.full((2, 1, 128, 128), 200, np.int32)
    for nd in (False, True):
        case(const128.shape, [(0, 1)], x=const128.copy(), need_diff=nd)
    hazard_mask = rng.random((4, 48, 48)) < 0.9
    hazard_mask[0] = False
    hazard_mask[1] = False
    hazard_mask[1, 20, 20] = True
    case((4, 3, 48, 48), [OFFSET], mask=hazard_mask, need_diff=True, levels=CLASSIC_LEVELS)
    case((4, 3, 48, 48), [OFFSET], mask=hazard_mask)
    case((4, 2, 64, 64), [OFFSET, (3, -2)], need_diff=True, levels=4096)
    case((4, 3, 48, 48), list(FOUR_OFFSETS), mask=hazard_mask, need_diff=True, levels=CLASSIC_LEVELS)
    case((3, 2, 37, 53), [(1, 2)], mask=rng.random((3, 37, 53)) < 0.7)
    # 257x255, 65,535 pixels: the largest size the small kernel (B1c here)
    # takes; 128x128 at 1024 levels, a pair table smaller than G that does
    # not fit in shared memory (the kernel plans the bands)
    case((3, 2, 257, 255), [(1, 2)], need_diff=True, fill={(0, 0): 200})
    if cuda_glcm.launch_info((2, 2, 128, 128), CLASSIC_LEVELS, [(0, 1)], masked=False,
                             need_diff=True)["layout"] != "bands":
        raise AssertionError("128x128 at 1024 levels: the kernel did not plan the bands")
    case((2, 2, 128, 128), [(0, 1)], need_diff=True, levels=CLASSIC_LEVELS)

    records = {}

    def bench(form, x, offsets, mask, need_diff, levels, note, per_run, min_blocks):
        """One of :func:`timed_cases`, checked, timed and logged."""
        t, m, ran = case(tuple(x.shape), offsets, mask=mask, need_diff=need_diff, x=x, levels=levels)
        if ran != form:
            raise AssertionError(f"{tuple(t.shape)} at {levels} levels runs form {ran}, not {form}")
        if len(offsets) == 1:
            def run_kernel():
                cuda_glcm.sufficient_stats(t, m, levels=levels, offset=offsets[0], need_diff=need_diff)

            def run_plain():
                cuda_glcm.sufficient_stats_reference(t, m, levels=levels, offset=offsets[0], need_diff=need_diff)
        else:
            def run_kernel():
                cuda_glcm.sufficient_stats_multi(t, m, levels=levels, offsets=offsets, need_diff=need_diff)

            def run_plain():
                cuda_glcm.sufficient_stats_multi_reference(t, m, levels=levels, offsets=offsets, need_diff=need_diff)
        (k1, k2), (p1, p2) = _timed_pair(run_kernel, run_plain)
        log(f"  {form} at {tuple(t.shape)} levels={levels} offsets={list(offsets)} mask={mask is not None} "
            f"need_diff={need_diff}: kernel {k1!r} / {k2!r} ms, plain {p1!r} / {p2!r} ms "
            "(median of runs, CUDA events)")
        nbytes = cuda_glcm.traffic_bytes(tuple(t.shape), levels, offsets, need_diff=need_diff,
                                         mask_channels=0 if m is None else m.shape[1])
        bound = cuda_glcm.bound_ms(nbytes)
        info = cuda_glcm.launch_info(tuple(t.shape), levels, offsets, masked=m is not None,
                                     need_diff=need_diff)
        ms = min(k1, k2)
        log(f"    {nbytes} bytes, bound {bound!r} ms at 3.35 TB/s, share {bound / ms!r}; layout "
            f"{info['layout']} ({info['table_slots']} slots), {info['threads']} threads, "
            f"{info['smem_bytes']} B dynamic shared memory, {info['blocks_per_sm']} blocks per SM, "
            f"plane in shared memory {info['plane_in_smem']}")
        if info["blocks_per_sm"] < min_blocks:
            raise AssertionError(f"{form} at {tuple(t.shape)}: {info['blocks_per_sm']} blocks per SM "
                                 f"< {min_blocks}")
        rec = records.setdefault(form, {"name": FORMS[form][0], "route": "cuda", "source": SOURCE,
                                        "replaces": FORMS[form][1], "shapes": []})
        rec["shapes"].append({
            "at": timed_label(t.shape, offsets, mask, levels, note), "ms": ms, "plain_ms": min(p1, p2), "bytes": nbytes, "bound_ms": bound,
            "bound_by": "bytes", "share": bound / ms, "launches_per_run": per_run,
            "library_ms": None, **info,
        })
        for key, val in (("ms", ms), ("plain_ms", min(p1, p2)), ("bound_ms", bound),
                         ("bound_by", "bytes"), ("library_ms", None), ("library", LIBRARY)):
            rec.setdefault(key, val)

    for c in timed_cases(device):
        bench(**c)
    for form, rec in records.items():
        rec["max_abs_err"] = errs[form]
    return records


def _slice_config():
    import tpumcia_torch as tt

    return tt.PipelineConfig(
        synth=tt.SynthConfig(noise_channels=2, seed=0),
        head=tt.HeadConfig(kind="logistic", num_steps=300),
        split=tt.SplitConfig(test_size=0.25, seed=0, stratify=True),
        fast_path="always",
        batch_size=BATCH,
    )


def _signal_first(result) -> bool:
    import numpy as np

    feat_chan_total = np.array([
        result.feature_result.feature_importances[cols].sum()
        for cols in result.features.channel_columns()
    ])
    return (
        int(np.argmax(result.channel_result.total)) == 0
        and int(np.argmax(feat_chan_total)) == 0
    )


def phase_slice(device, n_images=N_IMAGES, timed_runs=TIMED_RUNS):
    """The main path through the public entry; returns (launches, record)."""
    import numpy as np
    import torch

    import tpumcia_torch as tt
    from tpumcia_torch.io.synthetic import synthetic_mednist
    from tpumcia_torch.utils.profiling import StageTimer

    gray, labels, _ = synthetic_mednist(max(n_images // 6, 1), num_classes=6, seed=0)
    gray, labels = gray[:n_images], labels[:n_images]
    cfg = _slice_config()
    per_run = -(-len(gray) // min(BATCH, len(gray)))

    def run():
        out = tt.run_pipeline(gray, labels, config=cfg, device=device)
        _sync(device)
        return out

    launches, times, result = _timed_runs(run, timed_runs, "B1a", per_run)

    X = result.features.values
    if X.shape != (len(gray), 69) or not np.isfinite(np.nan_to_num(X)).all():
        raise AssertionError(f"feature matrix {X.shape} is not finite (N, 69)")
    dv = result.features.device_values
    if tuple(dv.shape) != (len(gray), 69) or not bool(torch.isfinite(dv).all()):
        raise AssertionError("device feature block is not finite (N, 69)")
    if not _signal_first(result):
        raise AssertionError(
            f"signal channel not ranked first: {result.channel_result.total}"
        )
    if result.test_accuracy < 0.90:
        raise AssertionError(f"test accuracy {result.test_accuracy} < 0.90")

    timer = StageTimer(device)
    tt.run_pipeline(gray, labels, config=cfg, device=device, timer=timer)
    med = statistics.median(times)
    log(f"  runs (s): {times!r}")
    log(f"  median {med!r} s = {len(gray) / med!r} img/s over {len(gray)} images")
    log(f"  test_accuracy {result.test_accuracy!r}; channel totals {result.channel_result.total.tolist()!r}")
    log(f"  staged run (synchronised at each stage, s): {json.dumps(timer.totals)}")
    return launches, {
        "img_per_s": len(gray) / med, "median_s": med, "runs_s": times,
        "test_accuracy": result.test_accuracy, "stages_s": timer.totals,
    }


def phase_reference(device, n_images=180):
    """A small run on the card against the same run on the CPU (the plain
    version), on 3-channel images made on the host (the device generators
    of the two runs differ, so nothing is synthesized): features within
    FEATURE_ATOL, the signal channel first on both."""
    import numpy as np

    import tpumcia_torch as tt
    from tpumcia_torch.io.synthetic import synthetic_mednist

    gray, labels, _ = synthetic_mednist(n_images // 6, num_classes=6, seed=5)
    noise = np.random.default_rng(5).normal(0, 0.1, size=(*gray.shape, 2))
    images = np.concatenate(
        [gray[..., None], (np.clip(noise, 0, 1) * 255).astype(np.uint8)], axis=-1
    )
    cfg = dataclasses.replace(
        _slice_config(), batch_size=64, synth=tt.SynthConfig(noise_channels=0),
        head=tt.HeadConfig(kind="logistic", num_steps=60),
    )
    card = tt.run_pipeline(images, labels, config=cfg, device=device)
    cpu = tt.run_pipeline(images, labels, config=cfg, device="cpu")
    a, b = card.features.values, cpu.features.values
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        raise AssertionError("card vs CPU NaN patterns differ")
    diff = float(np.nanmax(np.abs(a - b)))
    if not diff <= FEATURE_ATOL:
        raise AssertionError(f"card vs CPU features differ by {diff}")
    if not (_signal_first(card) and _signal_first(cpu)):
        raise AssertionError("signal channel not first on the card or on the CPU")
    log(f"  {n_images} images: card vs CPU features max abs diff {diff!r}; "
        f"rankings {card.channel_result.ranking.tolist()} / {cpu.channel_result.ranking.tolist()}")


def phase_cytometry(device, data, timed_runs=4):
    """BASELINE config 4 through ``run_pipeline``: masked 12-channel uint16
    objects (``data``: cytometry_objects(CYTO_N) and the seconds it took)
    quantized on the card, donor-grouped split; returns (B1b launches,
    record)."""
    import numpy as np
    import torch

    import tpumcia_torch as tt
    from tpumcia_torch.utils.profiling import StageTimer

    (raw, mask, labels, donors), gen_s = data
    n = len(raw)
    t0 = time.perf_counter()
    raw_dev = torch.from_numpy(raw).to(device)
    x = tt.quantize_to_levels(raw_dev, levels=LEVELS, src_levels=65536)
    _sync(device)
    upload_s = time.perf_counter() - t0
    # the card's quantization against the host's v >> 8, on a slice
    if not np.array_equal(x[:64].cpu().numpy(), (raw[:64] >> 8).astype(np.int32)):
        raise AssertionError("quantize_to_levels on the card differs from v >> 8")
    del raw_dev
    cfg = tt.PipelineConfig(
        head=tt.HeadConfig(kind="logistic", num_steps=300),
        split=tt.SplitConfig(test_size=0.25, seed=0, group_by="donor"),
        fast_path="always",
        batch_size=BATCH,
    )
    per_run = -(-n // BATCH)

    def run(timer=None):
        out = tt.run_pipeline(x, labels, mask=mask, groups=donors, config=cfg,
                              device=device, timer=timer)
        _sync(device)
        return out

    launches, times, result = _timed_runs(run, timed_runs, "B1b", per_run)

    X = result.features.values
    F = CYTO_CH * 23
    if X.shape != (n, F) or not np.isfinite(np.nan_to_num(X)).all():
        raise AssertionError(f"feature matrix {X.shape} is not finite ({n}, {F})")
    train_donors = {str(d) for d in donors[result.train_idx]}
    test_donors = {str(d) for d in donors[result.test_idx]}
    if train_donors & test_donors or not test_donors:
        raise AssertionError(f"donor split leaks: train {train_donors}, test {test_donors}")
    total = np.asarray(result.channel_result.total)
    if int(np.argmax(total)) != CYTO_SIGNAL or not total[CYTO_SIGNAL] > 0:
        raise AssertionError(f"signal channel {CYTO_SIGNAL} not first: {total.tolist()}")
    if result.test_accuracy < 0.95:
        raise AssertionError(f"test accuracy {result.test_accuracy} < 0.95")

    timer = StageTimer(device)
    run(timer)
    med = statistics.median(times)
    log(f"  data: {n} objects {CYTO_HW}x{CYTO_HW}x{CYTO_CH} uint16 made in {gen_s!r} s; "
        f"upload + quantize on the card {upload_s!r} s")
    log(f"  runs (s): {times!r}")
    log(f"  median {med!r} s = {n / med!r} img/s over {n} objects")
    log(f"  test_accuracy {result.test_accuracy!r}; test donors {sorted(test_donors)}; "
        f"channel totals {total.tolist()!r}")
    log(f"  staged run (synchronised at each stage, s): {json.dumps(timer.totals)}")
    return launches, {
        "img_per_s": n / med, "median_s": med, "runs_s": times,
        "test_accuracy": result.test_accuracy, "stages_s": timer.totals,
        "channel_totals": total.tolist(), "test_donors": sorted(test_donors),
    }


def phase_extract(device, n=BENCH_SHAPE[0], n_cpu=64):
    """``extract_features`` on config-1 masked images (64x64x3, 80 % mask):
    exact on the card equals exact on the CPU bit for bit (the same
    integers through the same float64 code), the masked hybrid result is
    within FEATURE_ATOL of the exact one, and a 4-offset hybrid call is
    within FEATURE_ATOL of its CPU run. Returns ({form: launches}, record)."""
    import numpy as np

    import tpumcia_torch as tt
    from tpumcia_torch.features import cuda_glcm

    rng = np.random.default_rng(0)
    imgs = (rng.random((n, 64, 64, 3)) * 256).astype(np.uint8)
    mask = rng.random((n, 64, 64, 3)) > 0.2
    exact = tt.FeatureConfig(precision="exact")
    multi = tt.FeatureConfig(glcm=tt.GLCMConfig(distance=5, angle=(0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4)))
    if [tuple(o) for o in multi.glcm.offsets] != list(FOUR_OFFSETS):
        raise AssertionError(f"4-angle config gives offsets {multi.glcm.offsets}")

    cuda_glcm.reset_launch_counts()
    t0 = time.perf_counter()
    card_exact = tt.extract_features(imgs, mask, device=device, config=exact)
    exact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_hybrid = tt.extract_features(imgs, mask, device=device)
    hybrid_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_multi = tt.extract_features(imgs, mask, device=device, config=multi)
    multi_s = time.perf_counter() - t0
    launches = dict(cuda_glcm.LAUNCHES_BY_FORM)
    if launches["B1c"] != 1 or launches["B1b"] != 1 or launches["B2"] != 1:
        raise AssertionError(f"extract_features launched {launches}, want B1c, B1b and B2 once each")

    cpu_exact = tt.extract_features(imgs[:n_cpu], mask[:n_cpu], device="cpu", config=exact)
    cpu_multi = tt.extract_features(imgs[:n_cpu], mask[:n_cpu], device="cpu", config=multi)
    a, b = card_exact.values[:n_cpu], cpu_exact.values
    if not (np.array_equal(np.isnan(a), np.isnan(b)) and np.array_equal(np.nan_to_num(a), np.nan_to_num(b))):
        raise AssertionError(f"exact features on the card differ from the CPU by {np.nanmax(np.abs(a - b))}")
    hyb_err = float(np.nanmax(np.abs(card_hybrid.values - card_exact.values)))
    if not hyb_err <= FEATURE_ATOL:
        raise AssertionError(f"masked hybrid differs from exact by {hyb_err}")
    multi_err = float(np.nanmax(np.abs(card_multi.values[:n_cpu] - cpu_multi.values)))
    if not multi_err <= FEATURE_ATOL or card_multi.shape != (n, 3 * (17 + 4 * 6)):
        raise AssertionError(f"4-offset hybrid {card_multi.shape} differs from the CPU by {multi_err}")
    log(f"  {n} masked 64x64x3 images: exact {exact_s!r} s, hybrid {hybrid_s!r} s, "
        f"4-offset hybrid {multi_s!r} s (first calls, host clock)")
    log(f"  exact card == CPU on {n_cpu} images (max abs 0); hybrid vs exact {hyb_err!r}; "
        f"4-offset card vs CPU {multi_err!r}")
    return launches, {"exact_s": exact_s, "hybrid_s": hybrid_s, "multi_offset_s": multi_s,
                      "hybrid_vs_exact": hyb_err, "multi_card_vs_cpu": multi_err}


def _timed_runs(run, timed_runs, form, per_run=None):
    """A warm-up run, then ``timed_runs`` runs with the launch counts set to
    0 before them. Raises unless ``form`` alone launched, ``per_run`` times
    per run when given (else at least once). Returns (its launches, seconds
    per run, the last result)."""
    from tpumcia_torch.features import cuda_glcm

    run()
    cuda_glcm.reset_launch_counts()
    times, result = [], None
    for _ in range(timed_runs):
        t0 = time.perf_counter()
        result = run()
        times.append(time.perf_counter() - t0)
    launches = cuda_glcm.LAUNCHES_BY_FORM[form]
    want = None if per_run is None else per_run * timed_runs
    if cuda_glcm.LAUNCHES != launches or launches == 0 or want not in (None, launches):
        raise AssertionError(f"kernel launched {cuda_glcm.LAUNCHES_BY_FORM}, want {form} only"
                             + (f", {per_run} per run" if per_run else ""))
    return launches, times, result


def phase_classic_levels(device, data, timed_runs=3, n_cpu=64):
    """The classic slice at 1024 levels: phase 5's objects quantized to
    CLASSIC_LEVELS on the card, ``run_pipeline`` with fast_path='auto'
    (tpumcia's classic path for > 256 levels: the packed f32 wire, a
    logistic head, both permutation views). Returns (B1d launches, record)."""
    import numpy as np
    import torch

    import tpumcia_torch as tt
    from tpumcia_torch.pipeline.run import _fast_path_ok
    from tpumcia_torch.utils.profiling import StageTimer

    (raw, mask, labels, donors), _ = data
    n = len(raw)
    t0 = time.perf_counter()
    x = tt.quantize_to_levels(torch.from_numpy(raw).to(device), levels=CLASSIC_LEVELS, src_levels=65536)
    _sync(device)
    quant_s = time.perf_counter() - t0
    if not np.array_equal(x[:n_cpu].cpu().numpy(), (raw[:n_cpu] >> 6).astype(np.int32)):
        raise AssertionError("quantize_to_levels(1024) on the card differs from v >> 6")
    feats = tt.FeatureConfig(glcm=tt.GLCMConfig(levels=CLASSIC_LEVELS))
    cfg = tt.PipelineConfig(
        features=feats,
        head=tt.HeadConfig(kind="logistic", num_steps=300),
        split=tt.SplitConfig(test_size=0.25, seed=0, group_by="donor"),
        fast_path="auto",
        batch_size=BATCH,
    )
    if _fast_path_ok(cfg, x, mask):
        raise AssertionError("1024 levels should route to the classic path")

    def run(timer=None):
        out = tt.run_pipeline(x, labels, mask=mask, groups=donors, config=cfg, device=device, timer=timer)
        _sync(device)
        return out

    per_run = -(-n // BATCH) if n > 4096 else 1  # run_pipeline batches above 4096 objects
    launches, times, result = _timed_runs(run, timed_runs, "B1d", per_run)
    X = result.features.values
    F = CYTO_CH * 23
    if X.shape != (n, F) or not np.isfinite(np.nan_to_num(X)).all():
        raise AssertionError(f"feature matrix {X.shape} is not finite ({n}, {F})")
    train_donors = {str(d) for d in donors[result.train_idx]}
    test_donors = {str(d) for d in donors[result.test_idx]}
    if train_donors & test_donors or not test_donors:
        raise AssertionError(f"donor split leaks: train {train_donors}, test {test_donors}")
    total = np.asarray(result.channel_result.total)
    if int(np.argmax(total)) != CYTO_SIGNAL or not total[CYTO_SIGNAL] > 0:
        raise AssertionError(f"signal channel {CYTO_SIGNAL} not first: {total.tolist()}")
    if result.test_accuracy < 0.95:
        raise AssertionError(f"test accuracy {result.test_accuracy} < 0.95")
    cpu = tt.extract_features(x[:n_cpu].cpu(), mask[:n_cpu], device="cpu", config=feats)
    diff = float(np.nanmax(np.abs(X[:n_cpu] - cpu.values)))
    if not (np.array_equal(np.isnan(X[:n_cpu]), np.isnan(cpu.values)) and diff <= FEATURE_ATOL):
        raise AssertionError(f"card vs CPU features differ by {diff}")

    timer = StageTimer(device)
    run(timer)
    med = statistics.median(times)
    log(f"  {n} objects at {CLASSIC_LEVELS} levels (quantized on the card in {quant_s!r} s)")
    log(f"  runs (s): {times!r}")
    log(f"  median {med!r} s = {n / med!r} objects/s; B1d launches {launches} over {timed_runs} runs")
    log(f"  test_accuracy {result.test_accuracy!r}; test donors {sorted(test_donors)}; "
        f"channel totals {total.tolist()!r}")
    log(f"  card vs CPU on {n_cpu} objects: features max abs diff {diff!r}")
    log(f"  staged run (synchronised at each stage, s): {json.dumps(timer.totals)}")
    return launches, {
        "objects_per_s": n / med, "median_s": med, "runs_s": times, "b1d_launches": launches,
        "test_accuracy": result.test_accuracy, "stages_s": timer.totals,
        "channel_totals": total.tolist(), "card_vs_cpu": diff,
    }


def phase_classic_fields(device, timed_runs=3, n_check=8):
    """The reference notebook's workflow on 256x256 fields: noise channels
    synthesized on the card, features (hybrid, which is the f64 host
    backend at 65536 pixels), a logistic head and permutation importance
    through ``run_pipeline``; then an MLP head and ablation and coefficient
    importance on its feature matrix. Returns (B1d launches, record)."""
    import numpy as np

    import tpumcia_torch as tt
    from tpumcia_torch.importance.channels import channel_importance
    from tpumcia_torch.models.heads import fit_head
    from tpumcia_torch.utils.profiling import StageTimer

    gray, labels, fields = field_batch(device)
    cfg = tt.PipelineConfig(
        synth=tt.SynthConfig(noise_channels=2, seed=0),
        head=tt.HeadConfig(kind="logistic", num_steps=300),
        split=tt.SplitConfig(test_size=0.25, seed=0, stratify=True),
        fast_path="auto",
        batch_size=BATCH,
    )

    def run(timer=None):
        out = tt.run_pipeline(gray, labels, config=cfg, device=device, timer=timer)
        _sync(device)
        return out

    launches, times, result = _timed_runs(run, timed_runs, "B1d")
    X = result.features.values
    if X.shape != (len(gray), 69) or not np.isfinite(np.nan_to_num(X)).all():
        raise AssertionError(f"feature matrix {X.shape} is not finite (N, 69)")
    if result.test_accuracy < 0.90:
        raise AssertionError(f"test accuracy {result.test_accuracy} < 0.90")
    if not _signal_first(result):
        raise AssertionError(f"signal channel not ranked first: {result.channel_result.total}")

    # the card against the CPU on the run's own synthesized fields: the
    # exact backend, the same integers through the same float64 code
    x8 = fields[:n_check]
    card = tt.extract_features(x8, device=device)
    cpu = tt.extract_features(x8.cpu(), device="cpu")
    if not (np.array_equal(np.isnan(card.values), np.isnan(cpu.values))
            and np.array_equal(np.nan_to_num(card.values), np.nan_to_num(cpu.values))):
        raise AssertionError(f"card vs CPU features differ by {np.nanmax(np.abs(card.values - cpu.values))}")

    # the other heads and methods on this phase's feature matrix
    Xf = np.nan_to_num(X.astype(np.float32))
    tr, te = result.train_idx, result.test_idx
    t0 = time.perf_counter()
    mlp = fit_head(Xf[tr], labels[tr], device=device, config=tt.HeadConfig(kind="mlp", num_steps=300))
    mlp_fit_s = time.perf_counter() - t0
    mlp_acc = mlp.score(Xf[te], labels[te])
    fm_test = tt.FeatureMatrix(values=Xf[te], names=result.features.names, num_channels=3)
    mlp_perm = channel_importance(mlp, fm_test, labels[te], method="permutation")
    ablation = channel_importance(result.head, fm_test, labels[te], method="ablation")
    coef = channel_importance(result.head, fm_test, labels[te], method="coef")
    if mlp_acc < 0.90 or int(mlp_perm.ranking[0]) != 0:
        raise AssertionError(f"MLP head: accuracy {mlp_acc}, permutation totals {mlp_perm.total}")
    if not (np.isfinite(ablation.total).all() and np.isfinite(coef.total).all()):
        raise AssertionError(f"ablation {ablation.total} / coef {coef.total} not finite")

    timer = StageTimer(device)
    run(timer)
    med = statistics.median(times)
    log(f"  runs (s): {times!r}")
    log(f"  median {med!r} s = {len(gray) / med!r} fields/s over {len(gray)} {FIELD_HW}x{FIELD_HW} "
        f"fields; B1d launches {launches} over {timed_runs} runs")
    log(f"  test_accuracy {result.test_accuracy!r}; channel totals {result.channel_result.total.tolist()!r}")
    log(f"  card == CPU on {n_check} fields (exact backend)")
    log(f"  MLP head: fit {mlp_fit_s!r} s, accuracy {mlp_acc!r}, permutation totals {mlp_perm.total.tolist()!r}")
    log(f"  ablation totals {ablation.total.tolist()!r}; coef totals {coef.total.tolist()!r}")
    log(f"  staged run (synchronised at each stage, s): {json.dumps(timer.totals)}")
    return launches, {
        "fields_per_s": len(gray) / med, "median_s": med, "runs_s": times, "b1d_launches": launches,
        "test_accuracy": result.test_accuracy, "stages_s": timer.totals,
        "mlp_accuracy": mlp_acc, "mlp_fit_s": mlp_fit_s,
        "ablation_totals": ablation.total.tolist(), "coef_totals": coef.total.tolist(),
    }


def _tree_stats(head) -> dict:
    """The forest's size and which inference form its DeviceForest runs."""
    import numpy as np

    nodes = [t.node_count for t in head.trees]
    return {"trees": len(nodes), "nodes_mean": float(np.mean(nodes)), "nodes_max": int(max(nodes)),
            "depth_max": int(max(t.max_depth for t in head.trees)), "form": head.to_device().form}


def _forest_forms(head, X, reps=5) -> dict:
    """Both inference forms of ``head``'s forest on the scaled rows ``X``:
    equal to FOREST_PROBA_ATOL (the lock-step form run directly where the
    GEMM form is the forest's), and each one's median seconds."""
    import torch

    f = head.to_device()
    x = head.scaler.transform(torch.as_tensor(X, dtype=torch.float32, device=f.device))
    out, secs = {}, {}
    for form in ("gemm", "lockstep") if f.gemm is not None else ("lockstep",):
        runs = []
        for _ in range(reps):
            _sync(f.device)
            t0 = time.perf_counter()
            out[form] = f.apply(x, form=form)
            _sync(f.device)
            runs.append(time.perf_counter() - t0)
        secs[form] = statistics.median(runs)
    if "gemm" in out:
        diff = (out["gemm"] - out["lockstep"]).abs().max().item()
        if not diff <= FOREST_PROBA_ATOL:
            raise AssertionError(f"GEMM and lock-step probabilities differ by {diff}")
        secs["gemm_vs_lockstep"] = diff
    return secs


def phase_forest(device, n_images=N_IMAGES, timed_runs=3):
    """BASELINE config 2 with the random-forest head (ipynb:404-434, 495):
    the bench workload on the classic path, the forest grown on the card.
    Returns (B1a launches, record)."""
    import numpy as np
    import torch

    import tpumcia_torch as tt
    from tpumcia_torch.io.synthetic import synthetic_mednist
    from tpumcia_torch.models.heads import fit_head
    from tpumcia_torch.pipeline.run import _fast_path_ok
    from tpumcia_torch.utils.profiling import StageTimer

    gray, labels, _ = synthetic_mednist(n_images // 6, num_classes=6, seed=0)
    cfg = dataclasses.replace(
        _slice_config(), head=tt.HeadConfig(kind="random_forest", n_estimators=100, max_depth=None, seed=0),
        fast_path="auto",
    )
    if _fast_path_ok(cfg, gray, None):
        raise AssertionError("the forest head should route to the classic path")

    def run(timer=None):
        out = tt.run_pipeline(gray, labels, config=cfg, device=device, timer=timer)
        _sync(device)
        return out

    launches, times, result = _timed_runs(run, timed_runs, "B1a", -(-len(gray) // BATCH))
    X = result.features.values
    if X.shape != (len(gray), 69) or not np.isfinite(np.nan_to_num(X)).all():
        raise AssertionError(f"feature matrix {X.shape} is not finite (N, 69)")
    if result.feature_result.method != "mdi" or result.channel_result.method != "permutation":
        raise AssertionError(f"views {result.channel_result.method} / {result.feature_result.method}")
    if not _signal_first(result):
        raise AssertionError(f"signal channel not first: permutation {result.channel_result.total}, "
                             f"MDI {result.feature_result.total}")
    if result.test_accuracy < 0.90:
        raise AssertionError(f"test accuracy {result.test_accuracy} < 0.90")
    head = result.head
    t0 = time.perf_counter()
    mdi = head.mdi_importance()
    mdi_s = time.perf_counter() - t0
    if not (np.isfinite(mdi).all() and (mdi >= 0).all() and abs(mdi.sum() - 1.0) < 1e-9):
        raise AssertionError(f"MDI not a distribution: sum {mdi.sum()}, min {mdi.min()}")
    trees = _tree_stats(head)
    Xf = np.nan_to_num(X.astype(np.float32))
    tr, te = result.train_idx, result.test_idx
    forms = _forest_forms(head, Xf[te])

    # a small forest grown on the card and on the CPU from one seed
    n, T = FOREST_SMALL
    small = tt.HeadConfig(kind="random_forest", n_estimators=T, seed=0)
    card = fit_head(Xf[tr[:n]], labels[tr[:n]], device=device, config=small)
    cpu = fit_head(Xf[tr[:n]], labels[tr[:n]], device="cpu", config=small)
    for a, b in zip(card.trees, cpu.trees):
        for name in ("children_left", "children_right", "feature", "threshold", "value", "impurity",
                     "n_node_samples", "weighted_n_node_samples"):
            if not np.array_equal(getattr(a, name), getattr(b, name)):
                raise AssertionError(f"forest on the card differs from the CPU's in {name}")
    small_acc = (card.score(Xf[te], labels[te]), cpu.score(Xf[te], labels[te]))

    timer = StageTimer(device)
    staged = run(timer)
    med = statistics.median(times)
    log(f"  runs (s): {times!r}")
    log(f"  median {med!r} s = {len(gray) / med!r} img/s over {len(gray)} images; B1a launches {launches}")
    log(f"  test_accuracy {result.test_accuracy!r}; permutation totals {result.channel_result.total.tolist()!r}; "
        f"MDI totals {result.feature_result.total.tolist()!r}")
    log(f"  forest: {json.dumps(trees)}; MDI {mdi_s!r} s on the host")
    log(f"  inference on the {len(te)} test rows (s): {json.dumps(forms)}")
    log(f"  {T} trees on {n} rows: card == CPU bit for bit; accuracy card {small_acc[0]!r}, CPU {small_acc[1]!r}")
    log(f"  staged run (synchronised at each stage, s): {json.dumps(timer.totals)}; "
        f"timings {json.dumps(staged.timings)}")
    return launches, {
        "img_per_s": len(gray) / med, "median_s": med, "runs_s": times,
        "test_accuracy": result.test_accuracy, "stages_s": timer.totals, "timings_s": staged.timings,
        "mdi_s": mdi_s, "forest": trees, "inference_s": forms,
        "small_forest_accuracy": {"card": small_acc[0], "cpu": small_acc[1]},
        "permutation_totals": result.channel_result.total.tolist(),
        "mdi_totals": result.feature_result.total.tolist(),
    }


def phase_cytometry_morphology(device, data, timed_runs=3, n_cpu=64):
    """Phase 5's objects with morphology, the forest head and MDI on the
    classic path; the A9 functions on the card against the CPU. Returns
    (B1b launches, record)."""
    import numpy as np
    import torch

    import tpumcia_torch as tt
    from tpumcia_torch.features.intensity_direct import intensity_features_direct
    from tpumcia_torch.utils.profiling import StageTimer

    (raw, mask, labels, donors), _ = data
    n = len(raw)
    x = tt.quantize_to_levels(torch.from_numpy(raw).to(device), levels=LEVELS, src_levels=65536)
    feats = tt.FeatureConfig(include_morphology=True)
    cfg = tt.PipelineConfig(
        features=feats,
        head=tt.HeadConfig(kind="random_forest", n_estimators=100, seed=0),
        importance=tt.ImportanceConfig(channel_method="auto"),
        split=tt.SplitConfig(test_size=0.25, seed=0, group_by="donor"),
        fast_path="auto",
        batch_size=BATCH,
    )

    def run(timer=None):
        out = tt.run_pipeline(x, labels, mask=mask, groups=donors, config=cfg, device=device, timer=timer)
        _sync(device)
        return out

    launches, times, result = _timed_runs(run, timed_runs, "B1b", -(-n // BATCH))
    X = result.features.values
    F = CYTO_CH * (23 + 8)
    if X.shape != (n, F) or not np.isfinite(np.nan_to_num(X)).all():
        raise AssertionError(f"feature matrix {X.shape} is not finite ({n}, {F})")
    train_donors = {str(d) for d in donors[result.train_idx]}
    test_donors = {str(d) for d in donors[result.test_idx]}
    if train_donors & test_donors or not test_donors:
        raise AssertionError(f"donor split leaks: train {train_donors}, test {test_donors}")
    total = np.asarray(result.channel_result.total)
    if result.channel_result.method != "mdi" or int(np.argmax(total)) != CYTO_SIGNAL:
        raise AssertionError(f"{result.channel_result.method}: signal channel {CYTO_SIGNAL} not first: "
                             f"{total.tolist()}")
    if result.test_accuracy < 0.95:
        raise AssertionError(f"test accuracy {result.test_accuracy} < 0.95")

    # the morphology block: every channel's is the shared mask's, and the
    # card's equals the CPU's
    own = tt.morphology_features(mask[:n_cpu], device=device).cpu().numpy()[:, 0]
    for cols in result.features.channel_columns():
        if not np.array_equal(X[:n_cpu, cols[-8:]], own.astype(np.float64)):
            raise AssertionError("a channel's morphology is not the shared mask's")
    cpu = tt.extract_features(x[:n_cpu].cpu(), mask[:n_cpu], device="cpu", config=feats)
    morph = slice(CYTO_CH * 23, None)
    if not np.allclose(X[:n_cpu, morph], cpu.values[:, morph], rtol=1e-5, atol=1e-6):
        raise AssertionError(f"morphology card vs CPU: {np.abs(X[:n_cpu, morph] - cpu.values[:, morph]).max()}")
    feat_diff = float(np.nanmax(np.abs(X[:n_cpu] - cpu.values)))
    if not feat_diff <= FEATURE_ATOL:
        raise AssertionError(f"card vs CPU features differ by {feat_diff}")
    # the matrix API and the direct intensity features on a few objects
    few = x[:4].cpu().numpy()
    g_card = tt.glcm_matrix(x[:4], mask[:4], device=device, distances=[1, 5], angles=[0.0, np.pi / 2])
    g_cpu = tt.glcm_matrix(few, mask[:4], device="cpu", distances=[1, 5], angles=[0.0, np.pi / 2])
    if not torch.equal(g_card.cpu(), g_cpu):
        raise AssertionError("glcm_matrix on the card differs from the CPU")
    props = tt.glcm_properties(g_card.movedim(-1, 0).movedim(-1, 0), device=device)
    props_cpu = tt.glcm_properties(g_cpu.movedim(-1, 0).movedim(-1, 0), device="cpu")
    for name, v in props.items():
        torch.testing.assert_close(v.cpu(), props_cpu[name], rtol=1e-6, atol=1e-6)
    d_card = intensity_features_direct(raw[:8], mask[:8], device=device).cpu()
    d_cpu = intensity_features_direct(raw[:8], mask[:8], device="cpu")
    torch.testing.assert_close(d_card, d_cpu, rtol=1e-6, atol=1e-6 * float(d_cpu.abs().max()), equal_nan=True)

    head = result.head
    t0 = time.perf_counter()
    head.mdi_importance()
    mdi_s = time.perf_counter() - t0
    trees = _tree_stats(head)
    timer = StageTimer(device)
    staged = run(timer)
    med = statistics.median(times)
    log(f"  runs (s): {times!r}")
    log(f"  median {med!r} s = {n / med!r} objects/s over {n} objects, {F} columns; B1b launches {launches}")
    log(f"  test_accuracy {result.test_accuracy!r}; test donors {sorted(test_donors)}; "
        f"MDI channel totals {total.tolist()!r}")
    log(f"  forest: {json.dumps(trees)}; MDI {mdi_s!r} s on the host")
    log(f"  card vs CPU on {n_cpu} objects: features {feat_diff!r}, morphology rel 1e-5; glcm_matrix "
        "bit-equal, properties and direct intensity features to 1e-6")
    log(f"  staged run (synchronised at each stage, s): {json.dumps(timer.totals)}; "
        f"timings {json.dumps(staged.timings)}")
    return launches, {
        "objects_per_s": n / med, "median_s": med, "runs_s": times, "b1b_launches": launches,
        "test_accuracy": result.test_accuracy, "stages_s": timer.totals, "timings_s": staged.timings,
        "mdi_s": mdi_s, "forest": trees, "channel_totals": total.tolist(), "card_vs_cpu": feat_diff,
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU port only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import tpumcia_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: tpumcia_torch not found next to this script ({e})", file=sys.stderr)
        return 1
    if any(m in sys.modules for m in ("jax", "tpumcia", "sklearn")):
        print("chip_smoke: importing tpumcia_torch pulled in jax/tpumcia/sklearn", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)

    log("== environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        print(f"chip_smoke: nvidia-smi failed: {smi.stderr.strip()}", file=sys.stderr)
        return 1
    gpu_line = smi.stdout.strip().splitlines()[0]
    log(f"  {gpu_line}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    log("== build")
    from tpumcia_torch import _build

    lib_path, build_s = _build.build_library()
    _build.load_library()
    log(f"  {lib_path.name}: {build_s!r} s to build")
    log_path = _build.BUILD_DIR / "build.log"
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                log("  " + line.strip())

    log("== kernel vs plain")
    kernels = phase_kernel(device)

    log("== slice")
    launches, slice_rec = phase_slice(device)
    kernels["B1a"]["launches"] = launches
    phase_reference(device)

    log("== cytometry slice")
    t0 = time.perf_counter()
    cyto = cytometry_objects(CYTO_N), time.perf_counter() - t0
    launches, cyto_rec = phase_cytometry(device, cyto)
    kernels["B1b"]["launches"] = launches

    log("== extract_features")
    launches, extract_rec = phase_extract(device)
    kernels["B1c"]["launches"] = launches["B1c"]
    kernels["B2"]["launches"] = launches["B2"]

    log("== classic slice at 1024 levels (B1d)")
    levels_launches, classic_1024 = phase_classic_levels(device, cyto)

    log("== classic slice on 256x256 fields (B1d)")
    fields_launches, classic_256px = phase_classic_fields(device)
    kernels["B1d"]["launches"] = levels_launches + fields_launches

    log("== the notebook's forest slice (random forest, MDI)")
    launches, forest_rec = phase_forest(device)
    kernels["B1a"]["launches"] += launches

    log("== cytometry with morphology (random forest, MDI)")
    launches, cyto_morph_rec = phase_cytometry_morphology(device, cyto)
    kernels["B1b"]["launches"] += launches
    del cyto

    print(gpu_line, flush=True)
    print(json.dumps({
        "kernels": [{"form": form, **kernels[form]} for form in FORMS],
        "slice": slice_rec, "cytometry": cyto_rec, "extract_features": extract_rec,
        "classic_1024": classic_1024, "classic_256px": classic_256px,
        "forest": forest_rec, "cytometry_morphology": cyto_morph_rec,
    }), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
