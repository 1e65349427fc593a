"""Smoke run of tpumcia_torch on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py

Phases (any failure exits nonzero, and no result line is printed):
  1. environment: a CUDA device must be present; prints the card's name and
     power limit (nvidia-smi) and the torch / CUDA versions;
  2. build: compiles the CUDA kernels from the sources in this checkout;
  3. kernel vs plain: each form of the GLCM statistics kernel (B1a
     maskless, B1b masked, B1c difference histogram, B2 several offsets, B1d
     at 65536 pixels or more than 256 levels, B1e past 4096 levels: 8192,
     16384 and 32768 levels, masked and maskless, one and four offsets, a
     constant channel, an empty and a one-pixel mask, 37x53, levels at the
     edges of its level bands at 5001, 20011 and 32768 levels, and a pair
     table too large for shared memory) against its plain PyTorch
     version at the main paths' shapes and at edge cases (integer fields
     bit-equal, dstats[3] to rel 1e-6), both versions' median times, and per
     main-path shape the bytes it must move, its bound at the card's memory
     rate, its layout, dynamic shared memory and resident blocks per SM
     (gated: >= 3 at the bench and cytometry shapes and at 8192 levels, >= 2
     at 1024 levels; B1e at 48x48 and 64x64 with no workspace);
  4. the slice: ``run_pipeline`` over 12,000 synthetic 64x64 images with 2
     synthesized noise channels, a 300-step logistic head and permutation
     importance, as bench.py drives the JAX package (the images, config
     and gates are bench_torch.py's). It checks the launch
     count, the accuracy and the channel ranking, times untimed runs (img/s)
     and one staged run, and checks a small run's features against the same
     run on the CPU with the plain version;
  5. the cytometry slice (BASELINE config 4): ``run_pipeline`` over 16,384
     masked 12-channel 48x48 uint16 objects quantized to 256 levels on the
     card, donor-grouped split (bench_torch.py's objects, config and
     gates); checks launches, donors, accuracy and the signal channel,
     times it like phase 4;
  6. extract_features: the exact, masked hybrid and 4-offset hybrid forms
     of the public extraction on the card, against each other and against
     the same calls on the CPU; then what lies past the kernel's argument
     and bounds: 20 offsets (two launches of the multi-offset form,
     bit-equal to the plain version and timed beside it with their bytes
     and bound; the 20-block wire against the CPU), 8192 levels (one B1e
     launch, features within 1e-5 of the CPU), and the refusals on the card
     (``use_pallas='never'`` and 2^24 pixels raise and launch nothing: no
     plain version runs there);
  7. the classic slice at 1024 levels (B1d): the cytometry objects of phase
     5 quantized to 1024 levels on the card, ``run_pipeline`` with
     fast_path='auto', which routes them to the classic path (packed f32
     wire, logistic head, both permutation views); checks launches, donors,
     accuracy, the signal channel and a card-vs-CPU feature check, times it;
     then the same path at 8192 levels (B1e): 8,192 of those objects at
     ``v >> 3`` in batches of 1,024 (2.0 GB of statistics a batch), the same
     gates, 8 B1e launches per run, with the peak device memory;
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
     forest's inference of the test rows against its plain version, and a
     small forest grown on the card and on the CPU from one seed (bit-equal
     trees); the walk kernel at ``forest_mdi``'s sweep (the test rows'
     baseline and 690 draws, 69 columns x 10 repeats) through
     ``permutation_importance``, its launches and lanes counted on that
     call alone, and its (draw, row) shares against its plain version, both
     timed by CUDA events; times the slice (objects/s) and one staged run;
 10. cytometry with morphology: phase 5's objects with
     ``include_morphology=True`` (12 x (23 + 8) columns, the classic path),
     the forest head and MDI (``channel_method='auto'``); checks launches,
     donors, accuracy, the signal channel, the morphology block against the
     CPU and against the shared mask's own values, and ``glcm_matrix`` and
     ``intensity_features_direct`` on the card against the CPU; times it;
 11. ``analyze_objects``: the native packer and quantizer (built with g++
     from native/packer.cpp) against their numpy paths on 2,048
     variable-size crops; then phase 5's uint16 objects as an in-memory
     ``ObjectBatch`` (string labels and donors, channel names, the shared
     mask) through ``analyze_objects``, quantized on the card: launches,
     donors, accuracy, the signal channel, the ranking and accuracy of phase
     5; times it (objects/s) and the share of upload + quantization;
 12. streaming (BASELINE config 5): ``stream_extract`` over 131,072 masked
     12-channel 48x48 objects in 64 shards of 2,048 served from phase 5's
     256-level objects: shard and launch counts, repeated objects bit-equal
     across shards, shard 0 bit-equal to ``extract_features`` on the card,
     the peak device memory's rise under 4 GB, staged against unstaged
     uploads, resume (nothing recomputed; then exactly the shards whose
     file or manifest record is gone, a torn manifest line among them),
     objects/s over fresh directories with the ingest wait / device / save
     profile, the same collection through ``extract_features_batched``
     from a host array (``in_flight=8``) with its peak memory, and a
     maskless 3-channel run (form B1a);
 13. the CNN path (BASELINE config 3 at full width): the bench workload's
     12,000 images with 2 noise channels synthesized on the card through
     ``run_cnn_pipeline`` (ResNet-18, width 64, batch 256, 8 epochs, bf16
     autocast): test accuracy, the signal channel first by occlusion and by
     image permutation, ``occlusion_map`` on 16 test images, the float32
     model on the card against the same weights on the CPU (TF32 off), the
     bf16 model's argmax against the float32 model's, trained and occluded
     images/s, peak device memory, and a batch-size sweep (2 epochs each at
     batch 64 to 1024). It launches no GLCM kernel: its convolutions are
     cuDNN's, as they are XLA's in the JAX package;
 14. the ``eval`` CLI in process (``tpumcia_torch.eval.main``, the synthetic
     source, 200 images a class): returns 0, both metrics events, channel 0
     first, the kernel launched;
 15. mesh (ROADMAP A14's feature half): (a) ``run_pipeline`` on phase 5's
     objects with ``mesh.data=2`` over two slots on the card in one process
     (2 B1b launches a run; then 4 offsets, 2 B2, and 'exact' on 4,096 of
     them, 2 B1c), the
     sharded statistics bit-equal to one unsharded call, features against
     the CPU's sharded run, donors, accuracy, the signal channel, objects/s
     beside the one-slot classic run's; (b) two processes on the card over
     gloo and (c) one NCCL rank with two slots (NCCL takes one rank per
     card), each running ``python -m tpumcia_torch.parallel.dryrun`` on
     4,096 objects, started together, and held against the same calls made
     here on one slot (statistics, scaler, both sweeps, ``run_pipeline``,
     both stream directories), each rank's own B1b launch, within 180 s;
 16. the CNN path over a mesh (ROADMAP A14b): (a) ``run_cnn_pipeline`` on
     phase 13's workload over two slots on the card in one process, phase
     13's gates, trained and occluded images/s beside phase 13's; (a')
     float32 parity at full width, 3 steps of one slot against two on the
     same weights (TF32 off, cuDNN deterministic): the two-slot gradient
     within twice the one-slot gradient's distance from a float64 copy's,
     losses rel 1e-4; (b) two gloo ranks and (c) one NCCL
     rank with two slots of ``python -m tpumcia_torch.parallel.dryrun --mode
     cnn --size full``, each rank's loss history, weights, logits and probe
     drops equal to each other and to the same run here, bit for bit;
 17. the examples: ``python -m tpumcia_torch.examples.<name>`` for
     cnn_workflow, notebook_workflow (no figures: no matplotlib here),
     streaming_scale and multihost_pipeline at their default sizes, each
     exiting 0 (cytometry_h5 needs h5py, which is not installed here);
 18. tpumcia's API on the card (run after phase 15, on phase 5's objects):
     (a) the stats-level ``features.stats.sufficient_stats`` on 2,048 of
     them with no ``device=`` (one B1c launch), bit-equal to a direct
     ``cuda_glcm`` launch and on 64 objects to the CPU plain version, its
     ``with_intensity`` / ``with_glcm`` switches, ``sufficient_stats_multi``
     at 4 offsets (one B2), both calls' median ms; (b)
     ``sufficient_stats_sharded`` with tpumcia's keywords over two slots on
     the card, bit-equal to (a); (c) ``extract_features`` (hybrid, exact)
     and ``run_pipeline(images, labels, config=cfg)`` without ``device=``
     on 64 bench images, against the port's copy of the notebook oracle at
     the golden tolerances (hybrid < 1e-5 max / 1e-6 MAE, exact < 1e-9);
 19. the bench: ``bench_torch.py --cell all --reps 2`` in a process of its
     own (both cells, MedNIST fused and cytometry masked, through
     ``run_pipeline`` as tpumcia's bench calls it): exit 0, each line
     correct by its own gates, every metric present and finite, both
     roofline shares in (0, 1.05];
 20. prints the kernels' JSON line and, last, the device JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
TWENTY_OFFSETS = tuple(  # 5 distances x 4 angles: past the kernel's 16-offset argument
    (round(d * s), round(d * c)) for d in (1, 2, 3, 4, 5)
    for s, c in ((0.0, 1.0), (0.70710678, 0.70710678), (1.0, 0.0), (0.70710678, -0.70710678)))
HUGE_LEVELS = 8192  # past 4096 levels: form B1e (16-bit data kept at 13 bits)
HUGE_N, HUGE_BATCH = 8192, 1024  # the 8192-level classic run: 2.0 GB of statistics a batch
CNN_BATCHES = (64, 128, 256, 512, 1024)  # phase 13's batch-size sweep
CNN_REPEATS = 5  # image-permutation repeats of phases 13 and 16
CNN_GRAD_F64_RATIO = 2.0  # phase 16 (a'): two slots' distance from float64 over one slot's
CNN_LOSS_RTOL = 1e-4  # phase 16 (a'): the batch's loss
CNN_PARITY_STEPS = 3
CNN_MESH_SIZE = "full"  # phase 16 (b), (c): dryrun's CNN size (2,048 64x64 images, ResNet-18, width 64)
EXAMPLES = ("cnn_workflow", "notebook_workflow", "streaming_scale", "multihost_pipeline")
EXAMPLES_LEFT_OUT = {"cytometry_h5": "writes h5 objects and needs h5py, which is not installed beside the card "
                                     "(the CPU tests run it)"}
EXAMPLE_TIMEOUT_S = 300
STREAM_N, STREAM_SHARD = 131_072, 2048  # phase 12: 64 shards
STREAM_PEAK_BYTES = 4e9  # the most the peak device memory may rise over a streaming run
STREAM_MASKLESS_N = 32_768  # 16 maskless shards
MESH_RANK_N = 4096  # phase 15 (b), (c): each dryrun rank's objects
MESH_EXACT_N = 4096  # phase 15 (a): the 'exact' run's objects
MESH_RANK_TIMEOUT_S = 180  # a rank that runs longer fails the phase
# phase 15's process runs: name, ranks, backend, slots a rank (NCCL takes one rank per card)
MESH_RUNS = (("gloo_2_ranks", 2, "gloo", 1), ("nccl_1_rank", 1, "nccl", 2))
PACK_N = 2048  # phase 11: variable-size crops through the native packer
API_N = 2048  # phase 18 (a), (b): phase 5's objects through the stats-level call
BENCH_REPS = 2  # phase 19: bench_torch.py --cell all --reps 2
BENCH_TIMEOUT_S = 600
# feature columns that read an f32 wire word (sums in another order on the card and on the CPU)
FLOAT_DERIVED = ("std_intensity", "kurtosis_intensity", "skew_intensity", "shannon_entropy", "homogeneity")
FOREST_SMALL = (600, 10)  # phase 9's card-vs-CPU forest: rows, trees
FOREST_SOURCE = "tpumcia_torch/csrc/forest_apply.cu"
SOURCE = "tpumcia_torch/csrc/glcm_stats.cu"
# each kernel form and the TPU kernel it replaces
FORMS = {
    "B1a": ("glcm_stats maskless", "tpumcia/features/pallas_glcm.py:400"),
    "B1b": ("glcm_stats masked", "tpumcia/features/pallas_glcm.py:400"),
    "B1c": ("glcm_stats need_diff", "tpumcia/features/pallas_glcm.py:400"),
    "B2": ("glcm_stats multi-offset", "tpumcia/features/pallas_glcm.py:878"),
    "B1d": ("glcm_stats_large (u64 pair table or u32 G in bands; also replaces :878 at these sizes)",
            "tpumcia/features/pallas_glcm.py:400"),
    "B1e": ("glcm_stats_level_bands (past 4096 levels: per-level tables in shared-memory level bands, "
            "each output word written once; also replaces :878 at these sizes)",
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

    from bench_torch import cytometry_objects

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
    # B1e: the main path's batch first (one 1024-object batch of the
    # 8192-level classic run: cytometry levels at v >> 3 with the cell mask,
    # 2.0 GB of outputs), then a 2048-object batch (4.0 GB), and 8x1x64x64
    # at 32768 levels
    raw, cell, _, _ = cytometry_objects(BENCH_SHAPE[0], seed=3)
    huge = dev((raw.astype(np.int32) >> 3).transpose(0, 3, 1, 2))
    del raw
    yield item("B1e", huge[:HUGE_BATCH].contiguous(), mask=cell[:HUGE_BATCH], need_diff=True,
               levels=HUGE_LEVELS, note="cytometry levels", per_run=HUGE_N // HUGE_BATCH, min_blocks=3)
    yield item("B1e", huge, mask=cell, need_diff=True, levels=HUGE_LEVELS, note="cytometry levels",
               min_blocks=3)
    del huge
    yield item("B1e", rand((8, 1, 64, 64), 32768), need_diff=True, levels=32768)


def timed_label(shape, offsets, mask, levels, note) -> str:
    """How the kernels line and kernel_ab.py name a timed case."""
    return ("x".join(map(str, shape)) + f" L{levels} offsets {list(offsets)}"
            + (" masked" if mask is not None else "") + (f", {note}" if note else ""))


def band_edge_planes(levels, band_levels, n, hw=64, seed=0):
    """(n, 1, hw, hw) int32 levels that put form B1e's level bands
    (``band_levels`` a pass, as ``launch_info`` reports it) to the test at
    offset (0, 1): random levels under a first pixel at L - 1, so that each
    channel's max is L - 1 and a raw level v rescales to int(v / (L - 1) *
    (L - 1)); then, in horizontal pairs from the second row on, pairs at the
    first and last level of each band of the marginals and the difference
    histogram (laid end to end as the kernel's passes take them), the
    differences +-(L - 1), and raw levels at the edges of the histogram's
    bands, 0 and L - 1."""
    import numpy as np

    top = levels - 1

    def raw(t):  # a raw level that rescales to t, if there is one
        return next((v for v in (t, t + 1, t + 2) if v <= top and int(v / top * top) == t), None)

    pairs = [(top, 0), (0, top)]
    flat = [0, top]
    for k in range(1, -(-levels // band_levels)):
        flat += [k * band_levels - 1, k * band_levels]
    for k in range(1, -(-(4 * levels - 1) // band_levels)):
        for e in (k * band_levels - 1, k * band_levels):
            if e < levels:
                pairs.append((e, 0))  # the left marginal's level e
            elif e < 2 * levels:
                pairs.append((0, e - levels))  # the right marginal's
            else:
                d = e - 2 * levels - top  # the difference histogram's difference d
                pairs.append((d, 0) if d >= 0 else (0, -d))
    for i, j in pairs:
        if raw(i) is not None and raw(j) is not None:
            flat += [raw(i), raw(j)]
    x = np.random.default_rng(seed).integers(0, levels, size=(n, 1, hw, hw), dtype=np.int32)
    x[:, 0, 0, 0] = top
    x.reshape(n, -1)[:, hw:hw + len(flat)] = flat
    return x


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

    # B1e, past 4096 levels: 8x1x64x64 random levels with an all-zero, a
    # constant and a top-level channel at 8192, 16384 and 32768 levels,
    # maskless and with a mask that is empty, one pixel and full in turn,
    # one and four offsets (8 items: several blocks share each); 37x53
    # (scalar loads) at a level count no power of two divides; levels at the
    # edges of the level bands and differences of +-(L - 1) at 5001, 20011
    # (rows of 2L - 1 floats that no 16 bytes align) and 32768 levels; more
    # items than the persistent grid has blocks; and 128x128, whose pair
    # table (32,768 slots, 256 KB) lives in the workspace
    b1e_mask = rng.random((8, 64, 64)) < 0.8
    b1e_mask[0] = False
    b1e_mask[1] = False
    b1e_mask[1, 30, 31] = True
    b1e_mask[2] = True
    for levels in (HUGE_LEVELS, 16384, 32768):
        fill = {(3, 0): 0, (4, 0): levels - 1, (5, 0): levels // 3}
        for offsets in ([OFFSET], list(FOUR_OFFSETS)):
            for mask in (None, b1e_mask):
                case((8, 1, 64, 64), offsets, fill=fill, mask=mask, need_diff=True, levels=levels)
    case((3, 2, 37, 53), [(1, 2), (-2, 1)], mask=rng.random((3, 37, 53)) < 0.7, need_diff=True, levels=5001)
    for levels in (5001, 20011, 32768):
        info = cuda_glcm.launch_info((8, 1, 64, 64), levels, [(0, 1)], masked=False, need_diff=True)
        if info["workspace_bytes"] or info["parts"] < 2:
            raise AssertionError(f"8x1x64x64 at {levels} levels: {info}, want no workspace, several parts")
        edges = band_edge_planes(levels, info["band_levels"], 8)
        case(edges.shape, [(0, 1)], x=edges, need_diff=True, levels=levels)
        case(edges.shape, [(0, 1), (1, 0)], x=edges.copy(), mask=b1e_mask, need_diff=True, levels=levels)
    case((700, 2, 16, 16), [(0, 1)], need_diff=True, levels=HUGE_LEVELS)
    if cuda_glcm.launch_info((2, 2, 128, 128), HUGE_LEVELS, [(0, 1)], masked=False,
                             need_diff=True)["layout"] != "level bands, table in workspace":
        raise AssertionError("128x128 at 8192 levels: the pair table should not fit in shared memory")
    case((2, 2, 128, 128), [(0, 1), (3, -2)], need_diff=True, levels=HUGE_LEVELS)

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
        info = cuda_glcm.launch_info(tuple(t.shape), levels, offsets, masked=m is not None,
                                     need_diff=need_diff)
        # the bound counts each input and output once; what form B1e moves to
        # and from a workspace is stated beside it
        nbytes = cuda_glcm.traffic_bytes(tuple(t.shape), levels, offsets, need_diff=need_diff,
                                         mask_channels=0 if m is None else m.shape[1])
        bound = cuda_glcm.bound_ms(nbytes)
        ms = min(k1, k2)
        log(f"    {nbytes} bytes, bound {bound!r} ms at 3.35 TB/s, share {bound / ms!r}; layout "
            f"{info['layout']} ({info['table_slots']} slots), {info['threads']} threads, "
            f"{info['smem_bytes']} B dynamic shared memory, {info['blocks_per_sm']} blocks per SM, "
            f"plane in shared memory {info['plane_in_smem']}")
        if form == "B1e":
            ws_bytes = cuda_glcm.workspace_traffic_bytes(
                tuple(t.shape), levels, offsets, table_in_workspace=not info["table_in_smem"],
                plane_in_workspace=not info["plane_in_smem"])
            log(f"    {info['grid_blocks']} blocks, {info['parts']} per item, {info['band_levels']} levels "
                f"a band; workspace {info['workspace_bytes']} bytes allocated, its own traffic {ws_bytes} "
                f"bytes, bound with it {cuda_glcm.bound_ms(nbytes + ws_bytes)!r} ms")
            if t.shape[2] * t.shape[3] <= 64 * 64 and info["workspace_bytes"]:
                raise AssertionError(f"B1e at {tuple(t.shape)} allocates a workspace: {info}")
            info = {**info, "workspace_traffic_bytes": ws_bytes,
                    "bound_with_workspace_ms": cuda_glcm.bound_ms(nbytes + ws_bytes)}
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


def phase_slice(device, n_images=N_IMAGES, timed_runs=TIMED_RUNS):
    """The main path through the public entry; returns (launches, record)."""
    import torch

    import tpumcia_torch as tt
    from bench_torch import launches_per_run, mednist_config, mednist_failures, mednist_workload
    from tpumcia_torch.utils.profiling import StageTimer

    gray, labels = mednist_workload(n_images)  # the bench's own images, config and gates
    cfg = mednist_config()
    per_run = launches_per_run(len(gray), cfg.batch_size)

    def run():
        out = tt.run_pipeline(gray, labels, config=cfg, device=device)
        _sync(device)
        return out

    launches, times, result = _timed_runs(run, timed_runs, "B1a", per_run)

    fails = mednist_failures(result, len(gray))
    if fails:
        raise AssertionError("; ".join(fails))
    dv = result.features.device_values
    if tuple(dv.shape) != (len(gray), 69) or not bool(torch.isfinite(dv).all()):
        raise AssertionError("device feature block is not finite (N, 69)")

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
    from bench_torch import mednist_config, signal_first
    from tpumcia_torch.io.synthetic import synthetic_mednist

    gray, labels, _ = synthetic_mednist(n_images // 6, num_classes=6, seed=5)
    noise = np.random.default_rng(5).normal(0, 0.1, size=(*gray.shape, 2))
    images = np.concatenate(
        [gray[..., None], (np.clip(noise, 0, 1) * 255).astype(np.uint8)], axis=-1
    )
    cfg = dataclasses.replace(
        mednist_config(), batch_size=64, synth=tt.SynthConfig(noise_channels=0),
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
    if not (signal_first(card) and signal_first(cpu)):
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
    from bench_torch import cytometry_config, cytometry_failures, launches_per_run
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
    cfg = cytometry_config()  # the bench's own config and gates
    per_run = launches_per_run(n, cfg.batch_size)

    def run(timer=None):
        out = tt.run_pipeline(x, labels, mask=mask, groups=donors, config=cfg,
                              device=device, timer=timer)
        _sync(device)
        return out

    launches, times, result = _timed_runs(run, timed_runs, "B1b", per_run)

    fails = cytometry_failures(result, n, donors)
    if fails:
        raise AssertionError("; ".join(fails))
    test_donors = {str(d) for d in donors[result.test_idx]}
    total = np.asarray(result.channel_result.total)

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
        "ranking": result.channel_result.ranking.tolist(),
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


def _features_close(card, cpu, what):
    """Card vs CPU feature matrices: the same NaNs, the integer-derived
    columns bit-equal, every column within FEATURE_ATOL.
    Returns the max abs difference."""
    import numpy as np

    a, b = card.to_numpy().astype(np.float64), cpu.to_numpy().astype(np.float64)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        raise AssertionError(f"{what}: card {a.shape} vs CPU {b.shape}, or NaNs differ")
    exact = [i for i, name in enumerate(card.names) if not name.startswith(FLOAT_DERIVED)]
    a, b = np.nan_to_num(a), np.nan_to_num(b)
    if not np.array_equal(a[:, exact], b[:, exact]):
        raise AssertionError(f"{what}: integer-derived columns differ by {np.abs(a - b)[:, exact].max()}")
    if not np.allclose(a, b, rtol=0, atol=FEATURE_ATOL):
        raise AssertionError(f"{what}: card vs CPU features differ by {np.abs(a - b).max()}")
    return float(np.abs(a - b).max())


def _raises_value_error(call, what):
    """Raise unless ``call`` raises a ValueError; returns its text."""
    try:
        call()
    except ValueError as e:
        return str(e)
    raise AssertionError(f"{what} did not raise on the card")


def phase_faults(device, n=BENCH_SHAPE[0], n_cpu=64):
    """What lies past the kernel's argument and bounds. 20 offsets: two
    launches of the multi-offset form, bit-equal to the plain version and
    timed beside it, and the 20-block wire of ``extract_features`` against
    the CPU. HUGE_LEVELS levels launch form B1e once and match the CPU.
    ``use_pallas='never'`` and 2^24 pixels must raise on the card and launch
    nothing. Returns ({form: launches}, record): the launches
    are those counted over the ``extract_features`` call (the wrapper's own
    call is a comparison with the plain version; its count is in the
    record)."""
    import numpy as np
    import torch

    import tpumcia_torch as tt
    from tpumcia_torch.features import cuda_glcm

    rng = np.random.default_rng(6)
    offsets = list(TWENTY_OFFSETS)
    glcm20 = tt.GLCMConfig(distance=(1, 2, 3, 4, 5), angle=(0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4))
    if [tuple(o) for o in glcm20.offsets] != offsets or len(offsets) != 20:
        raise AssertionError(f"5 distances x 4 angles give offsets {glcm20.offsets}")
    x = torch.from_numpy(rng.integers(0, LEVELS, size=(n, 3, 64, 64), dtype=np.int32)).to(device)
    cuda_glcm.reset_launch_counts()
    got = cuda_glcm.sufficient_stats_multi(x, levels=LEVELS, offsets=offsets)
    wrapper_launches = dict(cuda_glcm.LAUNCHES_BY_FORM)
    if wrapper_launches["B2"] != 2 or cuda_glcm.LAUNCHES != 2:
        raise AssertionError(f"20 offsets launched {wrapper_launches}, want B2 twice")
    want = cuda_glcm.sufficient_stats_multi_reference(x, levels=LEVELS, offsets=offsets)
    _sync(device)
    err20 = max(_stats_error(g, w) for g, w in zip(got, want))
    del want
    # the second launch recomputes the shared fields: they must be the first's
    second = cuda_glcm.sufficient_stats_multi(x, levels=LEVELS, offsets=offsets[cuda_glcm.MAX_OFFSETS:])
    for name in ("hist", "count", "vmax"):
        if not torch.equal(getattr(second[0], name), getattr(got[0], name)):
            raise AssertionError(f"20 offsets: {name} of the second launch differs from the first's")
    del second, got
    (k1, k2), (p1, p2) = _timed_pair(
        lambda: cuda_glcm.sufficient_stats_multi(x, levels=LEVELS, offsets=offsets),
        lambda: cuda_glcm.sufficient_stats_multi_reference(x, levels=LEVELS, offsets=offsets))
    ms20, plain20 = min(k1, k2), min(p1, p2)
    # two launches: each reads the images and writes the shared fields again
    bytes20 = sum(
        cuda_glcm.traffic_bytes(tuple(x.shape), LEVELS, offsets[i:i + cuda_glcm.MAX_OFFSETS])
        for i in range(0, len(offsets), cuda_glcm.MAX_OFFSETS))
    bound20 = cuda_glcm.bound_ms(bytes20)
    imgs = x[:256].permute(0, 2, 3, 1).to(torch.uint8).cpu().numpy()
    mask = rng.random(imgs.shape) > 0.2
    cuda_glcm.reset_launch_counts()
    cfg20 = tt.FeatureConfig(glcm=glcm20)
    card20 = tt.extract_features(imgs, mask, device=device, config=cfg20)
    path_launches = dict(cuda_glcm.LAUNCHES_BY_FORM)
    if path_launches["B2"] != 2 or cuda_glcm.LAUNCHES != 2 or card20.shape != (len(imgs), 3 * (17 + 20 * 6)):
        raise AssertionError(f"20-offset extract_features: {path_launches}, shape {card20.shape}")
    wire20 = _features_close(
        tt.FeatureMatrix(card20.values[:n_cpu], card20.names, 3),
        tt.extract_features(imgs[:n_cpu], mask[:n_cpu], device="cpu", config=cfg20), "20-offset wire")
    log(f"  20 offsets on {tuple(x.shape)}: {wrapper_launches['B2']} B2 launches == plain (max_abs_err {err20!r}), "
        f"kernel {k1!r} / {k2!r} ms, plain {p1!r} / {p2!r} ms (medians, CUDA events), {bytes20} bytes, bound "
        f"{bound20!r} ms; extract_features' 20-block wire ({path_launches['B2']} B2 launches) vs CPU {wire20!r}")

    # no plain version on the card: 'never' and sizes past the kernel's
    # bounds raise, and 'auto' inside the bounds launches the kernel
    cuda_glcm.reset_launch_counts()
    never = tt.FeatureConfig(use_pallas="never")
    _raises_value_error(lambda: tt.extract_features(imgs, mask, device=device, config=never),
                        "extract_features with use_pallas='never'")
    _raises_value_error(
        lambda: tt.extract_features_batched(imgs, mask, device=device, batch_size=64, config=never),
        "extract_features_batched with use_pallas='never'")
    if not cuda_glcm.past_kernel_bounds(1 << 24, LEVELS) or cuda_glcm.past_kernel_bounds(64 * 64, HUGE_LEVELS):
        raise AssertionError("the kernel's bounds should be 2^24 pixels and 32768 levels")
    field = torch.zeros((1, 1, 4096, 4096), dtype=torch.int32, device=device)  # 2^24 pixels
    text = _raises_value_error(
        lambda: cuda_glcm.sufficient_stats(field, levels=LEVELS, offset=OFFSET, need_diff=True),
        "sufficient_stats on 2^24 pixels")
    del field
    if cuda_glcm.LAUNCHES != 0:
        raise AssertionError(f"the refused calls launched {cuda_glcm.LAUNCHES_BY_FORM}")
    tt.extract_features(imgs, mask, device=device)
    if cuda_glcm.LAUNCHES_BY_FORM["B1b"] != 1 or cuda_glcm.LAUNCHES != 1:
        raise AssertionError(f"'auto' inside the bounds ran {cuda_glcm.LAUNCHES_BY_FORM}, want the kernel once")
    log(f"  refused on the card, nothing launched: use_pallas='never' (extract_features, "
        f"extract_features_batched) and 2^24 pixels ({text.split(':')[0]})")
    # past 4096 levels the card launches form B1e and agrees with the CPU
    big = rng.integers(0, HUGE_LEVELS, size=(8, 64, 64, 1), dtype=np.int32)
    big_cfg = tt.FeatureConfig(glcm=tt.GLCMConfig(levels=HUGE_LEVELS))
    cuda_glcm.reset_launch_counts()
    card_big = tt.extract_features(big, device=device, config=big_cfg)
    b1e_launches = cuda_glcm.LAUNCHES_BY_FORM["B1e"]
    if b1e_launches != 1 or cuda_glcm.LAUNCHES != 1:
        raise AssertionError(f"{HUGE_LEVELS} levels ran {cuda_glcm.LAUNCHES_BY_FORM}, want B1e once")
    big_diff = _features_close(card_big, tt.extract_features(big, device="cpu", config=big_cfg),
                               f"{HUGE_LEVELS} levels")
    log(f"  {HUGE_LEVELS} levels on 8x64x64x1: one B1e launch, features vs CPU {big_diff!r}")
    return {"B2": path_launches["B2"], "B1e": b1e_launches}, {
        "levels8192_vs_cpu": big_diff,
        "offsets20_ms": ms20, "offsets20_plain_ms": plain20, "offsets20_bytes": bytes20,
        "offsets20_bound_ms": bound20, "offsets20_max_abs_err": err20, "offsets20_wire_vs_cpu": wire20,
        "offsets20_wrapper_launches": wrapper_launches["B2"], "offsets20_path_launches": path_launches["B2"],
        "refused": ["use_pallas='never'", "2^24 pixels"],
    }


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


def phase_classic_levels(device, data, timed_runs=3, n_cpu=64, *, levels=CLASSIC_LEVELS, form="B1d",
                         n=None, batch_size=BATCH):
    """The classic slice above 256 levels: the first ``n`` of phase 5's
    objects quantized to ``levels`` on the card, ``run_pipeline`` with
    fast_path='auto' (tpumcia's classic path for > 256 levels: the packed
    f32 wire, a logistic head, both permutation views), in batches of
    ``batch_size``. Returns (``form``'s launches, record)."""
    import numpy as np
    import torch

    import tpumcia_torch as tt
    from tpumcia_torch.pipeline.run import _fast_path_ok
    from tpumcia_torch.utils.profiling import StageTimer

    (raw, mask, labels, donors), _ = data
    n = len(raw) if n is None else n
    raw, mask, labels, donors = raw[:n], mask[:n], labels[:n], donors[:n]
    shift = 16 - (levels - 1).bit_length()
    t0 = time.perf_counter()
    x = tt.quantize_to_levels(torch.from_numpy(raw).to(device), levels=levels, src_levels=65536)
    _sync(device)
    quant_s = time.perf_counter() - t0
    if not np.array_equal(x[:n_cpu].cpu().numpy(), (raw[:n_cpu] >> shift).astype(np.int32)):
        raise AssertionError(f"quantize_to_levels({levels}) on the card differs from v >> {shift}")
    feats = tt.FeatureConfig(glcm=tt.GLCMConfig(levels=levels))
    cfg = tt.PipelineConfig(
        features=feats,
        head=tt.HeadConfig(kind="logistic", num_steps=300),
        split=tt.SplitConfig(test_size=0.25, seed=0, group_by="donor"),
        fast_path="auto",
        batch_size=batch_size,
    )
    if _fast_path_ok(cfg, x, mask):
        raise AssertionError(f"{levels} levels should route to the classic path")

    def run(timer=None):
        out = tt.run_pipeline(x, labels, mask=mask, groups=donors, config=cfg, device=device, timer=timer)
        _sync(device)
        return out

    per_run = -(-n // batch_size) if n > 4096 else 1  # run_pipeline batches above 4096 objects
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    launches, times, result = _timed_runs(run, timed_runs, form, per_run)
    peak_rise = torch.cuda.max_memory_allocated(device) - base
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
    log(f"  {n} objects at {levels} levels (quantized on the card in {quant_s!r} s), batches of {batch_size}")
    log(f"  runs (s): {times!r}")
    log(f"  median {med!r} s = {n / med!r} objects/s; {form} launches {launches} over {timed_runs} runs; "
        f"peak device memory rose {peak_rise / 1e9!r} GB")
    log(f"  test_accuracy {result.test_accuracy!r}; test donors {sorted(test_donors)}; "
        f"channel totals {total.tolist()!r}")
    log(f"  card vs CPU on {n_cpu} objects: features max abs diff {diff!r}")
    log(f"  staged run (synchronised at each stage, s): {json.dumps(timer.totals)}")
    return launches, {
        "objects": n, "levels": levels, "batch_size": batch_size,
        "objects_per_s": n / med, "median_s": med, "runs_s": times, f"{form.lower()}_launches": launches,
        "test_accuracy": result.test_accuracy, "stages_s": timer.totals,
        "channel_totals": total.tolist(), "card_vs_cpu": diff, "peak_rise_bytes": peak_rise,
    }


def phase_classic_fields(device, timed_runs=3, n_check=8):
    """The reference notebook's workflow on 256x256 fields: noise channels
    synthesized on the card, features (hybrid, which is the f64 host
    backend at 65536 pixels), a logistic head and permutation importance
    through ``run_pipeline``; then an MLP head and ablation and coefficient
    importance on its feature matrix. Returns (B1d launches, record)."""
    import numpy as np

    import tpumcia_torch as tt
    from bench_torch import signal_first
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
    if not signal_first(result):
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
    """The forest's size."""
    import numpy as np

    nodes = [t.node_count for t in head.trees]
    return {"trees": len(nodes), "nodes_mean": float(np.mean(nodes)), "nodes_max": int(max(nodes)),
            "depth_max": int(max(t.max_depth for t in head.trees))}


def _forest_inference(head, X, reps=5) -> dict:
    """The walk kernel's class shares of ``head``'s forest on the scaled
    rows ``X`` (``apply``), bit-equal to its plain version; each one's
    median seconds."""
    import torch

    from tpumcia_torch.models import forest_device

    f = head.to_device()
    x = head.scaler.transform(torch.as_tensor(X, dtype=torch.float32, device=f.device))
    runs = {"kernel": lambda: f.apply(x),
            "plain": lambda: forest_device._apply_walk(x, f.nodes, f.roots, f.values)[0]}
    out, secs = {}, {}
    for name, run in runs.items():
        times = []
        for _ in range(reps):
            _sync(f.device)
            t0 = time.perf_counter()
            out[name] = run()
            _sync(f.device)
            times.append(time.perf_counter() - t0)
        secs[name] = statistics.median(times)
    if not torch.equal(out["kernel"], out["plain"]):
        diff = (out["kernel"] - out["plain"]).abs().max().item()
        raise AssertionError(f"the walk kernel's shares differ from its plain version's by {diff}")
    return secs


def _forest_walk(head, X, y) -> dict:
    """The walk kernel at the main path's shape: ``permutation_importance``
    over every column of the scaled test rows ``X`` (the reference call:
    10 repeats, seed 42), its walk launches and lanes counted on that call
    alone; then the same draws scored by ``apply_permuted`` against the
    kernel's plain version, bit for bit, both timed by CUDA events. Returns
    the kernels line's walk record."""
    import torch

    from tpumcia_torch.features import cuda_glcm
    from tpumcia_torch.importance import permutation
    from tpumcia_torch.models import forest_device
    from tpumcia_torch.utils import profiling

    f = head.to_device()
    x = head.scaler.transform(torch.as_tensor(X, dtype=torch.float32, device=f.device)).contiguous()
    N, F = x.shape
    R, T = 10, len(head.trees)
    D = F * R
    _sync(f.device)
    profiling.reset_counters()
    permutation.permutation_importance(head, X, y, n_repeats=R, seed=42)
    _sync(f.device)
    c = dict(profiling.COUNTERS)
    if c["forest_lanes"] != T * N * (D + 1):
        raise AssertionError(f"the sweep's forest lanes {c['forest_lanes']}, want {T * N * (D + 1)}")
    if c["forest_kernel_launches"] < 2:
        raise AssertionError(f"the sweep launched the walk kernel {c['forest_kernel_launches']} times")

    perms = permutation.draw_permutations(D, N, seed=42, device=f.device)
    masks = torch.eye(F, dtype=torch.uint8, device=f.device)
    nodes, roots, values = f.nodes, f.roots, f.values

    def run_kernel():
        return f.apply_permuted(x, perms, masks, R)

    def run_plain():
        return forest_device._apply_walk(x, nodes, roots, values, perms, masks, R)

    got, plain = run_kernel(), run_plain()
    if not (torch.equal(got, run_kernel()) and torch.equal(got, plain)):
        raise AssertionError("the walk kernel differs from its plain version or from its own rerun: "
                             f"max abs diff {(got - plain).abs().max().item()!r}")
    pure = bool(((values == 0) | (values == 1)).all())
    del plain
    (k1, k2), (p1, p2) = _timed_pair(run_kernel, run_plain)
    info = f.kernel_launch_info(D * N)
    K = values.shape[1]
    # each input and output once: the rows, the permutations, the masks, the
    # forest and the shares
    nbytes = 4 * N * F + 8 * D * N + F * F + (nodes.numel() + roots.numel() + values.numel()) * 4 + 4 * D * N * K
    bound, ms = cuda_glcm.bound_ms(nbytes), min(k1, k2)
    log(f"  walk kernel at {D} draws x {N} rows x {T} trees ({nodes.shape[0]} nodes, {K} classes): "
        f"{c['forest_kernel_launches']} launches and {c['forest_lanes']} lanes in the sweep's call; "
        f"== plain version (pure leaves {pure}); kernel {k1!r} / {k2!r} ms, plain version {p1!r} / "
        f"{p2!r} ms (median of runs, CUDA events); "
        f"{nbytes} bytes, bound {bound!r} ms; {json.dumps(info)}")
    return {
        "name": "forest_apply walk", "route": "cuda", "source": FOREST_SOURCE,
        "replaces": "none: tpumcia scores a forest with XLA operations (tpumcia/models/forest_device.py)",
        "at": f"{D}x{N} lanes, {T} trees, {nodes.shape[0]} nodes, {K} classes", "ms": ms,
        "plain_ms": min(p1, p2), "bytes": nbytes, "bound_ms": bound, "bound_by": "bytes",
        "share": bound / ms, "launches_per_run": c["forest_kernel_launches"],
        "lanes_per_run": c["forest_lanes"], "max_abs_err": 0.0, "pure_leaves": pure,
        "library_ms": None, "library": "none: no PyTorch call walks a tree", **info,
    }


def phase_forest(device, n_images=N_IMAGES, timed_runs=3):
    """BASELINE config 2 with the random-forest head (ipynb:404-434, 495):
    the bench workload on the classic path, the forest grown on the card.
    Returns (B1a launches, record, the walk kernel's record)."""
    import numpy as np
    import torch

    import tpumcia_torch as tt
    from bench_torch import mednist_config, signal_first
    from tpumcia_torch.io.synthetic import synthetic_mednist
    from tpumcia_torch.models.heads import fit_head
    from tpumcia_torch.pipeline.run import _fast_path_ok
    from tpumcia_torch.utils.profiling import StageTimer

    gray, labels, _ = synthetic_mednist(n_images // 6, num_classes=6, seed=0)
    cfg = dataclasses.replace(
        mednist_config(), head=tt.HeadConfig(kind="random_forest", n_estimators=100, max_depth=None, seed=0),
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
    if not signal_first(result):
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
    forms = _forest_inference(head, Xf[te])
    walk = _forest_walk(head, Xf[te], labels[te])

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
    }, walk


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


def phase_native(data):
    """The native packer and quantizer, built from native/packer.cpp, against
    their numpy paths on PACK_N variable-size crops of phase 5's objects
    (uint16 images, uint8 masks). Returns the record."""
    import numpy as np

    from tpumcia_torch.io import native

    (raw, mask, _, _), _ = data
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise AssertionError("the native packer did not build (g++ and native/packer.cpp are needed)")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(11)
    crops, masks = [], []
    for i in range(PACK_N):
        h, w = rng.integers(30, CYTO_HW + 1, size=2)
        r, c = rng.integers(0, CYTO_HW - h + 1), rng.integers(0, CYTO_HW - w + 1)
        crops.append(np.ascontiguousarray(raw[i, r:r + h, c:c + w]))
        masks.append(np.ascontiguousarray(mask[i, r:r + h, c:c + w, None]).astype(np.uint8))
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    for hw in ((CYTO_HW, CYTO_HW), (40, 36)):  # pad only; crop and pad
        packed = timed("pack_native_s", lambda: native.pack_objects(crops, hw))
        if not np.array_equal(packed, timed("pack_numpy_s", lambda: native.pack_objects_numpy(crops, hw))):
            raise AssertionError(f"native pack_objects (uint16, {hw}) differs from the numpy path")
        if not np.array_equal(native.pack_objects(masks, hw), native.pack_objects_numpy(masks, hw)):
            raise AssertionError(f"native pack_objects (uint8, {hw}) differs from the numpy path")
    for levels in (LEVELS, 64):
        q = timed("quantize_native_s", lambda: native.quantize_u16(packed, levels=levels))
        if not np.array_equal(q, timed("quantize_numpy_s", lambda: native.quantize_u16_numpy(packed, levels=levels))):
            raise AssertionError(f"native quantize_u16 ({levels} levels) differs from the numpy path")
    log(f"  native packer {native.library_path().name} (g++, {build_s!r} s): pack_objects and quantize_u16 "
        f"== numpy on {PACK_N} crops; seconds {json.dumps(secs)}")
    return {"build_s": build_s, **secs}


def phase_analyze_objects(device, data, cyto_rec, timed_runs=3):
    """Phase 5's objects as an in-memory ``ObjectBatch`` through
    ``analyze_objects`` (quantized on the card). Returns (B1b launches,
    record)."""
    import numpy as np
    import torch

    import tpumcia_torch as tt
    from tpumcia_torch.io.h5 import ObjectBatch

    (raw, mask, labels, donors), _ = data
    n = len(raw)
    objects = ObjectBatch(
        images=raw, masks=mask, labels=np.array(["activated", "resting"])[labels], donors=donors,
        experiments=None, channels=[f"Ch{i + 1:02d}" for i in range(CYTO_CH)],
        ids=[str(i) for i in range(n)],
    )
    cfg = tt.PipelineConfig(
        head=tt.HeadConfig(kind="logistic", num_steps=300),
        split=tt.SplitConfig(test_size=0.25, seed=0, group_by="donor"),
        fast_path="always",
        batch_size=BATCH,
    )

    def run():
        out = tt.analyze_objects(objects, device=device, config=cfg)
        _sync(device)
        return out

    launches, times, result = _timed_runs(run, timed_runs, "B1b", -(-n // BATCH))
    X = result.features.values
    F = CYTO_CH * 23
    if X.shape != (n, F) or not np.isfinite(np.nan_to_num(X)).all():
        raise AssertionError(f"feature matrix {X.shape} is not finite ({n}, {F})")
    if result.features.names[0] != "min_intensity_Ch01":
        raise AssertionError(f"channel names did not reach the columns: {result.features.names[:2]}")
    train_donors = {str(d) for d in donors[result.train_idx]}
    test_donors = {str(d) for d in donors[result.test_idx]}
    if train_donors & test_donors or not test_donors:
        raise AssertionError(f"donor split leaks: train {train_donors}, test {test_donors}")
    total = np.asarray(result.channel_result.total)
    if int(np.argmax(total)) != CYTO_SIGNAL or not total[CYTO_SIGNAL] > 0:
        raise AssertionError(f"signal channel {CYTO_SIGNAL} not first: {total.tolist()}")
    if result.test_accuracy < 0.95:
        raise AssertionError(f"test accuracy {result.test_accuracy} < 0.95")
    ranking = result.channel_result.ranking.tolist()
    if ranking != cyto_rec["ranking"] or abs(result.test_accuracy - cyto_rec["test_accuracy"]) > 1.0 / len(result.test_idx):
        raise AssertionError(f"analyze_objects ranks {ranking} at accuracy {result.test_accuracy}; "
                             f"run_pipeline on the same data {cyto_rec['ranking']} at {cyto_rec['test_accuracy']}")

    # the part of a call that run_pipeline on levels already on the card does not pay
    ingest = []
    for _ in range(timed_runs):
        _sync(device)
        t0 = time.perf_counter()
        x = tt.quantize_to_levels(torch.from_numpy(raw).to(device), levels=LEVELS, src_levels=65536)
        _sync(device)
        ingest.append(time.perf_counter() - t0)
        del x
    med, ingest_s = statistics.median(times), statistics.median(ingest)
    log(f"  runs (s): {times!r}")
    log(f"  median {med!r} s = {n / med!r} objects/s over {n} uint16 objects; B1b launches {launches}")
    log(f"  upload + quantization on the card {ingest_s!r} s (median of {ingest!r}) = {ingest_s / med!r} of a call")
    log(f"  test_accuracy {result.test_accuracy!r} (run_pipeline: {cyto_rec['test_accuracy']!r}); ranking "
        f"{ranking} as run_pipeline's; test donors {sorted(test_donors)}")
    return launches, {
        "objects_per_s": n / med, "median_s": med, "runs_s": times, "b1b_launches": launches,
        "upload_quantize_s": ingest_s, "upload_quantize_share": ingest_s / med,
        "test_accuracy": result.test_accuracy, "ranking": ranking, "channel_totals": total.tolist(),
    }


def phase_streaming(device, data, timed_dirs=3):
    """BASELINE config 5: ``stream_extract`` over STREAM_N masked 12-channel
    objects in shards of STREAM_SHARD, served from phase 5's 256-level
    objects at ``idx % CYTO_N`` (the host holds no more than phase 5 does).
    Returns ({form: launches of the gated runs}, record)."""
    import numpy as np
    import torch

    import tpumcia_torch as tt
    from tpumcia_torch.features import cuda_glcm
    from tpumcia_torch.pipeline.streaming import _manifest_jsonl_path, _manifest_path, stream_extract

    (raw, mask, labels, _), _ = data
    x8 = (raw >> 8).astype(np.uint8)
    mask8 = mask.astype(np.uint8)
    shards = STREAM_N // STREAM_SHARD
    F = CYTO_CH * 23
    fetched = []

    def fetch(idx):
        lo = int(idx[0]) % CYTO_N  # contiguous views: a shard never straddles the wrap
        fetched.append(int(idx[0]))
        return x8[lo:lo + len(idx)], mask8[lo:lo + len(idx)], labels[lo:lo + len(idx)]

    def stream(out, n=STREAM_N, **kw):
        res = stream_extract(fetch, n, out, device=device, shard_size=STREAM_SHARD, **kw)
        _sync(device)
        return res

    with tempfile.TemporaryDirectory(prefix="tpumcia_stream_") as tmp:
        # the gated first run, into a fresh directory
        stream(os.path.join(tmp, "warm"), n=2 * STREAM_SHARD)  # allocator and pinned buffers warm
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        cuda_glcm.reset_launch_counts()
        out = os.path.join(tmp, "run0")
        t0 = time.perf_counter()
        first = stream(out)
        call_s = [time.perf_counter() - t0]
        rise = torch.cuda.max_memory_allocated(device) - base
        launches = cuda_glcm.LAUNCHES_BY_FORM["B1b"]
        if (first.shards_computed, first.shards_skipped) != (shards, 0):
            raise AssertionError(f"first run computed {first.shards_computed}, skipped {first.shards_skipped}")
        if launches != shards or cuda_glcm.LAUNCHES != shards:
            raise AssertionError(f"streaming launched {cuda_glcm.LAUNCHES_BY_FORM}, want B1b {shards} times")
        X = first.features.values
        if X.shape != (STREAM_N, F) or not np.isfinite(np.nan_to_num(X)).all():
            raise AssertionError(f"streamed matrix {X.shape} is not finite ({STREAM_N}, {F})")
        if not np.array_equal(first.labels, np.tile(labels, STREAM_N // CYTO_N)):
            raise AssertionError("streamed labels differ from the labels served")
        if not np.array_equal(X[:CYTO_N], X[CYTO_N:2 * CYTO_N], equal_nan=True):
            raise AssertionError("the same objects served again gave other bytes")
        direct = tt.extract_features(x8[:STREAM_SHARD], mask8[:STREAM_SHARD], device=device)
        if not np.array_equal(X[:STREAM_SHARD], direct.values, equal_nan=True):
            raise AssertionError("shard 0 differs from extract_features on the same objects")
        if not rise < STREAM_PEAK_BYTES:
            raise AssertionError(f"peak device memory rose by {rise} bytes, over {STREAM_PEAK_BYTES}")
        rates, profiles = [first.images_per_second], [first.profile]

        # staged against unstaged uploads, 8 shards
        off = stream(os.path.join(tmp, "unstaged"), n=8 * STREAM_SHARD, stage_on_device=False)
        if off.shards_computed != 8 or not np.array_equal(off.features.values, X[:8 * STREAM_SHARD], equal_nan=True):
            raise AssertionError("stage_on_device=False gave other bytes than staging on the worker")

        # resume: nothing to do; then 3 shard files gone, one record moved to
        # a manifest.jsonl tail and one more lost to that tail's torn last line
        fetched.clear()
        again = stream(out)
        if (again.shards_computed, again.shards_skipped) != (0, shards) or fetched:
            raise AssertionError(f"resume computed {again.shards_computed}, skipped {again.shards_skipped}")
        gone = [3, 17, shards - 1]
        for k in gone:
            os.unlink(os.path.join(out, f"shard_{k * STREAM_SHARD:09d}.npz"))
        manifest_file = _manifest_path(Path(out))
        manifest = json.loads(manifest_file.read_text())
        kept_sid, torn_sid = f"shard_{5 * STREAM_SHARD:09d}", f"shard_{9 * STREAM_SHARD:09d}"
        kept, torn = manifest["shards"].pop(kept_sid), manifest["shards"].pop(torn_sid)
        manifest_file.write_text(json.dumps(manifest))
        torn_line = json.dumps({"sid": torn_sid, **torn})
        _manifest_jsonl_path(manifest_file.parent).write_text(
            json.dumps({"version": 2, "config_tag": "default"}) + "\n"
            + json.dumps({"sid": kept_sid, **kept}) + "\n" + torn_line[:len(torn_line) // 2])
        fetched.clear()
        resumed = stream(out)
        want = sorted(k * STREAM_SHARD for k in gone + [9])
        if sorted(fetched) != want or (resumed.shards_computed, resumed.shards_skipped) != (4, shards - 4):
            raise AssertionError(f"resume fetched shards at {sorted(fetched)}, want {want}; computed "
                                 f"{resumed.shards_computed}, skipped {resumed.shards_skipped}")
        if not np.array_equal(resumed.features.values, X, equal_nan=True):
            raise AssertionError("the resumed matrix differs from the first run's")

        # throughput over fresh directories
        for k in range(1, timed_dirs):
            t0 = time.perf_counter()
            res = stream(os.path.join(tmp, f"run{k}"))
            call_s.append(time.perf_counter() - t0)
            rates.append(res.images_per_second)
            profiles.append(res.profile)

        # a maskless 3-channel collection: form B1a once per shard
        gray = np.random.default_rng(12).integers(0, LEVELS, size=(STREAM_SHARD, 64, 64, 3), dtype=np.uint8)
        cuda_glcm.reset_launch_counts()
        plain_shards = STREAM_MASKLESS_N // STREAM_SHARD
        t0 = time.perf_counter()
        maskless = stream_extract(lambda idx: (gray[:len(idx)], None, None), STREAM_MASKLESS_N,
                                  os.path.join(tmp, "maskless"), device=device, shard_size=STREAM_SHARD)
        _sync(device)
        maskless_s = time.perf_counter() - t0
        b1a = cuda_glcm.LAUNCHES_BY_FORM["B1a"]
        M = maskless.features.values
        if maskless.shards_computed != plain_shards or b1a != plain_shards or cuda_glcm.LAUNCHES != b1a:
            raise AssertionError(f"maskless run: {maskless.shards_computed} shards, launches {cuda_glcm.LAUNCHES_BY_FORM}")
        if M.shape != (STREAM_MASKLESS_N, 69) or maskless.labels is not None or not np.array_equal(
                M[:STREAM_SHARD], M[-STREAM_SHARD:], equal_nan=True):
            raise AssertionError(f"maskless matrix {M.shape}: repeated shards differ, or labels appeared")

    # the same collection from a host array through the batched entry (C3)
    big = np.tile(x8, (STREAM_N // CYTO_N, 1, 1, 1))
    big_mask = np.tile(mask8, (STREAM_N // CYTO_N, 1, 1))
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    cuda_glcm.reset_launch_counts()
    t0 = time.perf_counter()
    batched = tt.extract_features_batched(big, big_mask, device=device, batch_size=STREAM_SHARD, in_flight=8)
    _sync(device)
    batched_s = time.perf_counter() - t0
    batched_rise = torch.cuda.max_memory_allocated(device) - base
    if cuda_glcm.LAUNCHES_BY_FORM["B1b"] != shards or not np.array_equal(batched.values, X, equal_nan=True):
        raise AssertionError(f"extract_features_batched from the host: launches {cuda_glcm.LAUNCHES_BY_FORM}, "
                             "or its matrix differs from the streamed one")
    if not batched_rise < STREAM_PEAK_BYTES:
        raise AssertionError(f"extract_features_batched: peak device memory rose by {batched_rise} bytes")
    med = statistics.median(rates)
    profile = profiles[rates.index(med)] if med in rates else profiles[0]  # an even count has no median run
    log(f"  {STREAM_N} objects in {shards} shards of {STREAM_SHARD}: {launches} B1b launches; rows of repeated "
        f"objects bit-equal; shard 0 == extract_features; peak device memory rose {rise / 1e9!r} GB")
    log(f"  images_per_second of {timed_dirs} fresh directories: {rates!r}; median {med!r} objects/s; whole "
        f"calls (with the matrix reassembled from the shards) {call_s!r} s")
    log(f"  profile of the median run (s): {json.dumps(profile)}; all: {json.dumps(profiles)}")
    log("  unstaged 8 shards == staged; resume: 0 computed / 64 skipped, then exactly the 3 deleted shards "
        "and the one on the torn manifest line")
    log(f"  extract_features_batched(in_flight=8) from a {big.nbytes / 1e9!r} GB host array: {batched_s!r} s = "
        f"{STREAM_N / batched_s!r} objects/s, == the streamed matrix, peak device memory rose {batched_rise / 1e9!r} GB")
    log(f"  maskless {STREAM_MASKLESS_N} 64x64x3 images in {plain_shards} shards: {b1a} B1a launches, "
        f"{maskless_s!r} s = {STREAM_MASKLESS_N / maskless_s!r} images/s ({json.dumps(maskless.profile)})")
    return {"B1b": launches, "B1a": b1a}, {
        "objects": STREAM_N, "shards": shards, "objects_per_s": med, "rates": rates, "call_s": call_s,
        "profile_s": profile, "profiles_s": profiles, "peak_rise_bytes": rise, "b1b_launches": launches,
        "batched_s": batched_s, "batched_objects_per_s": STREAM_N / batched_s,
        "batched_peak_rise_bytes": batched_rise,
        "maskless": {"images": STREAM_MASKLESS_N, "b1a_launches": b1a, "seconds": maskless_s,
                     "images_per_s": STREAM_MASKLESS_N / maskless_s, "profile_s": maskless.profile},
    }


def _cnn_settings() -> dict:
    import torch

    return {
        "cudnn.benchmark": torch.backends.cudnn.benchmark,
        "cudnn.deterministic": torch.backends.cudnn.deterministic,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "compute": "bf16 autocast, float32 parameters, channels_last",
    }


def cnn_workload(device, n_images, width, depth):
    """Phase 13's workload: the bench workload's grayscale images with 2
    noise channels synthesized on the card (uint8), their labels, and the
    config (ResNet-``depth`` at ``width``, batch 256, 8 epochs)."""
    from tpumcia_torch.io.synthetic import synthetic_mednist
    from tpumcia_torch.models.train import CNNConfig
    from tpumcia_torch.preprocess.synth import add_noise_channels_batched

    gray, labels, _ = synthetic_mednist(n_images // 6, num_classes=6, seed=0)
    images = add_noise_channels_batched(gray, seed=0, batch_size=BATCH, device=device)  # uint8 on the card
    return images, labels, CNNConfig(num_classes=6, depth=depth, width=width, batch_size=256, epochs=8)


def phase_cnn(device, n_images=N_IMAGES, n_cpu=32, width=64, depth="18"):
    """BASELINE config 3 at full width through ``run_cnn_pipeline``: the
    bench workload's images with 2 noise channels synthesized on the card,
    ResNet-18 at width 64, batch 256, 8 epochs, bf16 autocast; then the
    batch-size sweep. ``width`` and ``depth`` let the control flow be rehearsed
    at a small size. Returns the record."""
    import numpy as np
    import torch

    from tpumcia_torch.features import cuda_glcm
    from tpumcia_torch.importance.occlusion import occlusion_map
    from tpumcia_torch.models.cnn import make_resnet
    from tpumcia_torch.models.train import CNNHead, fit_cnn
    from tpumcia_torch.pipeline.run_cnn import run_cnn_pipeline

    torch.backends.cudnn.benchmark = True  # cuDNN picks each convolution's algorithm by timing it once
    settings = _cnn_settings()
    images, labels, cfg = cnn_workload(device, n_images, width, depth)
    n_repeats = CNN_REPEATS

    cuda_glcm.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    res = run_cnn_pipeline(images, labels, device=device, config=cfg, n_repeats=n_repeats)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device)
    if cuda_glcm.LAUNCHES != 0:
        raise AssertionError(f"the CNN path launched GLCM kernels: {cuda_glcm.LAUNCHES_BY_FORM}")
    n_train, n_test, C = len(res.train_idx), len(res.test_idx), images.shape[-1]
    occ, perm = res.occlusion, res.permutation
    if res.test_accuracy < 0.90:
        raise AssertionError(f"CNN test accuracy {res.test_accuracy} < 0.90; history {res.head.history}")
    if occ.top_channel() != 0 or perm.top_channel() != 0:
        raise AssertionError(f"signal channel not first: occlusion {occ.mean}, permutation {perm.mean}")
    if not (np.isfinite(occ.mean).all() and np.isfinite(perm.mean).all() and perm.per_channel[0].shape == (n_repeats,)):
        raise AssertionError(f"importances not finite: {occ.mean}, {perm.mean}")
    losses = [h["loss"] for h in res.head.history]
    if len(losses) != cfg.epochs or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"training history {res.head.history}")
    x = images.to(torch.float32) / 255.0
    x_test, y_test = x[torch.from_numpy(res.test_idx).to(device)], labels[res.test_idx]
    t0 = time.perf_counter()
    maps = occlusion_map(res.head, x_test[:16], y_test[:16], window=8, stride=8)
    map_s = time.perf_counter() - t0
    if maps.shape != (16, 8, 8) or not np.isfinite(maps).all():
        raise AssertionError(f"occlusion_map gave {maps.shape}")

    # the same weights in float32, on the card (TF32 off) and on the CPU
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        state = res.head.model.state_dict()
        heads = {}
        for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
            model = make_resnet(6, in_channels=C, width=width, depth=depth, dtype=torch.float32)
            model.load_state_dict(state)
            heads[where] = CNNHead(model=model.to(dev, memory_format=torch.channels_last), classes=res.head.classes)
        f32_card = heads["card"].predict_logits(x_test)
        f32_cpu = heads["cpu"].predict_logits(x_test[:n_cpu].cpu())
        logit_diff = (f32_card[:n_cpu].cpu() - f32_cpu).abs().max().item()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    if not logit_diff <= 1e-3:
        raise AssertionError(f"float32 logits on the card differ from the CPU's by {logit_diff}")
    bf16_logits = res.head.predict_logits(x_test)
    agree = (bf16_logits.argmax(1) == f32_card.argmax(1)).float().mean().item()
    if agree < 0.99:
        raise AssertionError(f"bf16 and float32 predictions agree on {agree} of the test images")

    fit_s, imp_s = res.timings["fit_s"], res.timings["importance_s"]
    sweeps = 2 + C + C * n_repeats  # forward passes over the test set: two baselines, C occlusions, C*R shuffles
    log(f"  settings: {json.dumps(settings)}")
    log(f"  {n_train} training images, {cfg.epochs} epochs at batch {cfg.batch_size}: fit {fit_s!r} s = "
        f"{n_train * cfg.epochs / fit_s!r} trained images/s (init and cuDNN's autotuning inside); "
        f"losses {losses!r}")
    log(f"  test accuracy {res.test_accuracy!r} on {n_test} images; occlusion drops {occ.mean.tolist()!r}; "
        f"image-permutation drops {perm.mean.tolist()!r}")
    log(f"  importance {imp_s!r} s for {sweeps} sweeps = {sweeps * n_test / imp_s!r} occluded images/s; "
        f"occlusion_map of 16 images (64 windows) {map_s!r} s; peak device memory {peak / 1e9!r} GB")
    log(f"  float32 logits card vs CPU on {n_cpu} images (TF32 off): {logit_diff!r}; bf16 argmax == float32 "
        f"argmax on {agree!r} of {n_test}")

    # the batch-size sweep: a 1-epoch fit first (cuDNN times its algorithms
    # at each new shape), then 2 epochs timed
    x_train, y_train = x[torch.from_numpy(res.train_idx).to(device)], labels[res.train_idx]
    test_accuracy = res.test_accuracy
    del res, heads, f32_card, bf16_logits
    sweep = []
    for bs in CNN_BATCHES:
        fit_cnn(x_train, y_train, device=device, config=dataclasses.replace(cfg, batch_size=bs, epochs=1))
        _sync(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        head = fit_cnn(x_train, y_train, device=device, config=dataclasses.replace(cfg, batch_size=bs, epochs=2))
        _sync(device)
        secs = time.perf_counter() - t0
        sweep.append({"batch_size": bs, "seconds": secs, "images_per_s": 2 * n_train / secs,
                      "peak_bytes": torch.cuda.max_memory_allocated(device),
                      "loss": head.history[-1]["loss"]})
        log(f"  batch {bs}: 2 epochs in {secs!r} s = {2 * n_train / secs!r} trained images/s, peak "
            f"{sweep[-1]['peak_bytes'] / 1e9!r} GB, loss {sweep[-1]['loss']!r}")
        if not np.isfinite(sweep[-1]["loss"]):
            raise AssertionError(f"batch {bs}: loss {sweep[-1]['loss']}")
        del head
    torch.backends.cudnn.benchmark = False
    return {
        "settings": settings, "train_images": n_train, "test_images": n_test, "epochs": cfg.epochs,
        "batch_size": cfg.batch_size, "fit_s": fit_s, "trained_images_per_s": n_train * cfg.epochs / fit_s,
        "importance_s": imp_s, "occluded_images_per_s": sweeps * n_test / imp_s, "occlusion_map_s": map_s,
        "peak_bytes": peak, "test_accuracy": test_accuracy,
        "losses": losses, "occlusion_drops": occ.mean.tolist(), "permutation_drops": perm.mean.tolist(),
        "f32_card_vs_cpu": logit_diff, "bf16_argmax_agreement": agree, "sweep": sweep,
    }


def phase_eval(device):
    """The ``eval`` CLI in process on the synthetic source: returns 0, logs
    both events, ranks channel 0 first and launches the kernel. Returns
    ({form: launches}, record)."""
    from tpumcia_torch import eval as eval_cli
    from tpumcia_torch.features import cuda_glcm

    with tempfile.TemporaryDirectory(prefix="tpumcia_eval_") as tmp:
        metrics = os.path.join(tmp, "metrics.jsonl")
        cuda_glcm.reset_launch_counts()
        t0 = time.perf_counter()
        code = eval_cli.main(["--source", "synthetic", "--n-per-class", "200", "--metrics", metrics,
                              "--device", str(device)])
        _sync(device)
        secs = time.perf_counter() - t0
        events = [json.loads(line) for line in Path(metrics).read_text().splitlines()]
    launches = {f: c for f, c in cuda_glcm.LAUNCHES_BY_FORM.items() if c}
    if code != 0 or [e["event"] for e in events] != ["data_loaded", "pipeline_done"]:
        raise AssertionError(f"eval returned {code} with events {[e.get('event') for e in events]}")
    done = events[1]
    if events[0]["shape"] != [1200, 64, 64, 3] or done["channel_ranking"][0] != 0 or done["test_accuracy"] < 0.90:
        raise AssertionError(f"eval: {events}")
    if launches != {"B1a": 1}:
        raise AssertionError(f"eval launched {cuda_glcm.LAUNCHES_BY_FORM}, want B1a once")
    log(f"  python -m tpumcia_torch.eval --source synthetic --n-per-class 200: {secs!r} s in process, test "
        f"accuracy {done['test_accuracy']!r}, ranking {done['channel_ranking']}, launches {launches}, "
        f"timings {json.dumps(done['timings'])}")
    return launches, {"seconds": secs, "test_accuracy": done["test_accuracy"],
                      "channel_ranking": done["channel_ranking"], "timings_s": done["timings"],
                      "launches": launches}


def _mesh_run(device, x, mask, labels, donors, timed_runs, form, per_run, cfg, pool):
    """``run_pipeline`` over ``pool`` (``cfg.mesh``) after a warm-up run,
    ``timed_runs`` times; raises unless ``form`` alone launched ``per_run``
    times a run, the donors are disjoint, the accuracy is >= 0.95 and the
    signal channel is first. Returns (launches, seconds per run, result)."""
    import numpy as np

    import tpumcia_torch as tt

    def run():
        out = tt.run_pipeline(x, labels, mask=mask, groups=donors, config=cfg, device=pool)
        _sync(device)
        return out

    launches, times, result = _timed_runs(run, timed_runs, form, per_run)
    train_donors = {str(d) for d in donors[result.train_idx]}
    test_donors = {str(d) for d in donors[result.test_idx]}
    if train_donors & test_donors or not test_donors:
        raise AssertionError(f"donor split leaks: train {train_donors}, test {test_donors}")
    total = np.asarray(result.channel_result.total)
    if int(np.argmax(total)) != CYTO_SIGNAL or not total[CYTO_SIGNAL] > 0:
        raise AssertionError(f"signal channel {CYTO_SIGNAL} not first: {total.tolist()}")
    if result.test_accuracy < 0.95:
        raise AssertionError(f"test accuracy {result.test_accuracy} < 0.95")
    return launches, times, result


def _dryrun_ranks(tmp, device, world, backend, slots, mode_args):
    """``world`` ranks of ``python -m tpumcia_torch.parallel.dryrun`` with
    ``mode_args`` on the card, started together over a file store in
    ``tmp``; returns (processes, the rank-0 record's path, the start time).
    Each process is waited for by :func:`_wait_ranks`."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    out = Path(tmp) / "rank0.json"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpumcia_torch.parallel.dryrun", "--world", str(world), "--rank", str(r),
         "--store", str(Path(tmp) / "store"), "--backend", backend, "--device", device.type,
         "--slots", str(slots), "--out", str(out), *mode_args],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in range(world)]
    return procs, out, time.perf_counter()


def _wait_ranks(procs, out, t0, what):
    """Wait for every rank within MESH_RANK_TIMEOUT_S of ``t0``, kill every
    rank left, raise unless each exited 0; returns (rank 0's record, exit
    codes, seconds)."""
    codes = []
    try:
        for r, p in enumerate(procs):
            try:
                text, _ = p.communicate(timeout=max(1.0, MESH_RANK_TIMEOUT_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{what}: rank {r} did not finish in {MESH_RANK_TIMEOUT_S} s") from None
            codes.append(p.returncode)
            if p.returncode != 0:
                raise AssertionError(f"{what}: rank {r} exited {p.returncode}:\n{text[-4000:]}")
    finally:
        _kill(procs)
    return json.loads(out.read_text()), codes, time.perf_counter() - t0


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def phase_mesh(device, data, timed_runs=3, n_cpu=64):
    """The feature path over a mesh (ROADMAP A14's feature half). (a) two
    data slots on one card in one process: ``run_pipeline`` on phase 5's
    objects with ``mesh.data=2`` over ``device=[card, card]`` (the classic
    path; 2 B1b launches a run), the sharded statistics bit-equal to one
    unsharded call, the features against the CPU's sharded run, then 4
    offsets (2 B2 launches) and 'exact' (2 B1c launches), and the objects/s
    beside the one-slot classic run's; (b) two processes on the card over
    gloo and (c) one NCCL rank with two slots, each through
    ``python -m tpumcia_torch.parallel.dryrun`` and held against the same
    calls made here on one slot. Returns ({form: launches}, record)."""
    import numpy as np
    import torch

    import tpumcia_torch as tt
    from tpumcia_torch.config import MeshConfig
    from tpumcia_torch.features import cuda_glcm
    from tpumcia_torch.features.extract import _chw_levels
    from tpumcia_torch.features.stats import prepare_mask
    from tpumcia_torch.parallel import dryrun, make_mesh, sufficient_stats_sharded

    (raw, mask, labels, donors), _ = data
    n = len(raw)
    x = tt.quantize_to_levels(torch.from_numpy(raw).to(device), levels=LEVELS, src_levels=65536)
    pool = [device, device]

    def config(features=None, fast_path="auto", data=2):
        return tt.PipelineConfig(
            features=features or tt.FeatureConfig(),
            head=tt.HeadConfig(kind="logistic", num_steps=300),
            split=tt.SplitConfig(test_size=0.25, seed=0, group_by="donor"),
            mesh=MeshConfig(data=data), fast_path=fast_path, batch_size=BATCH,
        )

    # (a) the sharded statistics against one unsharded call on the card
    mesh = make_mesh(devices=pool)
    sharded = sufficient_stats_sharded(x, mask, mesh=mesh, need_diff_hist=False)
    whole = cuda_glcm.sufficient_stats(_chw_levels(x), prepare_mask(mask, x.shape, device),
                                       levels=LEVELS, offset=OFFSET)
    stats_err = _stats_error(sharded, whole)
    del sharded, whole

    launches = {}
    b1b, times, result = _mesh_run(device, x, mask, labels, donors, timed_runs, "B1b", 2, config(), pool)
    launches["B1b"] = b1b
    cpu = tt.extract_features(x[:n_cpu].cpu(), mask[:n_cpu], device="cpu",
                              mesh=make_mesh(devices=["cpu", "cpu"]))
    feat_err = float(np.nanmax(np.abs(result.features.values[:n_cpu] - cpu.values)))
    if not (np.array_equal(np.isnan(result.features.values[:n_cpu]), np.isnan(cpu.values))
            and feat_err <= FEATURE_ATOL):
        raise AssertionError(f"mesh features on the card differ from the CPU's by {feat_err}")
    # one slot: the classic path's batched extraction, BATCH objects a launch
    _, one_times, one = _mesh_run(device, x, mask, labels, donors, timed_runs, "B1b", -(-n // BATCH),
                                  config(fast_path="never", data=1), device)
    if one.channel_result.ranking.tolist() != result.channel_result.ranking.tolist():
        raise AssertionError(f"two slots rank {result.channel_result.ranking.tolist()}, "
                             f"one slot {one.channel_result.ranking.tolist()}")
    multi = tt.FeatureConfig(glcm=tt.GLCMConfig(distance=5, angle=(0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4)))
    launches["B2"], multi_times, _ = _mesh_run(device, x, mask, labels, donors, 1, "B2", 2, config(multi), pool)
    # 'exact' on the first MESH_EXACT_N objects: its float64 host finalize
    # takes 13 s on all of them, for nothing the kernel check needs
    e = MESH_EXACT_N
    launches["B1c"], exact_times, _ = _mesh_run(
        device, x[:e], mask[:e], labels[:e], donors[:e], 1, "B1c", 2,
        config(tt.FeatureConfig(precision="exact")), pool)
    del x
    med, one_med = statistics.median(times), statistics.median(one_times)
    log(f"  (a) {n} objects over 2 slots on {device}: stats bit-equal to one call (dstats[3] {stats_err!r}); "
        f"features vs the CPU's sharded run on {n_cpu}: {feat_err!r}")
    log(f"  (a) runs (s) {times!r}: median {med!r} s = {n / med!r} objects/s; one slot, fast_path='never': "
        f"{one_times!r}, {n / one_med!r} objects/s; 4 offsets {multi_times!r} s, exact on {MESH_EXACT_N} "
        f"{exact_times!r} s; "
        f"launches {launches}; accuracy {result.test_accuracy!r}, ranking {result.channel_result.ranking.tolist()}")

    # (b) two gloo ranks on the card and (c) one NCCL rank with two slots,
    # started together; the one-slot reference is computed here meanwhile
    runs, started = {}, []
    with tempfile.TemporaryDirectory(prefix="tpumcia_mesh_") as tmp:
        try:
            for name, world, backend, slots in MESH_RUNS:
                (Path(tmp) / name).mkdir()
                started.append(_dryrun_ranks(Path(tmp) / name, device, world, backend, slots,
                                             ["--objects", str(MESH_RANK_N)]))
            t_ref = time.perf_counter()
            ref = dryrun.reference(MESH_RANK_N, device, Path(tmp) / "reference_stream")
            ref_s = time.perf_counter() - t_ref
            for (name, world, backend, slots), (procs, out, t0) in zip(MESH_RUNS, started):
                rec, codes, secs = _wait_ranks(procs, out, t0, name)
                bad = dryrun.mismatches(rec, ref, MESH_RANK_N)
                if bad:
                    raise AssertionError(f"{name}: rank 0 differs from one process in {bad}")
                per_rank = [r["launches"]["stats"]["B1b"] for r in rec["ranks"]]
                if per_rank != [slots] * world or rec["mesh"]["backend"] != backend:
                    raise AssertionError(f"{name}: B1b launches by rank {per_rank}, backend {rec['mesh']['backend']}")
                runs[name] = {"world": world, "backend": backend, "slots": len(rec["mesh"]["slots"]),
                              "exit_codes": codes, "seconds": secs, "rank_seconds": [r["seconds"] for r in rec["ranks"]],
                              "launches_by_rank": [r["launches"] for r in rec["ranks"]],
                              "test_accuracy": rec["pipeline"]["test_accuracy"], "ranking": rec["pipeline"]["ranking"]}
                log(f"  {name}: {world} rank(s) x {slots} slot(s) over {backend}, "
                    f"exit codes {codes}, {secs!r} s; equal to one process; B1b launches by rank {per_rank}; "
                    f"rank seconds {json.dumps(rec['seconds'])}")
        finally:
            for procs, _, _ in started:  # every rank left, whatever failed
                _kill(procs)
    log(f"  one-slot reference for (b) and (c): {ref_s!r} s")
    return launches, {
        "objects": n, "slots": 2, "launches": launches, "objects_per_s": n / med, "median_s": med,
        "runs_s": times, "one_slot_objects_per_s": n / one_med, "one_slot_runs_s": one_times,
        "multi_offset_s": multi_times, "exact_s": exact_times, "stats_dstats3_err": stats_err,
        "card_vs_cpu": feat_err, "test_accuracy": result.test_accuracy,
        "ranking": result.channel_result.ranking.tolist(), "processes": runs,
        "process_objects": MESH_RANK_N, "reference_s": ref_s,
    }


def _grad_parity(device, x, y, cfg, steps=CNN_PARITY_STEPS):
    """Phase 16 (a'): float32 at full width, TF32 off, cuDNN deterministic.
    One slot (one backward over the batch) and two slots on the card
    (``reduce_gradients``) take the same batches from the same weights (the
    one-slot model steps; the two-slot model and a float64 copy are loaded
    with its weights before each step). Per step: the losses agree to
    CNN_LOSS_RTOL, and the two-slot gradient lies within CNN_GRAD_F64_RATIO
    times the one-slot gradient's own distance from the float64 gradient
    (both in units of max |g64|): the split adds no more than one float32
    pass's own rounding. ``max |g2 - g1| / max |g1|`` is reported beside.
    Returns the per-step records."""
    import torch
    import torch.nn.functional as F

    from tpumcia_torch.models.cnn import init_parameters, make_resnet
    from tpumcia_torch.models.train import make_optimizer
    from tpumcia_torch.parallel import make_mesh, reduce_gradients, replicate

    def model():
        m = make_resnet(cfg.num_classes, in_channels=x.shape[-1], width=cfg.width, depth=cfg.depth,
                        dtype=torch.float32)
        init_parameters(m, torch.Generator().manual_seed(cfg.seed))
        return m.to(device, memory_format=torch.channels_last)

    def grads(m):
        return torch.cat([p.grad.reshape(-1).double() for p in m.parameters()])

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        one, two, ref = model(), model(), model().double()
        mesh = make_mesh(devices=[device, device])
        replicas = replicate(two, mesh)
        optimizer = make_optimizer(one, cfg)
        records = []
        bs = cfg.batch_size
        for step in range(steps):
            xb, yb = x[step * bs:(step + 1) * bs], y[step * bs:(step + 1) * bs]
            two.load_state_dict(one.state_dict())
            ref.load_state_dict(one.state_dict())
            ref.zero_grad(set_to_none=True)
            F.cross_entropy(ref(xb.double()), yb).backward()
            optimizer.zero_grad(set_to_none=True)
            loss = F.cross_entropy(one(xb), yb)
            loss.backward()
            loss = loss.detach()
            got = reduce_gradients(replicas, mesh, xb, yb)
            g64, g1, g2 = grads(ref), grads(one), grads(two)
            scale = float(g64.abs().max())
            rec = {"one_vs_f64": float((g1 - g64).abs().max()) / scale,
                   "two_vs_f64": float((g2 - g64).abs().max()) / scale,
                   "two_vs_one": float((g2 - g1).abs().max()) / float(g1.abs().max()),
                   "loss_rel": abs(float(got) - float(loss)) / abs(float(loss))}
            records.append(rec)
            log(f"  (a') step {step}: loss one slot {float(loss)!r}, two slots {float(got)!r}; gradients over "
                f"max |g64|: one slot {rec['one_vs_f64']!r}, two slots {rec['two_vs_f64']!r} from float64; "
                f"max |g2 - g1| / max |g1| = {rec['two_vs_one']!r}")
            if not (rec["two_vs_f64"] <= CNN_GRAD_F64_RATIO * rec["one_vs_f64"] and rec["loss_rel"] <= CNN_LOSS_RTOL):
                raise AssertionError(f"(a') step {step}: {rec} (two slots within {CNN_GRAD_F64_RATIO} x the one "
                                     f"slot's distance from float64; losses within rel {CNN_LOSS_RTOL})")
            optimizer.step()
        return records
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags


def phase_cnn_mesh(device, cnn_rec, n_images=N_IMAGES, width=64, depth="18"):
    """The CNN path over a mesh (ROADMAP A14b). (a) ``run_cnn_pipeline`` on
    phase 13's workload over two slots on the card in one process
    (``make_mesh(data=2, devices=[card, card])``): phase 13's gates (test
    accuracy >= 0.90, the signal channel first by occlusion and by image
    permutation, no GLCM launch) and the trained and occluded images/s beside
    phase 13's one-slot numbers of this call. (a') float32 parity at full
    width: 3 steps of one slot against two slots on the same weights, TF32
    off, cuDNN deterministic, with a float64 copy as the truth: the two-slot
    gradient within CNN_GRAD_F64_RATIO (2) times the one-slot gradient's own
    distance from the float64 gradient, the losses within CNN_LOSS_RTOL (rel
    1e-4). A fixed 1e-5 x max |g| between the two float32 gradients does not
    hold at full width: the batch's float32 reductions round apart by ~1e-4
    of max |g| in cuDNN's algorithms. Adam's first steps are sign-like, so
    gradients and losses are compared, not parameters. (b) two gloo ranks on the card and (c) one NCCL rank with two
    slots, each through ``python -m tpumcia_torch.parallel.dryrun --mode cnn
    --size full`` (2,048 64x64 images, ResNet-18 at width 64, three epochs
    at batch 256, the probes on 512 of them), started together: every rank's
    loss history, final ``state_dict``, logits and probe drops equal to each
    other and to the parent's own two-slot run with cuDNN deterministic, bit
    for bit. Returns the record."""
    import numpy as np
    import torch

    from tpumcia_torch.features import cuda_glcm
    from tpumcia_torch.parallel import dryrun, make_mesh
    from tpumcia_torch.pipeline.run_cnn import run_cnn_pipeline

    torch.backends.cudnn.benchmark = True  # as phase 13
    settings = _cnn_settings()
    images, labels, cfg = cnn_workload(device, n_images, width, depth)
    mesh = make_mesh(data=2, devices=[device, device])
    cuda_glcm.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    res = run_cnn_pipeline(images, labels, device=device, config=cfg, mesh=mesh, n_repeats=CNN_REPEATS)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device)
    torch.backends.cudnn.benchmark = False
    if cuda_glcm.LAUNCHES != 0:
        raise AssertionError(f"the CNN path over a mesh launched GLCM kernels: {cuda_glcm.LAUNCHES_BY_FORM}")
    occ, perm = res.occlusion, res.permutation
    if res.test_accuracy < 0.90:
        raise AssertionError(f"(a) test accuracy {res.test_accuracy} < 0.90; history {res.head.history}")
    if occ.top_channel() != 0 or perm.top_channel() != 0:
        raise AssertionError(f"(a) signal channel not first: occlusion {occ.mean}, permutation {perm.mean}")
    losses = [h["loss"] for h in res.head.history]
    if len(losses) != cfg.epochs or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"(a) training history {res.head.history}")
    n_train, n_test, C = len(res.train_idx), len(res.test_idx), images.shape[-1]
    sweeps = 2 + C + C * CNN_REPEATS
    fit_s, imp_s = res.timings["fit_s"], res.timings["importance_s"]
    trained, occluded = n_train * cfg.epochs / fit_s, sweeps * n_test / imp_s
    log(f"  (a) 2 slots on {device}, settings {json.dumps(settings)}: fit {fit_s!r} s = {trained!r} trained "
        f"images/s (phase 13, one slot: {cnn_rec['trained_images_per_s']!r}); importance {imp_s!r} s = "
        f"{occluded!r} occluded images/s (phase 13: {cnn_rec['occluded_images_per_s']!r}); test accuracy "
        f"{res.test_accuracy!r}; losses {losses!r}; occlusion {occ.mean.tolist()!r}, permutation "
        f"{perm.mean.tolist()!r}; peak {peak / 1e9!r} GB")

    x = images.to(torch.float32) / 255.0
    train = torch.from_numpy(res.train_idx[:CNN_PARITY_STEPS * cfg.batch_size]).to(device)
    y_idx = torch.from_numpy(np.unique(labels, return_inverse=True)[1]).to(device)
    test_accuracy = res.test_accuracy
    del res, images
    t0 = time.perf_counter()
    parity = _grad_parity(device, x[train], y_idx[train], cfg)
    parity_s = time.perf_counter() - t0
    del x

    runs, started = {}, []
    with tempfile.TemporaryDirectory(prefix="tpumcia_cnn_mesh_") as tmp:
        try:
            for name, world, backend, slots in MESH_RUNS:
                (Path(tmp) / name).mkdir()
                started.append(_dryrun_ranks(Path(tmp) / name, device, world, backend, slots,
                                             ["--mode", "cnn", "--size", CNN_MESH_SIZE]))
            t_ref = time.perf_counter()
            ref = dryrun.reference_cnn(CNN_MESH_SIZE, device, slots=2)
            ref_s = time.perf_counter() - t_ref
            for (name, world, backend, slots), (procs, out, t0) in zip(MESH_RUNS, started):
                rec, codes, secs = _wait_ranks(procs, out, t0, name)
                bad = dryrun.cnn_mismatches(rec, ref)
                if bad:
                    raise AssertionError(f"{name}: the ranks differ from each other or from one process in {bad}")
                if rec["mesh"]["backend"] != backend or len(rec["mesh"]["slots"]) != 2 or len(rec["ranks"]) != world:
                    raise AssertionError(f"{name}: mesh {rec['mesh']}, {len(rec['ranks'])} rank records")
                runs[name] = {"world": world, "backend": backend, "slots": 2, "exit_codes": codes,
                              "seconds": secs, "rank_seconds": [r["seconds"] for r in rec["ranks"]]}
                log(f"  ({'b' if backend == 'gloo' else 'c'}) {name}: {world} rank(s) x {slots} slot(s) over "
                    f"{backend}, exit codes {codes}, {secs!r} s; ranks equal to each other and to one process "
                    f"bit for bit; rank seconds {json.dumps([r['seconds'] for r in rec['ranks']])}")
        finally:
            for procs, _, _ in started:
                _kill(procs)
    log(f"  (a') float32, {CNN_PARITY_STEPS} steps at batch {cfg.batch_size}: {parity_s!r} s; the one-process "
        f"two-slot reference for (b) and (c): {ref_s!r} s, losses {ref['history']!r}, occlusion {ref['occlusion']!r}")
    return {
        "settings": settings, "slots": 2, "train_images": n_train, "test_images": n_test, "epochs": cfg.epochs,
        "batch_size": cfg.batch_size, "fit_s": fit_s, "trained_images_per_s": trained,
        "one_slot_trained_images_per_s": cnn_rec["trained_images_per_s"], "importance_s": imp_s,
        "occluded_images_per_s": occluded, "one_slot_occluded_images_per_s": cnn_rec["occluded_images_per_s"],
        "peak_bytes": peak, "test_accuracy": test_accuracy, "losses": losses,
        "occlusion_drops": occ.mean.tolist(), "permutation_drops": perm.mean.tolist(),
        "f32_parity": parity, "f32_parity_s": parity_s,
        "processes": runs, "process_size": dryrun.CNN_SIZES[CNN_MESH_SIZE], "reference_s": ref_s,
    }


def _suffstats_rows(st, n, device):
    """The first ``n`` rows of each field of ``st``, on ``device``."""
    return type(st)(*(None if f is None else f[:n].to(device) for f in st))


def phase_api(device, data, n=API_N, n_cpu=64, n_images=64):
    """tpumcia's API on the card (port faults C6-C9), through calls made as
    tpumcia makes them, with no ``device=``. (a) the stats-level
    ``features.stats.sufficient_stats`` on ``n`` of phase 5's objects at 256
    levels (one B1c launch): bit-equal to a direct ``cuda_glcm`` launch with
    ``need_diff=True`` and, on ``n_cpu`` of them, to the CPU plain version;
    ``with_intensity=False`` / ``with_glcm=False`` zero their fields;
    ``sufficient_stats_multi`` at 4 offsets (one B2 launch) against a direct
    launch; both calls' median ms. (b) ``sufficient_stats_sharded`` with
    tpumcia's keywords over ``data=2`` on ``[card, card]`` (2 B1c launches
    a call), bit-equal to (a). (c) ``extract_features`` ('hybrid': one B1a
    launch; 'exact': one B1c) and ``run_pipeline(images, labels,
    config=cfg)`` as bench.py calls it (one B1a) on ``n_images`` of phase
    4's images with 2 noise channels made with numpy: on the card, and held
    against the port's copy of the notebook oracle at the golden tolerances.
    Returns ({form: launches}, record)."""
    import numpy as np
    import torch

    import tpumcia_torch as tt
    from bench_torch import mednist_config
    from tpumcia_torch.features import cuda_glcm, stats
    from tpumcia_torch.features.extract import _chw_levels
    from tpumcia_torch.io.synthetic import synthetic_mednist
    from tpumcia_torch.parallel import make_mesh, sufficient_stats_sharded
    from tpumcia_torch.reference_impl import feature_vector

    launches = {}

    def drive(call, want):
        """``call()`` with the launch counts set to 0 just before it; raises
        unless exactly ``want`` ({form: launches}) launched."""
        cuda_glcm.reset_launch_counts()
        out = call()
        _sync(device)
        got = {f: c for f, c in cuda_glcm.LAUNCHES_BY_FORM.items() if c}
        if got != want:
            raise AssertionError(f"launched {got}, want {want}")
        for f, c in got.items():
            launches[f] = launches.get(f, 0) + c
        return out

    (raw, mask, _, _), _ = data
    x = torch.from_numpy((raw[:n] >> 8).astype(np.uint8)).to(device)  # phase 5's 256 levels
    m = torch.from_numpy(mask[:n]).to(device)

    # (a) the stats-level call, as tpumcia makes it
    got = drive(lambda: stats.sufficient_stats(x, m), {"B1c": 1})
    img, plane = _chw_levels(x), stats.prepare_mask(m, x.shape, device)

    def direct():
        return cuda_glcm.sufficient_stats(img, plane, levels=LEVELS, offset=OFFSET, need_diff=True)

    _stats_error(got, direct())
    if got.diff_hist.device != device or got.dstats is not None:
        raise AssertionError("the stats-level call is not the card's difference-histogram contract")
    cpu = stats.sufficient_stats(x[:n_cpu].cpu(), m[:n_cpu].cpu(), device="cpu")
    _stats_error(_suffstats_rows(got, n_cpu, "cpu"), cpu)
    no_int = drive(lambda: stats.sufficient_stats(x, m, with_intensity=False), {"B1c": 1})
    no_glcm = drive(lambda: stats.sufficient_stats(x, m, with_glcm=False), {"B1c": 1})
    zero_glcm = ("marg_l", "marg_r", "diff_hist", "glcm_sumsq", "pair_count")
    for name in got._fields[:-1]:
        for st, zeroed in ((no_int, ("hist",)), (no_glcm, zero_glcm)):
            g, w = getattr(st, name), getattr(got, name)
            if not torch.equal(g, torch.zeros_like(w) if name in zeroed else w):
                raise AssertionError(f"with_* = False: {name} is not as tpumcia leaves it")
    multi = drive(lambda: stats.sufficient_stats_multi(x, m, offsets=FOUR_OFFSETS), {"B2": 1})
    want_multi = cuda_glcm.sufficient_stats_multi(img, plane, levels=LEVELS, offsets=FOUR_OFFSETS, need_diff=True)
    for o, (g, w) in enumerate(zip(multi, want_multi)):
        _stats_error(g, w if o == 0 else w._replace(hist=torch.zeros_like(w.hist)))
    direct_ms = _cuda_events_ms(direct, KERNEL_REPS, 3)
    wrapper_ms = _cuda_events_ms(lambda: stats.sufficient_stats(x, m), KERNEL_REPS, 3)
    direct_ms2 = _cuda_events_ms(direct, KERNEL_REPS, 3)
    wrapper_ms2 = _cuda_events_ms(lambda: stats.sufficient_stats(x, m), KERNEL_REPS, 3)
    log(f"  (a) stats-level sufficient_stats on {tuple(x.shape)} uint8 (no device=): one B1c launch, "
        f"bit-equal to a direct launch and, on {n_cpu} objects, to the CPU plain version; with_intensity / "
        f"with_glcm = False zero their fields; sufficient_stats_multi at 4 offsets: one B2 launch, bit-equal")
    log(f"  (a) median ms (CUDA events, {KERNEL_REPS} calls, in turns): stats-level {wrapper_ms!r} / "
        f"{wrapper_ms2!r}, direct cuda_glcm {direct_ms!r} / {direct_ms2!r}")

    # (b) tpumcia's parallel keywords over two slots on the card
    mesh = make_mesh(data=2, devices=[device, device])
    knobs = dict(chunk_size=32, onehot_dtype="bfloat16")
    sharded = drive(lambda: sufficient_stats_sharded(x, m, mesh=mesh, with_intensity=True, with_glcm=True,
                                                     **knobs), {"B1c": 2})
    _stats_error(sharded, got)
    sharded = drive(lambda: sufficient_stats_sharded(x, m, mesh=mesh, with_glcm=False, **knobs), {"B1c": 2})
    _stats_error(sharded, no_glcm)
    del sharded, got, no_int, no_glcm, multi, want_multi, cpu, img, plane, x, m
    log("  (b) sufficient_stats_sharded(chunk_size=, onehot_dtype=, with_intensity=, with_glcm=) over "
        "data=2 on [card, card]: 2 B1c launches a call, bit-equal to (a)")

    # (c) extract_features and run_pipeline without device=, against the oracle
    gray, labels, _ = synthetic_mednist(N_IMAGES // 6, num_classes=6, seed=0)
    gray, labels = gray[:n_images], labels[:n_images]
    noise = np.random.default_rng(18).normal(0, 0.1, size=(*gray.shape, 2))
    images = np.concatenate([gray[..., None], (np.clip(noise, 0, 1) * 255).astype(np.uint8)], axis=-1)
    oracle = np.stack([feature_vector(im / 255.0) for im in images])
    hybrid = drive(lambda: tt.extract_features(images), {"B1a": 1})
    exact = drive(lambda: tt.extract_features(images, config=tt.FeatureConfig(precision="exact")), {"B1c": 1})
    cfg = dataclasses.replace(mednist_config(), batch_size=n_images, synth=tt.SynthConfig(noise_channels=0),
                              head=tt.HeadConfig(kind="logistic", num_steps=60))
    result = drive(lambda: tt.run_pipeline(images, labels, config=cfg), {"B1a": 1})
    if result.features.device_values.device.type != device.type:
        raise AssertionError("run_pipeline without device= did not keep its features on the card")
    errors = {}
    for what, values, max_tol, mae_tol in (
            ("extract_features hybrid", hybrid.values, 1e-5, 1e-6),
            ("extract_features exact", exact.values, 1e-9, 1e-9),
            ("run_pipeline", result.features.values, 1e-5, 1e-6)):
        if values.shape != oracle.shape or not np.array_equal(np.isnan(values), np.isnan(oracle)):
            raise AssertionError(f"{what}: {values.shape} features, NaNs unlike the oracle's {oracle.shape}")
        err = np.abs(np.nan_to_num(values) - np.nan_to_num(oracle))
        errors[what] = {"max_abs": float(err.max()), "mae": float(err.mean())}
        if not (err.max() < max_tol and err.mean() < mae_tol):
            raise AssertionError(f"{what} against the oracle: {errors[what]} (tolerance {max_tol}, MAE {mae_tol})")
    log(f"  (c) {n_images} bench images + 2 numpy noise channels, no device=: extract_features hybrid (one "
        f"B1a) and exact (one B1c), run_pipeline(images, labels, config=cfg) (one B1a, features on "
        f"{result.features.device_values.device}); against the oracle: {json.dumps(errors)}")
    log(f"  launches: {launches}")
    return launches, {
        "stats_objects": n, "stats_level_ms": [wrapper_ms, wrapper_ms2], "direct_ms": [direct_ms, direct_ms2],
        "oracle_images": n_images, "oracle_errors": errors, "launches": launches,
    }


def phase_examples(device):
    """``python -m tpumcia_torch.examples.<name>`` for each of EXAMPLES at its
    default size on the card, started together; each must exit 0 within
    EXAMPLE_TIMEOUT_S. Returns the record."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    for name, why in EXAMPLES_LEFT_OUT.items():
        log(f"  {name}: not run here: {why}")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"tpumcia_torch.examples.{name}", "--device", str(device)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in EXAMPLES}
    t0, rec = time.perf_counter(), {}
    try:
        for name, p in procs.items():
            try:
                text, _ = p.communicate(timeout=max(1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"example {name} did not finish in {EXAMPLE_TIMEOUT_S} s") from None
            if p.returncode != 0:
                raise AssertionError(f"example {name} exited {p.returncode}:\n{text[-4000:]}")
            rec[name] = {"exit_code": p.returncode, "seconds_since_start": time.perf_counter() - t0}
            tail = [line for line in text.strip().splitlines() if line.strip()][-3:]
            log(f"  {name}: exit 0 ({rec[name]['seconds_since_start']!r} s since the start); last lines: "
                + " | ".join(line.strip() for line in tail))
    finally:
        _kill(list(procs.values()))
    return {"run": rec, "left_out": EXAMPLES_LEFT_OUT}


def phase_bench():
    """``bench_torch.py --cell all`` in a process of its own: both cells'
    lines, each correct (its gates), every metric present and finite, both
    roofline shares in (0, 1.05] (``bench_torch.line_failures``). Returns
    the lines' headline numbers."""
    import torch

    from bench_torch import CELLS, line_failures

    torch.cuda.empty_cache()  # this process's cached blocks, for the bench's own peak
    here = os.path.dirname(os.path.abspath(__file__))
    # its own session: the bench starts a process a cell, all killed on a timeout
    proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "bench_torch.py"), "--cell", "all", "--reps", str(BENCH_REPS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=here, start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"bench_torch.py ran past {BENCH_TIMEOUT_S} s") from None
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    if proc.returncode != 0 or [x["cell"] for x in lines] != list(CELLS):
        raise AssertionError(f"bench_torch.py exited {proc.returncode} with cells "
                             f"{[x['cell'] for x in lines]}: {err[-3000:]}")
    record = {}
    for line in lines:
        fails = line_failures(line)
        if fails:
            raise AssertionError(f"{line['cell']}: {fails}")
        m = line["metrics"]
        record[line["cell"]] = {key: m[key]["value"] for key in (
            CELLS[line["cell"]][1], "median_s", "glcm_ms", "glcm_roofline_share", "run_mfu",
            "idle_share", "peak_device_bytes")}
        record[line["cell"]]["stages_s"] = line["stages_s"]
        log(f"  {line['cell']}: {json.dumps(record[line['cell']])}")
    return record


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
        import bench_torch
        import tpumcia_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: tpumcia_torch or bench_torch.py not found next to this script ({e})", file=sys.stderr)
        return 1
    banned = ("jax", "tpumcia", "sklearn", "h5py", "imageio", "matplotlib")
    if any(m in sys.modules for m in banned):
        print(f"chip_smoke: importing tpumcia_torch pulled in one of {banned}", file=sys.stderr)
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
    cyto = bench_torch.cytometry_objects(CYTO_N), time.perf_counter() - t0
    launches, cyto_rec = phase_cytometry(device, cyto)
    kernels["B1b"]["launches"] = launches

    log("== extract_features")
    launches, extract_rec = phase_extract(device)
    kernels["B1c"]["launches"] = launches["B1c"]
    kernels["B2"]["launches"] = launches["B2"]
    launches, faults_rec = phase_faults(device)
    kernels["B2"]["launches"] += launches["B2"]
    kernels["B1e"]["launches"] = launches["B1e"]

    log("== classic slice at 1024 levels (B1d)")
    levels_launches, classic_1024 = phase_classic_levels(device, cyto)

    log("== classic slice at 8192 levels (B1e)")
    launches, classic_8192 = phase_classic_levels(
        device, cyto, levels=HUGE_LEVELS, form="B1e", n=HUGE_N, batch_size=HUGE_BATCH)
    kernels["B1e"]["launches"] += launches

    log("== classic slice on 256x256 fields (B1d)")
    fields_launches, classic_256px = phase_classic_fields(device)
    kernels["B1d"]["launches"] = levels_launches + fields_launches

    log("== the notebook's forest slice (random forest, MDI)")
    launches, forest_rec, walk = phase_forest(device)
    kernels["B1a"]["launches"] += launches

    log("== cytometry with morphology (random forest, MDI)")
    launches, cyto_morph_rec = phase_cytometry_morphology(device, cyto)
    kernels["B1b"]["launches"] += launches

    log("== analyze_objects (native packer; an in-memory ObjectBatch)")
    native_rec = phase_native(cyto)
    launches, analyze_rec = phase_analyze_objects(device, cyto, cyto_rec)
    kernels["B1b"]["launches"] += launches
    analyze_rec["native"] = native_rec

    log("== streaming (stream_extract over 131,072 objects)")
    launches, streaming_rec = phase_streaming(device, cyto)
    kernels["B1b"]["launches"] += launches["B1b"]
    kernels["B1a"]["launches"] += launches["B1a"]

    log("== the CNN path (ResNet-18, width 64; occlusion and image-permutation importance)")
    cnn_rec = phase_cnn(device)

    log("== the eval CLI (synthetic source)")
    launches, eval_rec = phase_eval(device)
    kernels["B1a"]["launches"] += launches["B1a"]

    log("== mesh (two slots on the card; two gloo ranks; one NCCL rank)")
    launches, mesh_rec = phase_mesh(device, cyto)
    for form, count in launches.items():
        kernels[form]["launches"] += count

    log("== tpumcia's API on the card (stats-level call, parallel keywords, no device=, the oracle)")
    launches, api_rec = phase_api(device, cyto)
    for form, count in launches.items():
        kernels[form]["launches"] += count
    del cyto

    log("== the CNN path over a mesh (two slots on the card; float32 parity; two gloo ranks; one NCCL rank)")
    cnn_mesh_rec = phase_cnn_mesh(device, cnn_rec)

    log("== the examples (python -m tpumcia_torch.examples.<name>)")
    examples_rec = phase_examples(device)

    log(f"== the bench (bench_torch.py --cell all --reps {BENCH_REPS})")
    bench_rec = phase_bench()

    print(gpu_line, flush=True)
    print(json.dumps({
        "kernels": [{"form": form, **kernels[form]} for form in FORMS] + [{"form": "walk", **walk}],
        "slice": slice_rec, "cytometry": cyto_rec, "extract_features": extract_rec,
        "classic_1024": classic_1024, "classic_8192": classic_8192, "classic_256px": classic_256px,
        "forest": forest_rec, "cytometry_morphology": cyto_morph_rec,
        "faults": faults_rec, "analyze_objects": analyze_rec, "streaming": streaming_rec,
        "cnn": cnn_rec, "eval": eval_rec, "mesh": mesh_rec, "cnn_mesh": cnn_mesh_rec,
        "examples": examples_rec, "api_parity": api_rec, "bench": bench_rec,
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
