"""tpumcia_torch on the GPU: the CUDA kernel in each of its forms (B1a
maskless, B1b masked, B1c with the difference histogram, B2 several
offsets, B1d at 65536 pixels or more than 256 levels, B1e past 4096 levels)
against its plain version, the wrapper's checks, and the slice and
``extract_features`` on the card against the same calls on the CPU, the
forest fitted on the card against the CPU fit, the forest walk kernel
against its plain version and the GEMM form, and the morphology block;
offset lists past the kernel's 16, the refusals past the kernel's bounds
(2^24 pixels, 32768 levels) and of ``use_pallas='never'``, per-batch uploads with ``in_flight`` and ``stream_extract`` with staged uploads,
tpumcia's stats-level call with no ``device=``, and ``bench_torch.py``
end to end.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports neither jax nor tpumcia, so it also runs where only torch is
installed, without the JAX harness in conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Tolerances: kernel vs plain version, integer fields bit-equal and
``dstats[3]`` (two float64 sums in another order, rounded to f32) to rel
1e-6; card vs CPU slice features 1e-5 max abs (f32 wire words summed in
another order). The heads' Adam fits replayed from a CUDA graph are held to
the eager loop within limits their tests derive from measured gaps, and
bit for bit to the same optimizer stepped eagerly.
"""

import numpy as np
import pytest
import torch

from torch_parity import WALK_CASES, WALK_FEATURES, WALK_REPEATS, WALK_ROWS, random_tree, require_cuda, walk_case
from tpumcia_torch.features import cuda_glcm

pytestmark = pytest.mark.cuda

INT_FIELDS = ("hist", "count", "vmax", "marg_l", "marg_r", "glcm_sumsq", "pair_count")


def _assert_stats_equal(got, want):
    for name in INT_FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if want.diff_hist is not None:
        assert got.dstats is None and torch.equal(got.diff_hist, want.diff_hist)
    else:
        assert got.diff_hist is None
        assert torch.equal(got.dstats[..., :3], want.dstats[..., :3])
        torch.testing.assert_close(got.dstats[..., 3], want.dstats[..., 3], rtol=1e-6, atol=0)


def _edge_mask(rng, shape, shared):
    """A random mask with an empty (image, channel), a one-pixel one and a
    full one: (B, 1 or C, H, W) uint8."""
    B, C, H, W = shape
    m = (rng.random((B, 1 if shared else C, H, W)) < 0.8).astype(np.uint8)
    m[0, 0] = 0
    m[-1, -1] = 0
    m[-1, -1, H // 2, W // 2] = 1
    if B > 1:
        m[1, 0] = 1
    return m


@pytest.mark.parametrize("shape,offset", [
    ((2048, 3, 64, 64), (0, 5)),
    ((3, 2, 64, 64), (3, -2)),
    ((3, 2, 64, 64), (-2, 1)),
    ((2, 3, 37, 53), (1, 0)),
    ((2, 2, 72, 72), (0, 5)),
])
def test_kernel_matches_plain_on_card(shape, offset):
    dev = require_cuda()
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=shape, dtype=np.int32)
    x[0, 0] = 0  # all-zero channel
    x[-1, -1] = 77  # constant channel
    t = torch.from_numpy(x).to(dev)
    before = cuda_glcm.LAUNCHES
    got = cuda_glcm.sufficient_stats(t, levels=256, offset=offset)
    want = cuda_glcm.sufficient_stats_reference(t, levels=256, offset=offset)
    torch.cuda.synchronize()
    assert cuda_glcm.LAUNCHES == before + 1
    _assert_stats_equal(got, want)


@pytest.mark.parametrize("shape,offset,mask,need_diff", [
    ((64, 3, 64, 64), (0, 5), "per_channel", False),
    ((64, 12, 48, 48), (0, 5), "shared", False),
    ((3, 2, 64, 64), (3, -2), "per_channel", False),
    ((3, 2, 37, 53), (-2, 1), "shared", False),
    ((64, 3, 64, 64), (0, 5), None, True),
    ((3, 2, 64, 64), (-2, 1), "shared", True),
    ((2, 2, 72, 72), (0, 5), None, True),
])
def test_masked_and_diff_forms_match_plain_on_card(shape, offset, mask, need_diff):
    """B1b (masked) and B1c (need_diff, masked or not) against the plain
    version; the edge mask has empty, one-pixel and full (image, channel)s."""
    dev = require_cuda()
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, size=shape, dtype=np.int32)
    x[0, -1] = 0  # all-zero channel
    t = torch.from_numpy(x).to(dev)
    m = None
    if mask is not None:
        m = torch.from_numpy(_edge_mask(rng, shape, mask == "shared")).to(dev)
    form = "B1c" if need_diff else "B1b"
    before = dict(cuda_glcm.LAUNCHES_BY_FORM)
    got = cuda_glcm.sufficient_stats(t, m, levels=256, offset=offset, need_diff=need_diff)
    want = cuda_glcm.sufficient_stats_reference(t, m, levels=256, offset=offset, need_diff=need_diff)
    torch.cuda.synchronize()
    assert cuda_glcm.LAUNCHES_BY_FORM[form] == before[form] + 1
    _assert_stats_equal(got, want)
    if m is not None:
        assert int(got.vmax[0, 0]) == -1 and float(got.count[0, 0]) == 0
        assert float(got.pair_count[-1, -1]) == 0 and float(got.count[-1, -1]) == 1


@pytest.mark.parametrize("masked,need_diff", [(False, False), (True, False), (True, True)])
def test_multi_offset_form_matches_plain_on_card(masked, need_diff):
    """B2: four offsets of both signs in one pass, each offset's statistics
    equal to the plain version's (G re-zeroed between offsets)."""
    dev = require_cuda()
    rng = np.random.default_rng(2)
    shape = (64, 3, 64, 64)
    x = torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.int32)).to(dev)
    m = torch.from_numpy(_edge_mask(rng, shape, True)).to(dev) if masked else None
    offsets = [(0, 5), (4, 4), (5, 0), (4, -4)]
    before = cuda_glcm.LAUNCHES_BY_FORM["B2"]
    got = cuda_glcm.sufficient_stats_multi(x, m, levels=256, offsets=offsets, need_diff=need_diff)
    want = cuda_glcm.sufficient_stats_multi_reference(
        x, m, levels=256, offsets=offsets, need_diff=need_diff
    )
    torch.cuda.synchronize()
    assert cuda_glcm.LAUNCHES_BY_FORM["B2"] == before + 1
    assert len(got) == 4
    for g, w in zip(got, want):
        _assert_stats_equal(g, w)


@pytest.mark.parametrize("case", ["u16_overflow", "levels_1024_masked", "multi_offset_256px"])
def test_large_form_matches_plain_on_card(case):
    """B1d: a constant 300x300 channel whose one G cell holds 89,700 pairs
    (past u16), 1024 levels under a shared cell mask, and three offsets of
    both signs at 256x256 with a per-channel mask, each bit-equal to the
    plain version."""
    dev = require_cuda()
    rng = np.random.default_rng(5)
    m = None
    offsets = [(0, 1)]
    if case == "u16_overflow":
        levels = 256
        x = rng.integers(0, levels, size=(2, 2, 300, 300), dtype=np.int32)
        x[0, 0] = 200
    elif case == "levels_1024_masked":
        levels = 1024
        x = rng.integers(0, levels, size=(16, 3, 48, 48), dtype=np.int32)
        x[1, 2] = 0  # all-zero channel
        m = torch.from_numpy(_edge_mask(rng, x.shape, True)).to(dev)
        offsets = [(0, 5)]
    else:
        levels = 512
        x = rng.integers(0, levels, size=(2, 2, 256, 256), dtype=np.int32)
        m = torch.from_numpy(_edge_mask(rng, x.shape, False)).to(dev)
        offsets = [(0, 5), (3, -2), (-4, 1)]
    t = torch.from_numpy(x).to(dev)
    before = dict(cuda_glcm.LAUNCHES_BY_FORM)
    got = cuda_glcm.sufficient_stats_multi(t, m, levels=levels, offsets=offsets, need_diff=True)
    want = cuda_glcm.sufficient_stats_multi_reference(t, m, levels=levels, offsets=offsets, need_diff=True)
    torch.cuda.synchronize()
    assert cuda_glcm.LAUNCHES_BY_FORM["B1d"] == before["B1d"] + 1
    assert {f: n - before[f] for f, n in cuda_glcm.LAUNCHES_BY_FORM.items()} == {
        f: int(f == "B1d") for f in before}
    for g, w in zip(got, want):
        _assert_stats_equal(g, w)
    if case == "u16_overflow":
        assert int(got[0].glcm_sumsq[0, 0, 0]) == (89_700 >> 12) ** 2


@pytest.mark.parametrize("case", [
    "one_level_64", "one_level_48", "constant_128", "random_48_L1024", "random_64_L4096",
    "empty_and_one_pixel_mask", "four_offsets", "scalar_loads_37x53",
])
def test_pair_table_hazards_match_plain_on_card(case):
    """The pair table's hazards, each bit-equal to the plain version: one
    level in every pixel (one key takes every pair, the largest warp
    groups), a constant 128x128 channel (16,256 pairs in one cell, past the
    generic a-limb), random levels at 1024 and 4096 levels (a table nearly
    full of distinct keys), an empty and a one-pixel mask, 4 offsets reusing
    the table, and 37x53 (the scalar load path) under a mask."""
    dev = require_cuda()
    rng = np.random.default_rng(6)
    levels, offsets, need_diff, m = 256, [(0, 5)], False, None
    if case.startswith("one_level"):
        hw = int(case[-2:])
        x = np.full((3, 2, hw, hw), 9, np.int32)
    elif case == "constant_128":
        x, offsets = np.full((2, 1, 128, 128), 200, np.int32), [(0, 1)]
    elif case.startswith("random"):
        hw, levels = (48, 1024) if case == "random_48_L1024" else (64, 4096)
        x, need_diff = rng.integers(0, levels, size=(4, 2, hw, hw), dtype=np.int32), True
    elif case == "empty_and_one_pixel_mask":
        x = rng.integers(0, 256, size=(3, 2, 48, 48), dtype=np.int32)
        m = np.zeros((3, 1, 48, 48), np.uint8)
        m[1, 0, 20, 20] = 1
        m[2] = 1
    elif case == "four_offsets":
        x = rng.integers(0, 6, size=(4, 3, 48, 48), dtype=np.int32) * 51
        m = _edge_mask(rng, x.shape, True)
        offsets = [(0, 5), (4, 4), (5, 0), (4, -4)]
    else:
        x = rng.integers(0, 256, size=(3, 2, 37, 53), dtype=np.int32)
        m = _edge_mask(rng, x.shape, False)
    assert cuda_glcm.pair_table_slots(*x.shape[2:], offsets, levels) > 0
    t = torch.from_numpy(x).to(dev)
    mt = None if m is None else torch.from_numpy(m).to(dev)
    got = cuda_glcm.sufficient_stats_multi(t, mt, levels=levels, offsets=offsets, need_diff=need_diff)
    want = cuda_glcm.sufficient_stats_multi_reference(t, mt, levels=levels, offsets=offsets,
                                                       need_diff=need_diff)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_stats_equal(g, w)
    if case == "constant_128":
        assert int(got[0].glcm_sumsq[0, 0, 0]) == (16_256 >> 12) ** 2


@pytest.mark.parametrize("shape,levels,masked,need_diff,min_blocks", [
    ((2048, 3, 64, 64), 256, False, False, 3),
    ((2048, 12, 48, 48), 256, True, False, 3),
    ((2048, 12, 48, 48), 1024, True, True, 2),
])
def test_main_path_shapes_take_the_table_with_several_blocks_per_sm(
        shape, levels, masked, need_diff, min_blocks):
    require_cuda()
    info = cuda_glcm.launch_info(shape, levels, [(0, 5)], masked=masked, need_diff=need_diff)
    assert info["layout"] == "table" and info["plane_in_smem"], info
    assert info["blocks_per_sm"] >= min_blocks, info


def test_a_table_too_large_for_shared_memory_takes_the_bands():
    """128x128 at 1024 levels: the pair table (32,768 u64 slots) is smaller
    than G, so the wrapper asks for it, but with the per-level tables it
    passes the shared memory a block may hold; the kernel plans the bands
    and stays bit-equal."""
    dev = require_cuda()
    shape, levels, offsets = (2, 2, 128, 128), 1024, [(0, 1)]
    assert cuda_glcm.pair_table_slots(*shape[2:], offsets, levels) == 32768
    info = cuda_glcm.launch_info(shape, levels, offsets, masked=False, need_diff=True)
    assert info["layout"] == "bands" and info["table_slots"] == 0, info
    x = torch.from_numpy(np.random.default_rng(8).integers(0, levels, size=shape, dtype=np.int32)).to(dev)
    got = cuda_glcm.sufficient_stats(x, levels=levels, offset=offsets[0], need_diff=True)
    want = cuda_glcm.sufficient_stats_reference(x, levels=levels, offset=offsets[0], need_diff=True)
    torch.cuda.synchronize()
    _assert_stats_equal(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    dev = require_cuda()
    x = torch.zeros((1, 1, 8, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        cuda_glcm.sufficient_stats(x.to(torch.int64), levels=256, offset=(0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_glcm.sufficient_stats(x.transpose(2, 3), levels=256, offset=(0, 1))
    with pytest.raises(ValueError, match="32768 levels"):
        cuda_glcm.sufficient_stats(x, levels=32769, offset=(0, 1), need_diff=True)
    with pytest.raises(ValueError, match="need_diff=False"):
        cuda_glcm.sufficient_stats(x, levels=512, offset=(0, 1))
    with pytest.raises(ValueError, match="need_diff=False"):
        cuda_glcm.sufficient_stats(x, levels=8192, offset=(0, 1))
    with pytest.raises(ValueError, match="need_diff=False"):
        cuda_glcm.sufficient_stats_multi(
            torch.zeros((1, 1, 256, 256), dtype=torch.int32, device=dev),
            levels=256, offsets=[(0, 1), (1, 0)],
        )
    with pytest.raises(ValueError, match="mask"):
        cuda_glcm.sufficient_stats(x, torch.ones((1, 1, 8, 8), dtype=torch.bool, device=dev),
                                   levels=256, offset=(0, 1))
    # one launch takes at most 16 offsets; the entry point runs several
    with pytest.raises(ValueError, match="offsets"):
        cuda_glcm._launch(x, None, 256, [(0, 1)] * 17, False)
    with pytest.raises(ValueError, match="at least one offset"):
        cuda_glcm.sufficient_stats_multi(x, levels=256, offsets=[])
    assert len(cuda_glcm.sufficient_stats_multi(x, levels=256, offsets=[(0, 1)] * 17)) == 17
    # the need_diff form launches and equals its plain version
    got = cuda_glcm.sufficient_stats(x, levels=256, offset=(0, 1), need_diff=True)
    want = cuda_glcm.sufficient_stats_reference(x, levels=256, offset=(0, 1), need_diff=True)
    _assert_stats_equal(got, want)


def test_slice_on_card_matches_cpu():
    dev = require_cuda()
    import tpumcia_torch as tt
    from tpumcia_torch.io.synthetic import synthetic_mednist

    gray, labels, _ = synthetic_mednist(30, num_classes=6, seed=3)
    noise = np.random.default_rng(3).normal(0, 0.1, size=(*gray.shape, 2))
    x = np.concatenate(
        [gray[..., None], (np.clip(noise, 0, 1) * 255).astype(np.uint8)], axis=-1
    )
    cfg = {"head": {"num_steps": 60}, "fast_path": "always", "batch_size": 64,
           "split": {"stratify": True}}
    before = cuda_glcm.LAUNCHES
    card = tt.run_pipeline(x, labels, config=cfg, device=dev)
    assert cuda_glcm.LAUNCHES == before + 3  # 180 images in batches of 64
    cpu = tt.run_pipeline(x, labels, config=cfg, device="cpu")
    np.testing.assert_allclose(card.features.values, cpu.features.values, rtol=0, atol=1e-5)
    assert card.channel_result.ranking[0] == 0 and cpu.channel_result.ranking[0] == 0
    with pytest.raises(ValueError, match="CUDA kernel"):
        tt.run_pipeline(x, labels, config={**cfg, "features": {"use_pallas": "never"}}, device=dev)


def test_extract_features_on_card_matches_cpu():
    """Masked exact extraction (B1c) on the card equals the CPU's bit for
    bit; masked hybrid (B1b) and a 4-offset hybrid call (B2) agree with the
    CPU to 1e-5."""
    dev = require_cuda()
    import tpumcia_torch as tt

    rng = np.random.default_rng(4)
    x = (rng.random((40, 64, 64, 3)) * 256).astype(np.uint8)
    m = rng.random((40, 64, 64, 3)) > 0.2
    m[0, :, :, 0] = False  # empty mask
    multi = tt.FeatureConfig(glcm=tt.GLCMConfig(distance=5, angle=(0.0, 0.785398, 1.570796, 2.356194)))
    for cfg, atol in [(tt.FeatureConfig(precision="exact"), 0.0), (tt.FeatureConfig(), 1e-5), (multi, 1e-5)]:
        card = tt.extract_features(x, m, device=dev, config=cfg)
        cpu = tt.extract_features(x, m, device="cpu", config=cfg)
        np.testing.assert_array_equal(np.isnan(card.values), np.isnan(cpu.values))
        np.testing.assert_allclose(card.values, cpu.values, rtol=0, atol=atol)
        np.testing.assert_array_equal(card.degenerate, cpu.degenerate)
    dev_vals = tt.extract_features(x, m, device=dev, config=tt.FeatureConfig(precision="device"))
    assert dev_vals.values.device.type == "cuda" and dev_vals.values.dtype == torch.float32


def test_forest_fit_on_card_equals_cpu_fit():
    """The same seed grows the same forest on the card and on the CPU (every
    split sum is an integer in float64), and the walk kernel's shares on the
    card equal its plain version's there bit for bit, and the CPU forest's
    within 1e-6 (the card divides by T as a product with 1/T)."""
    from tpumcia_torch.models import forest_device

    dev = require_cuda()
    from tpumcia_torch.config import HeadConfig
    from tpumcia_torch.models.heads import fit_head

    rng = np.random.default_rng(0)
    y = rng.integers(0, 4, 600)
    X = rng.normal(size=(600, 30)).astype(np.float32)
    X[:, :3] += y[:, None]
    X[:, 5] = np.round(X[:, 5])  # ties in a column
    cfg = HeadConfig(kind="random_forest", n_estimators=10, seed=3)
    card = fit_head(X, y, device=dev, config=cfg)
    cpu = fit_head(X, y, device="cpu", config=cfg)
    for a, b in zip(card.trees, cpu.trees):
        for name in ("children_left", "children_right", "feature", "threshold", "value", "impurity",
                     "n_node_samples", "weighted_n_node_samples"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    f = card.to_device()
    x = card.scaler.transform(torch.from_numpy(X).to(dev))
    shares = f.apply(x)
    assert torch.equal(shares, forest_device._apply_walk(x, f.nodes, f.roots, f.values)[0])
    torch.testing.assert_close(shares.cpu(), cpu.to_device().apply(x.cpu()), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(card.predict(X), cpu.predict(X))


def test_forest_fit_on_card_waits_once_a_level():
    """``fit_forest`` on the card makes no blocking call but its one event
    wait a level: under ``torch.cuda.set_sync_debug_mode("warn")`` nothing
    else is flagged, and that wait is flagged once a level or never (as
    this torch flags an event's wait or not; if never, ``"error"`` raises
    nothing; a read-back after the fit is flagged, so the flags are seen);
    ``forest_fit_waits`` equals ``forest_levels``, and the trees equal the
    CPU fit's."""
    import inspect
    import os
    import warnings

    dev = require_cuda()
    from tpumcia_torch.models import forest_fit
    from tpumcia_torch.utils import profiling

    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.integers(0, 3, 500))
    X = rng.normal(size=(500, 20)).astype(np.float32)
    X[:, :2] += y.numpy()[:, None]
    Xd = torch.from_numpy(X).to(dev)
    torch.cuda.synchronize()

    def fit(X):
        return forest_fit.fit_forest(X, y, 3, n_estimators=6, max_depth=None, seed=5)

    lines, first = inspect.getsourcelines(forest_fit._read_back)
    wait_line = first + [i for i, line in enumerate(lines) if "copied.synchronize()" in line][0]
    wait_at = f"{os.path.realpath(inspect.getsourcefile(forest_fit))}:{wait_line}"
    profiling.reset_counters()
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            card = fit(Xd)
            in_fit = len(seen)
            Xd.sum().item()  # a read-back, flagged: shows the filter below sees flags
    finally:
        torch.cuda.set_sync_debug_mode(0)

    def syncs_in(warned):
        return [f"{os.path.realpath(w.filename)}:{w.lineno}" for w in warned
                if "called a synchronizing CUDA operation" in str(w.message)]

    assert len(syncs_in(seen[in_fit:])) == 1, [str(w.message) for w in seen]
    syncs = syncs_in(seen[:in_fit])
    levels = profiling.COUNTERS["forest_levels"]
    assert profiling.COUNTERS["forest_fit_waits"] == levels > 5
    assert [s for s in syncs if s != wait_at] == [] and len(syncs) in (0, levels), (wait_at, levels, syncs)
    if not syncs:
        try:
            torch.cuda.set_sync_debug_mode("error")
            fit(Xd)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(card, fit(torch.from_numpy(X)), strict=True):
        for name in ("children_left", "children_right", "feature", "threshold", "value", "impurity",
                     "n_node_samples", "weighted_n_node_samples"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def test_morphology_on_card_matches_cpu():
    dev = require_cuda()
    from tpumcia_torch.config import FeatureConfig
    from tpumcia_torch.features.extract import extract_features
    from tpumcia_torch.features.morphology import morphology_features

    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, size=(64, 48, 48, 4)).astype(np.uint8)
    yy, xx = np.mgrid[:48, :48]
    mask = np.hypot(yy - 24, xx - 24)[None] < rng.uniform(5, 20, size=(64, 1, 1))
    torch.testing.assert_close(morphology_features(mask, device=dev).cpu(),
                               morphology_features(mask, device="cpu"), rtol=1e-5, atol=1e-5)
    cfg = FeatureConfig(include_morphology=True)
    card = extract_features(images, mask, device=dev, config=cfg)
    cpu = extract_features(images, mask, device="cpu", config=cfg)
    np.testing.assert_allclose(card.values[:, -32:], cpu.values[:, -32:], rtol=1e-5, atol=1e-5)


def test_twenty_offsets_on_card_match_plain():
    """More offsets than the kernel's argument holds: two launches, each
    counted, bit-equal to the plain version; masked and with the difference
    histogram too; ``extract_features``' 20-block wire against the CPU."""
    dev = require_cuda()
    import tpumcia_torch as tt

    rng = np.random.default_rng(20)
    offsets = [(dr, dc) for dr in (-3, -1, 0, 2) for dc in range(0, 5)]
    assert len(offsets) == 20 > cuda_glcm.MAX_OFFSETS
    x = torch.from_numpy(rng.integers(0, 256, size=(64, 3, 64, 64), dtype=np.int32)).to(dev)
    m = torch.from_numpy(_edge_mask(rng, (64, 3, 64, 64), shared=False)).to(dev)
    for mask, need_diff in [(None, False), (m, False), (m, True)]:
        cuda_glcm.reset_launch_counts()
        got = cuda_glcm.sufficient_stats_multi(x, mask, levels=256, offsets=offsets, need_diff=need_diff)
        assert cuda_glcm.LAUNCHES == 2 and cuda_glcm.LAUNCHES_BY_FORM["B2"] == 2
        want = cuda_glcm.sufficient_stats_multi_reference(x, mask, levels=256, offsets=offsets, need_diff=need_diff)
        assert len(got) == 20
        for g, w in zip(got, want):
            _assert_stats_equal(g, w)
        tail = cuda_glcm.sufficient_stats_multi(x, mask, levels=256, offsets=offsets[16:], need_diff=need_diff)
        assert torch.equal(tail[0].hist, got[0].hist) and torch.equal(tail[0].vmax, got[0].vmax)
    imgs = x.permute(0, 2, 3, 1).to(torch.uint8).cpu().numpy()
    cfg = tt.FeatureConfig(glcm=tt.GLCMConfig(distance=(1, 2, 3, 4, 5), angle=(0.0, 0.785398, 1.570796, 2.356194)))
    card = tt.extract_features(imgs, device=dev, config=cfg)
    cpu = tt.extract_features(imgs, device="cpu", config=cfg)
    assert card.shape == (64, 3 * (17 + 20 * 6))
    np.testing.assert_allclose(card.values, cpu.values, rtol=0, atol=1e-5)


def test_no_plain_version_on_the_card():
    """A CUDA device launches the kernel or raises: ``use_pallas='never'``
    and sizes past the kernel's bounds (2^24 pixels) raise from every entry
    point and launch nothing; inside the bounds ``'auto'`` and ``'always'``
    launch, and 8192 levels launch form B1e and match the CPU."""
    dev = require_cuda()
    import tpumcia_torch as tt
    from tpumcia_torch.pipeline.streaming import stream_extract

    rng = np.random.default_rng(21)
    x = (rng.random((40, 32, 32, 3)) * 256).astype(np.uint8)
    m = rng.random((40, 32, 32, 3)) > 0.2
    for value in ("auto", "always"):
        cuda_glcm.reset_launch_counts()
        tt.extract_features(x, m, device=dev, config=tt.FeatureConfig(use_pallas=value))
        assert cuda_glcm.LAUNCHES == 1 and cuda_glcm.LAUNCHES_BY_FORM["B1b"] == 1
    cuda_glcm.reset_launch_counts()
    never = tt.FeatureConfig(use_pallas="never")
    with pytest.raises(ValueError, match="CUDA kernel"):
        tt.extract_features(x, m, device=dev, config=never)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tt.extract_features_batched(x, m, device=dev, batch_size=16, config=never)
    with pytest.raises(ValueError, match="CUDA kernel"):
        stream_extract(lambda idx: x[idx], len(x), "unused", device=dev, shard_size=16, config=never)
    huge = torch.zeros((1, 1, 4096, 4096), dtype=torch.int32, device=dev)  # 2^24 pixels
    with pytest.raises(ValueError, match="16777215 pixels"):
        cuda_glcm.sufficient_stats(huge, levels=256, offset=(0, 1), need_diff=True)
    with pytest.raises(ValueError, match="16777215 pixels"):
        cuda_glcm.sufficient_stats(huge, levels=8192, offset=(0, 1), need_diff=True)
    del huge
    assert cuda_glcm.past_kernel_bounds(1 << 24, 256) and not cuda_glcm.past_kernel_bounds((1 << 24) - 1, 32768)
    assert cuda_glcm.LAUNCHES == 0
    assert set(cuda_glcm.LAUNCHES_BY_FORM) == {"B1a", "B1b", "B1c", "B2", "B1d", "B1e"}
    big = rng.integers(0, 8192, size=(4, 48, 48, 1), dtype=np.int32)
    cfg = tt.FeatureConfig(glcm=tt.GLCMConfig(levels=8192))
    card = tt.extract_features(big, device=dev, config=cfg)
    assert cuda_glcm.LAUNCHES == 1 and cuda_glcm.LAUNCHES_BY_FORM["B1e"] == 1
    cpu = tt.extract_features(big, device="cpu", config=cfg)
    np.testing.assert_allclose(card.values, cpu.values, rtol=0, atol=1e-5)


def _b1e_case(dev, shape, levels, offsets, *, masked, fill=None, seed=30, x=None):
    """One B1e call against the plain version, bit-equal; returns the
    statistics. ``x``: the levels, else random ones."""
    rng = np.random.default_rng(seed)
    if x is None:
        x = rng.integers(0, levels, size=shape, dtype=np.int32)
        x[0, 0, :2, :2] = levels - 1
    for (b, c), v in (fill or {}).items():
        x[b, c] = v
    t = torch.from_numpy(x).to(dev)
    m = torch.from_numpy(_edge_mask(rng, shape, shared=True)).to(dev) if masked else None
    cuda_glcm.reset_launch_counts()
    got = cuda_glcm.sufficient_stats_multi(t, m, levels=levels, offsets=offsets, need_diff=True)
    want = cuda_glcm.sufficient_stats_multi_reference(t, m, levels=levels, offsets=offsets, need_diff=True)
    torch.cuda.synchronize()
    assert cuda_glcm.LAUNCHES == 1 and cuda_glcm.LAUNCHES_BY_FORM["B1e"] == 1
    assert len(got) == len(offsets)
    for g, w in zip(got, want):
        _assert_stats_equal(g, w)
    return got


@pytest.mark.parametrize("levels", [8192, 16384, 32768])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("offsets", [[(0, 5)], [(0, 5), (4, 4), (5, 0), (4, -4)]])
def test_b1e_matches_plain_past_4096_levels(levels, masked, offsets):
    """Form B1e on 8x1x64x64 random levels with a constant and an all-zero
    channel (8 items: several blocks share each); the edge mask has an
    empty and a one-pixel (image, channel)."""
    dev = require_cuda()
    got = _b1e_case(dev, (8, 1, 64, 64), levels, offsets, masked=masked,
                    fill={(2, 0): 0, (3, 0): levels - 1, (4, 0): levels // 3})
    if masked:
        assert int(got[0].vmax[0, 0]) == -1 and float(got[0].count[0, 0]) == 0
        assert float(got[0].pair_count[-1, -1]) == 0 and float(got[0].count[-1, -1]) == 1


@pytest.mark.parametrize("shape,levels,masked,layout", [
    ((3, 2, 37, 53), 8192, True, "level bands"),  # the scalar load path
    ((3, 2, 37, 53), 5001, False, "level bands"),  # a level count that no power of two divides
    ((600, 2, 16, 16), 8192, True, "level bands"),  # more items than resident blocks: every block loops
    ((8, 1, 64, 64), 32768, False, "level bands"),  # fewer items: several blocks share each
    ((2, 2, 128, 128), 8192, False, "level bands, table in workspace"),  # 32,768 slots, 256 KB
    ((1, 1, 300, 300), 4097, True, "level bands, table and plane in workspace"),
])
def test_b1e_shapes_and_layouts(shape, levels, masked, layout):
    dev = require_cuda()
    offsets = [(1, 2), (-2, 1)]
    info = cuda_glcm.launch_info(shape, levels, offsets, masked=masked, need_diff=True)
    items = shape[0] * shape[1]
    resident = info["blocks_per_sm"] * torch.cuda.get_device_properties(dev).multi_processor_count
    assert info["layout"] == layout, info
    assert info["workspace_bytes"] == info["grid_blocks"] * info["slice_bytes"], info
    assert (info["workspace_bytes"] == 0) == (layout == "level bands"), info
    # blocks share an item only where items leave blocks idle and need no workspace
    assert (info["parts"] > 1) == (layout == "level bands" and items < resident), info
    assert info["grid_blocks"] == min(items * info["parts"], resident), info
    _b1e_case(dev, shape, levels, offsets, masked=masked, seed=31)


@pytest.mark.parametrize("levels", [5001, 8192, 20011, 32768])
@pytest.mark.parametrize("masked", [False, True])
def test_b1e_band_edges(levels, masked):
    """Levels at the first and last entry of every level band (histogram,
    both marginals, the difference histogram), 0 and L - 1, and the
    differences +-(L - 1), on 8 items that several blocks share; 5001 and
    20011 levels leave rows that no 16 bytes align."""
    dev = require_cuda()
    from chip_smoke import band_edge_planes

    info = cuda_glcm.launch_info((8, 1, 64, 64), levels, [(0, 1)], masked=masked, need_diff=True)
    assert info["layout"] == "level bands" and info["parts"] > 1, info
    x = band_edge_planes(levels, info["band_levels"], 8, seed=32)
    got = _b1e_case(dev, x.shape, levels, [(0, 1)], masked=masked, seed=32, x=x)
    if not masked:
        dh = got[0].diff_hist.cpu().numpy()
        assert (dh[:, :, 0] > 0).all() and (dh[:, :, -1] > 0).all()  # -(L - 1) and L - 1
        assert (got[0].hist.cpu().numpy()[:, :, [0, -1]] > 0).all()


def test_batched_extraction_from_host_is_bounded_and_bit_equal():
    """A collection on the host crosses a batch at a time: the same bytes as
    the collection uploaded whole and sliced on the card, for every
    ``in_flight``, with the peak device memory far under the collection's
    int32 size."""
    dev = require_cuda()
    import tpumcia_torch as tt

    rng = np.random.default_rng(22)
    n, batch = 4000, 256  # 16 batches, the last wrap-padded
    x = rng.integers(0, 256, size=(n, 48, 48, 12), dtype=np.uint8)
    m = rng.random((n, 48, 48)) < 0.7
    whole = tt.extract_features_batched(
        torch.from_numpy(x).to(dev), torch.from_numpy(m).to(dev), device=dev, batch_size=batch)
    torch.cuda.synchronize()
    for in_flight in (1, 2, 8):
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        cuda_glcm.reset_launch_counts()
        got = tt.extract_features_batched(x, m, device=dev, batch_size=batch, in_flight=in_flight)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated(dev) - base
        assert cuda_glcm.LAUNCHES_BY_FORM["B1b"] == 16
        np.testing.assert_array_equal(got.values, whole.values)
        np.testing.assert_array_equal(got.degenerate, whole.degenerate)
        assert rise < x.size * 4 / 2, (in_flight, rise)  # the whole collection as int32: 442 MB
    pending = tt.extract_features_pending(x, m, device=dev, batch_size=batch, keep_device_values=True, in_flight=2)
    assert tuple(pending.device_values.shape) == (n, 276) and pending.device_values.device.type == "cuda"
    np.testing.assert_array_equal(pending.result().values, whole.values)


def test_stream_extract_on_card_staged_equals_unstaged(tmp_path):
    """Uploads on the prefetch worker (pinned ring, side stream) or in the
    consumer: the same shard files; a partial last shard; fetches that
    return tensors on the card; the non-wire branch."""
    dev = require_cuda()
    import tpumcia_torch as tt
    from tpumcia_torch.pipeline.streaming import stream_extract

    rng = np.random.default_rng(23)
    n, shard = 1100, 128  # 9 shards, the last of 76
    x = rng.integers(0, 256, size=(n, 48, 48, 12), dtype=np.uint8)
    m = (rng.random((n, 48, 48)) < 0.7).astype(np.uint8)
    labels = rng.integers(0, 3, size=n)

    def fetch(idx):
        return x[idx], m[idx], labels[idx]

    def fetch_on_card(idx):
        return torch.from_numpy(x[idx]).to(dev), torch.from_numpy(m[idx]).to(dev), labels[idx]

    cuda_glcm.reset_launch_counts()
    staged = stream_extract(fetch, n, tmp_path / "staged", device=dev, shard_size=shard)
    assert staged.shards_computed == 9 and cuda_glcm.LAUNCHES_BY_FORM["B1b"] == 9
    direct = tt.extract_features_batched(x, m, device=dev, batch_size=shard)
    np.testing.assert_array_equal(staged.features.values, direct.values)
    np.testing.assert_array_equal(staged.labels, labels)
    for name, kw in [("unstaged", dict(stage_on_device=False)), ("sync", dict(prefetch_depth=0)),
                     ("deep", dict(prefetch_depth=4))]:
        other = stream_extract(fetch, n, tmp_path / name, device=dev, shard_size=shard, **kw)
        np.testing.assert_array_equal(other.features.values, staged.features.values)
    on_card = stream_extract(fetch_on_card, n, tmp_path / "card", device=dev, shard_size=shard)
    np.testing.assert_array_equal(on_card.features.values, staged.features.values)
    exact = tt.FeatureConfig(precision="exact")
    cuda_glcm.reset_launch_counts()
    ex = stream_extract(fetch, 300, tmp_path / "exact", device=dev, shard_size=shard, config=exact)
    assert cuda_glcm.LAUNCHES_BY_FORM["B1c"] == 3
    np.testing.assert_array_equal(
        ex.features.values, tt.extract_features(x[:300], m[:300], device="cpu", config=exact).values)
    again = stream_extract(fetch, n, tmp_path / "staged", device=dev, shard_size=shard)
    assert (again.shards_computed, again.shards_skipped) == (0, 9)


def test_cnn_path_on_card_matches_cpu():
    """A tiny ResNet on the card: the float32 model against the same weights
    on the CPU (TF32 off: 1e-4 on logits), the bf16 model close to it, a
    short ``fit_cnn`` that learns, and the probes' shapes. It launches no
    GLCM kernel."""
    dev = require_cuda()
    from tpumcia_torch.importance.occlusion import (
        channel_occlusion_importance,
        channel_permutation_importance_images,
        occlusion_map,
    )
    from tpumcia_torch.io.synthetic import synthetic_multichannel
    from tpumcia_torch.models.cnn import init_parameters, make_resnet
    from tpumcia_torch.models.train import CNNConfig, CNNHead, fit_cnn

    images, labels, _ = synthetic_multichannel(32, num_classes=3, hw=32, seed=9, device=dev)
    x = images.astype(np.float32) / 255.0
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = make_resnet(3, in_channels=3, width=16, depth="10", dtype=torch.float32)
        init_parameters(ref, torch.Generator().manual_seed(1))
        card = make_resnet(3, in_channels=3, width=16, depth="10", dtype=torch.float32)
        card.load_state_dict(ref.state_dict())
        card = card.to(dev, memory_format=torch.channels_last)
        with torch.no_grad():
            want = ref(torch.from_numpy(x[:16]))
            got = card(torch.from_numpy(x[:16]).to(dev)).cpu()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    cuda_glcm.reset_launch_counts()
    cfg = CNNConfig(num_classes=3, width=16, depth="10", epochs=6, batch_size=16, learning_rate=3e-3)
    head = fit_cnn(x, labels, device=dev, config=cfg)
    assert head.device.type == "cuda" and head.history[-1]["loss"] < head.history[0]["loss"]
    assert head.score(x, labels) > 0.6
    f32 = make_resnet(3, in_channels=3, width=16, depth="10", dtype=torch.float32)
    f32.load_state_dict(head.model.state_dict())
    f32_head = CNNHead(model=f32.to(dev, memory_format=torch.channels_last), classes=head.classes)
    torch.testing.assert_close(head.predict_logits(x), f32_head.predict_logits(x), rtol=0, atol=0.25)
    occ = channel_occlusion_importance(head, x, labels)
    perm = channel_permutation_importance_images(head, x, labels, n_repeats=3)
    assert occ.shape == (3,) and perm.shape == (3, 3) and occ[0] == occ.max()
    assert occlusion_map(head, x[:4], labels[:4]).shape == (4, 4, 4)
    assert cuda_glcm.LAUNCHES == 0


def test_eval_cli_on_card(tmp_path):
    """``python -m tpumcia_torch.eval`` in process, its default device: both
    events, channel 0 first, the kernel launched."""
    require_cuda()
    import json

    from tpumcia_torch import eval as eval_cli

    metrics = tmp_path / "m.jsonl"
    cuda_glcm.reset_launch_counts()
    assert eval_cli.main(["--source", "synthetic", "--n-per-class", "40", "--metrics", str(metrics)]) == 0
    events = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [e["event"] for e in events] == ["data_loaded", "pipeline_done"]
    assert events[1]["channel_ranking"][0] == 0 and cuda_glcm.LAUNCHES_BY_FORM["B1a"] == 1


def test_two_slots_on_the_card_match_one_slot_float32():
    """The CNN's data-parallel step over two slots on ``cuda:0`` against one
    backward over the whole batch, float32 with TF32 off and cuDNN
    deterministic, three steps from the same weights each time: reduced
    gradients within 1e-5 x max |g|, losses rel 1e-4. At full width
    (``chip_smoke.py`` phase 16 (a')) the two float32 gradients round ~1e-4
    of max |g| apart, so that phase holds them against a float64 copy."""
    dev = require_cuda()
    import torch.nn.functional as F

    from tpumcia_torch.models.cnn import init_parameters, make_resnet
    from tpumcia_torch.models.train import CNNConfig, make_optimizer
    from tpumcia_torch.parallel import make_mesh, reduce_gradients, replicate

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.random((3, 16, 16, 16, 3), dtype=np.float32)).to(dev)
        y = torch.from_numpy(rng.integers(0, 3, (3, 16))).to(dev)
        one = make_resnet(3, in_channels=3, width=8, depth="10", dtype=torch.float32)
        init_parameters(one, torch.Generator().manual_seed(0))
        one = one.to(dev, memory_format=torch.channels_last)
        two = make_resnet(3, in_channels=3, width=8, depth="10", dtype=torch.float32).to(
            dev, memory_format=torch.channels_last)
        mesh = make_mesh(devices=[dev, dev])
        replicas = replicate(two, mesh)
        optimizer = make_optimizer(one, CNNConfig(num_classes=3))
        for step in range(3):
            two.load_state_dict(one.state_dict())
            optimizer.zero_grad(set_to_none=True)
            loss = F.cross_entropy(one(x[step]), y[step])
            loss.backward()
            got = reduce_gradients(replicas, mesh, x[step], y[step])
            g1 = torch.cat([p.grad.reshape(-1) for p in one.parameters()])
            g2 = torch.cat([p.grad.reshape(-1) for p in two.parameters()])
            assert float((g2 - g1).abs().max()) <= 1e-5 * float(g1.abs().max()), step
            torch.testing.assert_close(got, loss.detach(), rtol=1e-4, atol=0)
            optimizer.step()
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags


@pytest.mark.parametrize("masked", [False, True])
def test_stats_level_call_defaults_to_the_card(masked):
    """tpumcia's stats-level ``sufficient_stats(_multi)`` with no
    ``device=``: one B1c launch (one B2 for several offsets) on the card,
    bit-equal to the plain version on the CPU."""
    require_cuda()
    from tpumcia_torch.features import stats

    def on_cpu(st):
        return type(st)(*(None if f is None else f.cpu() for f in st))

    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, size=(16, 48, 48, 4)).astype(np.uint8)
    mask = rng.random((16, 48, 48)) < 0.7 if masked else None
    cuda_glcm.reset_launch_counts()
    got = stats.sufficient_stats(x, mask)
    assert cuda_glcm.LAUNCHES == cuda_glcm.LAUNCHES_BY_FORM["B1c"] == 1 and got.hist.device.type == "cuda"
    _assert_stats_equal(on_cpu(got), stats.sufficient_stats(x, mask, device="cpu"))
    offsets = ((0, 5), (4, 4), (5, 0))
    multi = stats.sufficient_stats_multi(x, mask, offsets=offsets)
    assert cuda_glcm.LAUNCHES_BY_FORM["B2"] == 1
    for g, w in zip(multi, stats.sufficient_stats_multi(x, mask, offsets=offsets, device="cpu")):
        _assert_stats_equal(on_cpu(g), w)


def test_bench_torch_on_the_card():
    """``bench_torch.py --cell all --reps 2`` on the card: exit 0, one line a
    cell, each correct by its gates (6 B1a / 8 B1b launches a run, the
    accuracy, the signal channel, donors), every metric present and finite,
    both roofline shares in (0, 1.05], the card's name and power limit."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    require_cuda()
    from bench_torch import CELLS, line_failures

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, str(root / "bench_torch.py"), "--cell", "all", "--reps", "2"],
                          cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert [x["cell"] for x in lines] == list(CELLS)
    for line in lines:
        assert line["measured_on"] == "cuda" and line_failures(line) == [], line_failures(line)
        assert line["glcm_profiled_launches"] == line["metrics"]["glcm_launches"]["value"]


# ---- the head's Adam fit as a CUDA graph (models/heads.py) -------------------

# (train rows, feature columns, classes, Adam steps) of the benchmark cells' heads
HEAD_SHAPES = {"mednist": (9000, 69, 6, 300), "classic": (1536, 276, 3, 500)}


def _head_problem(cell, seed, dev):
    """MinMax-scaled features in [0, 1], the class shifting the first eight
    columns, and the labels one-hot, at the cell's head shape."""
    n, f, k, _ = HEAD_SHAPES[cell]
    g = torch.Generator().manual_seed(seed)
    y = torch.randint(0, k, (n,), generator=g)
    X = torch.rand((n, f), generator=g)
    X[:, :8] += 0.3 * y[:, None].float() / k
    X = (X - X.amin(0)) / (X.amax(0) - X.amin(0))
    return X.to(dev), torch.nn.functional.one_hot(y, k).float().to(dev)


def _logistic_fits(cell, seed, dev):
    """(graphed ``_fit_logistic``, the eager loop) from the same start."""
    from tpumcia_torch.models import heads

    X, Y = _head_problem(cell, seed, dev)
    steps = HEAD_SHAPES[cell][3]
    w0 = heads.init_weights(X.shape[1], Y.shape[1], seed=seed, device=dev)
    b0 = torch.zeros(Y.shape[1], device=dev)
    got = heads._fit_logistic(X, Y, w0, b0, num_steps=steps, lr=0.05, l2=1e-4)
    w, b = heads._eager_adam([w0, b0], heads._logistic_loss(X, Y, 1e-4), num_steps=steps, lr=0.05)
    return X, got, {"w": w, "b": b}


@pytest.mark.parametrize("cell", sorted(HEAD_SHAPES))
def test_graphed_logistic_fit_matches_the_eager_loop(cell):
    """The graphed fit (fused capturable Adam, one eager step, the rest
    replayed) against the eager loop (foreach Adam) on the card, at each
    cell's head shape and step count. Measured on the H100 over 10 seeds a
    shape: weights at most 7.9e-6 (MedNIST) and 8.9e-5 (classic) apart,
    probabilities 1.5e-6 and 5.7e-6. The two optimizers round the same
    float32 update in another order; the loss is convex, so the
    probabilities stay at rounding, but Adam scales each update by its own
    gradient's size, so a weight whose column carries no signal moves by
    rounding-sized gradients and its gap grows past them. The limits are
    5.6x and 8.7x the largest readings: 5e-4 on the weights, 5e-5 on the
    probabilities."""
    from tpumcia_torch.models import heads

    dev = require_cuda()
    for seed in range(3):
        X, got, want = _logistic_fits(cell, seed, dev)
        for name in ("w", "b"):
            torch.testing.assert_close(got[name], want[name], rtol=0, atol=5e-4)
        torch.testing.assert_close(torch.softmax(heads.logistic_predict_logits(got, X), -1),
                                   torch.softmax(heads.logistic_predict_logits(want, X), -1),
                                   rtol=0, atol=5e-5)


@pytest.mark.parametrize("cell", sorted(HEAD_SHAPES))
def test_graphed_mlp_fit_matches_the_eager_loop(cell):
    """``_fit_mlp`` graphed against the eager loop at each cell's head shape
    (64 hidden units), over 10 steps: the graph still replays 9. At the
    cells' 300 and 500 steps no limit can hold: the eager fit alone moves
    its weights by 0.27 to 7.4 when its starting weights move by one ulp
    (measured on the H100), as Adam at lr 0.05 through ReLU units amplifies
    any rounding; the next test holds the full-length replays bit for bit.
    Measured over 10 steps, 8 seeds a shape: weights 1.9e-4 (MedNIST) and
    6.9e-5 (classic) apart at most, probabilities 1.8e-5 and 4.9e-5; the
    limits are about 5x those: 1e-3 on the weights, 2.5e-4 on the
    probabilities."""
    from tpumcia_torch.models import heads

    dev = require_cuda()
    for seed in range(3):
        X, Y = _head_problem(cell, seed, dev)
        p0 = heads.init_mlp_params([X.shape[1], 64, Y.shape[1]], seed=seed, device=dev)
        got = heads._fit_mlp(X, Y, p0, num_steps=10, lr=0.05, l2=1e-4)
        want = heads._unflatten(heads._eager_adam(heads._flatten(p0), heads._mlp_loss(X, Y, 1e-4),
                                                  num_steps=10, lr=0.05))
        for g, w in zip(heads._flatten(got), heads._flatten(want)):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-3)
        torch.testing.assert_close(torch.softmax(heads.mlp_predict_logits(got, X), -1),
                                   torch.softmax(heads.mlp_predict_logits(want, X), -1),
                                   rtol=0, atol=2.5e-4)


@pytest.mark.parametrize("kind", ["logistic", "mlp"])
@pytest.mark.parametrize("cell", sorted(HEAD_SHAPES))
def test_graph_replays_equal_the_same_steps_run_eagerly(cell, kind):
    """At each cell's shape and full step count, the graphed fit equals bit
    for bit the same fused capturable Adam stepped eagerly on the same
    stream: a replay does what the captured step did (0 apart in all 128
    fits measured on the H100, both heads, 10 to 500 steps)."""
    import warnings

    from tpumcia_torch.models import heads

    dev = require_cuda()
    X, Y = _head_problem(cell, 5, dev)
    steps = HEAD_SHAPES[cell][3]
    if kind == "logistic":
        t0 = [heads.init_weights(X.shape[1], Y.shape[1], seed=5, device=dev), torch.zeros(Y.shape[1], device=dev)]
        loss = heads._logistic_loss(X, Y, 1e-4)
    else:
        t0 = heads._flatten(heads.init_mlp_params([X.shape[1], 64, Y.shape[1]], seed=5, device=dev))
        loss = heads._mlp_loss(X, Y, 1e-4)
    got = heads._adam(t0, loss, num_steps=steps, lr=0.05)
    params = heads._leaves(t0)
    opt = torch.optim.Adam(params, lr=0.05, betas=heads.BETAS, eps=heads.EPS, fused=True, capturable=True)
    side = heads._side_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side), torch.enable_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        heads._steps(opt, params, loss, steps)
    torch.cuda.current_stream(dev).wait_stream(side)
    for g, w in zip(got, params):
        assert torch.equal(g, w.detach())


def test_graph_replays_every_step_past_the_warm_up():
    """``COUNTERS``: a fit adds all its steps to ``adam_steps`` and all but
    the eager warm-up's to ``adam_graph_steps``."""
    from tpumcia_torch.models import heads
    from tpumcia_torch.utils import profiling

    dev = require_cuda()
    X, Y = _head_problem("classic", 0, dev)
    steps = HEAD_SHAPES["classic"][3]
    profiling.reset_counters()
    heads._fit_logistic(X, Y, heads.init_weights(X.shape[1], 3, seed=0, device=dev),
                        torch.zeros(3, device=dev), num_steps=steps, lr=0.05, l2=1e-4)
    assert profiling.COUNTERS["adam_steps"] == steps
    assert profiling.COUNTERS["adam_graph_steps"] == steps - heads.GRAPH_WARMUP_STEPS


def test_graphed_fit_neither_synchronises_nor_empties_the_cache(monkeypatch):
    """An untimed fit calls neither ``torch.cuda.synchronize`` nor
    ``torch.cuda.empty_cache`` (what ``torch.cuda.graph`` would call), and
    leaves no memory allocated behind it: no graph, pool or cuBLAS
    workspace outlives the fit."""
    from tpumcia_torch.models import heads

    dev = require_cuda()
    X, Y = _head_problem("mednist", 1, dev)
    w0 = heads.init_weights(X.shape[1], Y.shape[1], seed=1, device=dev)
    b0 = torch.zeros(Y.shape[1], device=dev)
    heads._fit_logistic(X, Y, w0, b0, num_steps=50, lr=0.05, l2=1e-4)  # warm
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: seen.append("synchronize"))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: seen.append("empty_cache"))
    fitted = heads._fit_logistic(X, Y, w0, b0, num_steps=300, lr=0.05, l2=1e-4)
    monkeypatch.undo()
    assert seen == []
    assert bool(torch.isfinite(fitted["w"]).all())
    del fitted
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) <= before


def test_a_loss_that_synchronises_fails_the_capture_loudly():
    """A loss that reads a value back to the host cannot be captured: the fit
    raises the capture's error (no silent eager fallback), and the next fit
    on the same device runs and replays as before."""
    from tpumcia_torch.models import heads
    from tpumcia_torch.utils import profiling

    dev = require_cuda()
    X, Y = _head_problem("classic", 2, dev)
    loss = heads._logistic_loss(X, Y, 1e-4)

    def syncing(p):
        out = loss(p)
        return out * 2 if out.item() > 1e9 else out

    w0 = heads.init_weights(X.shape[1], 3, seed=2, device=dev)
    b0 = torch.zeros(3, device=dev)
    with pytest.raises(RuntimeError, match="captur"):
        heads._adam([w0, b0], syncing, num_steps=50, lr=0.05)
    profiling.reset_counters()
    _, got, want = _logistic_fits("classic", 2, dev)
    assert profiling.COUNTERS["adam_graph_steps"] == HEAD_SHAPES["classic"][3] - heads.GRAPH_WARMUP_STEPS
    torch.testing.assert_close(got["w"], want["w"], rtol=0, atol=1e-4)


# ---- the forest walk kernel (models/forest_device.py, csrc/forest_apply.cu) --


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_forest_kernel_matches_plain_and_gemm_on_card(case):
    """The walk kernel against its plain version on the card, bit for bit
    (the same float32 sums in tree order, the same division by T), reading
    the draws in place and scoring each draw's permuted copy ``torch.where(
    permuted, X[perm], X)``. Two runs are bit-equal, every lane is counted
    and the kernel launches once a call."""
    from tpumcia_torch.importance.permutation import draw_permutations
    from tpumcia_torch.models import forest_device
    from tpumcia_torch.utils.profiling import COUNTERS

    dev = require_cuda()
    trees, X, masks = walk_case(case)
    classes, pure = WALK_CASES[case][:2]
    f = forest_device.DeviceForest.from_arrays(trees, np.arange(classes), device=dev)
    assert f.device.type == "cuda"
    X, masks = X.to(dev), masks.to(dev)
    G, T = masks.shape[0], len(trees)
    D = G * WALK_REPEATS
    perms = draw_permutations(D, WALK_ROWS, seed=3, device=dev)
    lanes, launches = COUNTERS["forest_lanes"], COUNTERS["forest_kernel_launches"]
    got = f.apply_permuted(X, perms, masks, WALK_REPEATS)
    again = f.apply_permuted(X, perms, masks, WALK_REPEATS)
    base = f.apply(X)
    torch.cuda.synchronize()
    assert COUNTERS["forest_lanes"] - lanes == T * (2 * D + 1) * WALK_ROWS
    assert COUNTERS["forest_kernel_launches"] - launches == 3
    assert torch.equal(got, again)
    walk = (f.nodes, f.roots, f.values)
    assert torch.equal(got, forest_device._apply_walk(X, *walk, perms, masks, WALK_REPEATS))
    assert torch.equal(base, forest_device._apply_walk(X, *walk)[0])
    group_of = torch.arange(G, device=dev).repeat_interleave(WALK_REPEATS)
    copies = torch.where(masks[group_of].bool()[:, None, :], X[perms], X)
    on_copies = forest_device._apply_walk(copies.reshape(-1, X.shape[1]), *walk)[0]
    assert torch.equal(got, on_copies.reshape(got.shape))
    assert pure == bool(((f.values == 0) | (f.values == 1)).all())
    info = f.kernel_launch_info(D * WALK_ROWS)
    assert info["forest_in_smem"] and info["smem_bytes"] > 0 and info["blocks_per_sm"] >= 1


def test_forest_kernel_reads_a_forest_too_large_for_shared_memory():
    """12 trees of 4,001 nodes (768 KB of nodes) do not fit in shared
    memory: the kernel reads the forest through L1/L2, bit-equal to its
    plain version reading the draws in place and scoring each draw's
    permuted copy."""
    from tpumcia_torch.importance.permutation import draw_permutations
    from tpumcia_torch.models import forest_device

    dev = require_cuda()
    rng = np.random.default_rng(11)
    trees = [random_tree(rng, splits=2000, features=WALK_FEATURES, classes=4, pure=True)
             for _ in range(12)]
    f = forest_device.DeviceForest.from_arrays(trees, np.arange(4), device=dev)
    rows, repeats = 500, 3
    X = torch.from_numpy(rng.normal(size=(rows, WALK_FEATURES)).astype(np.float32)).to(dev)
    masks = torch.eye(WALK_FEATURES, device=dev)
    perms = draw_permutations(WALK_FEATURES * repeats, rows, seed=4, device=dev)
    info = f.kernel_launch_info(perms.numel())
    assert not info["forest_in_smem"] and info["smem_bytes"] == 0 and info["blocks_per_sm"] >= 1
    got = f.apply_permuted(X, perms, masks, repeats)
    walk = (f.nodes, f.roots, f.values)
    assert torch.equal(got, forest_device._apply_walk(X, *walk, perms, masks, repeats))
    group_of = torch.arange(WALK_FEATURES, device=dev).repeat_interleave(repeats)
    copies = torch.where(masks[group_of].bool()[:, None, :], X[perms], X)
    on_copies = forest_device._apply_walk(copies.reshape(-1, WALK_FEATURES), *walk)[0]
    assert torch.equal(got, on_copies.reshape(got.shape))


def test_forest_kernel_runs_on_a_second_card():
    """The kernel's shared-memory cap is an attribute of each device: a
    forest of 96 KB (past the 48 KB a block gets without asking), launched
    on the first card and then on the second, sits in shared memory on both
    and scores alike; and a forest head's sweep over a mesh of the two
    cards, each scoring its half, equals the sweep on one card."""
    from tpumcia_torch.config import HeadConfig
    from tpumcia_torch.importance.permutation import draw_permutations, permutation_importance
    from tpumcia_torch.models import forest_device
    from tpumcia_torch.models.heads import fit_head
    from tpumcia_torch.parallel.mesh import make_mesh
    from tpumcia_torch.parallel.sharding import permutation_importance_sharded
    from tpumcia_torch.utils.profiling import COUNTERS

    require_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    rng = np.random.default_rng(13)
    trees = [random_tree(rng, splits=150, features=WALK_FEATURES, classes=6, pure=True)
             for _ in range(20)]
    X = torch.from_numpy(rng.normal(size=(WALK_ROWS, WALK_FEATURES)).astype(np.float32))
    masks = torch.eye(WALK_FEATURES)
    D = WALK_FEATURES * WALK_REPEATS
    perms = draw_permutations(D, WALK_ROWS, seed=3, device="cpu")
    got = []
    for dev in cards:
        f = forest_device.DeviceForest.from_arrays(trees, np.arange(6), device=dev)
        info = f.kernel_launch_info(D * WALK_ROWS)
        assert info["forest_in_smem"] and info["smem_bytes"] > 48 * 1024, info
        got.append(f.apply_permuted(X.to(dev), perms.to(dev), masks.to(dev), WALK_REPEATS).cpu())
    assert torch.equal(got[0], got[1])

    Xh = rng.normal(size=(300, 10)).astype(np.float32)
    y = (Xh[:, 0] > 0).astype(np.int64) + (Xh[:, 3] > 0.5)
    head = fit_head(Xh, y, device=cards[0], config=HeadConfig(kind="random_forest", n_estimators=8, seed=0))
    want = permutation_importance(head, Xh, y, n_repeats=3, seed=42)
    before = COUNTERS["forest_kernel_launches"]
    sharded = permutation_importance_sharded(head, Xh, y, mesh=make_mesh(data=2, devices=cards),
                                             n_repeats=3, seed=42)
    assert COUNTERS["forest_kernel_launches"] - before == 4  # a baseline and the draws on each card
    np.testing.assert_array_equal(sharded.importances, want.importances)
    assert sharded.baseline_score == want.baseline_score


def _forest_call_config(head):
    return {"head": head, "importance": {"n_repeats": 2, "channel_method": "permutation_features"},
            "split": {"test_size": 0.25, "seed": 0, "stratify": True},
            "synth": {"noise_channels": 2, "seed": 0}, "fast_path": "never", "batch_size": 64}


def test_forest_kernel_scores_every_lane_of_a_forest_call(monkeypatch):
    """A forest ``run_pipeline`` call on the card (the classic path, the
    per-feature sweep over 69 columns): every (tree, row) lane the forest
    scores goes through the walk kernel, and its plain version is never
    called."""
    from tpumcia_torch.io.synthetic import synthetic_mednist
    from tpumcia_torch.models import forest_device
    from tpumcia_torch.pipeline.run import run_pipeline
    from tpumcia_torch.utils import profiling

    dev = require_cuda()
    images, labels, _ = synthetic_mednist(30, num_classes=6, seed=3)
    config = _forest_call_config({"kind": "random_forest", "n_estimators": 8, "seed": 0})
    def refuse(*args, **kwargs):
        raise AssertionError("a forest on the card reached the walk's plain version")

    monkeypatch.setattr(forest_device, "_apply_walk", refuse)
    profiling.reset_counters()
    res = run_pipeline(images, labels, config=config, device=dev)
    c = profiling.COUNTERS
    assert c["forest_lanes"] == 8 * len(res.test_idx) * (2 + 69 * 2)
    assert c["forest_kernel_launches"] >= 3  # the prediction, the baseline, the draws


def test_a_logistic_call_launches_as_without_the_forest_kernel_branch(monkeypatch):
    """A logistic ``run_pipeline`` call on the card launches the same
    kernels, by name and count, with the sweep asking the head's scorer for
    outputs of its own as with a bare callable in the scorer's place, and
    launches no walk kernel."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpumcia_torch.importance import permutation
    from tpumcia_torch.io.synthetic import synthetic_mednist
    from tpumcia_torch.pipeline.run import run_pipeline
    from tpumcia_torch.utils import profiling

    dev = require_cuda()
    images, labels, _ = synthetic_mednist(30, num_classes=6, seed=3)
    config = _forest_call_config({"kind": "logistic", "num_steps": 12})

    def launches():
        run_pipeline(images, labels, config=config, device=dev)  # warm
        torch.cuda.synchronize()
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_pipeline(images, labels, config=config, device=dev)
            torch.cuda.synchronize()
        return Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA)

    with_check = launches()
    assert profiling.COUNTERS["forest_kernel_launches"] == 0 and profiling.COUNTERS["sweep_evals"] > 0
    assert sum(with_check.values()) > 0 and not any("forest" in k for k in with_check)
    score_parts = permutation._device_score_parts

    def bare(head):
        apply_fn, classes = score_parts(head)
        return (lambda X: apply_fn(X)), classes

    monkeypatch.setattr(permutation, "_device_score_parts", bare)
    assert launches() == with_check
