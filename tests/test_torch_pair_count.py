"""The arithmetic of the redesigned GLCM statistics kernel, on the CPU.

The kernel never scans G: each pair adds one to its key's count and gets
the old count back, and sum(G^2) is summed as the change f(old + 1) -
f(old) of each limb. A numpy model of that, over a shuffled key stream,
must give exactly the limbs of ``stats.glcm_sumsq_limbs`` over the final
counts, in the cheap and the generic encoding; so must the same model with
the equal keys of each 32-lane warp added at once as f(old + n) - f(old)
(the form a warp-grouped kernel takes), groups landing in any order. Also
pinned here:
the layout chooser (pair table, dense G or bands), the byte count that
gives each kernel form its bound, what form B1e moves to and from a
workspace beside it, and the names of B1e's layouts. Nothing here needs JAX
or a card.
"""

import numpy as np
import pytest
import torch

from tpumcia_torch.features import cuda_glcm
from tpumcia_torch.features.stats import glcm_sumsq_limbs


def _limbs(g: int) -> np.ndarray:
    a, b = g >> 12, g & 4095
    return np.array([a * a, a * b, (b * b) >> 8, (b * b) & 255], dtype=np.int64)


def _telescoped_limbs(keys: np.ndarray, cheap: bool, rng, group: int) -> np.ndarray:
    """The kernel's sum(G^2) limbs over a pair key stream: ``group`` lanes
    at a time (1: the kernel), one add of n per run of equal keys among
    them, in random order."""
    counts: dict[int, int] = {}
    acc = np.zeros(4, dtype=np.int64)
    for w in range(0, len(keys), group):
        lanes, sizes = np.unique(keys[w:w + group], return_counts=True)
        for g in rng.permutation(len(lanes)):
            k, n = int(lanes[g]), int(sizes[g])
            old = counts.get(k, 0)
            counts[k] = old + n
            if cheap:
                acc[3] += (2 * old + n) * n
            else:
                acc += _limbs(old + n) - _limbs(old)
    if cheap:
        return np.array([0, 0, acc[3] >> 8, acc[3] & 255])
    return acc


def _key_stream(kind: str, rng) -> tuple[np.ndarray, int]:
    """(keys, number of cells): random 64x64 pairs at 256 levels, a
    cytometry-like channel of six levels, and streams with one cell past
    4,096 (the generic a-limb boundary) and past 65,535 (a u16 count)."""
    if kind == "random":
        return rng.integers(0, 256 * 256, size=3776), 256 * 256
    if kind == "six_levels":
        lv = rng.choice(np.arange(0, 256, 51), size=(2, 3776))
        return lv[0] * 256 + lv[1], 256 * 256
    n_hot = 5000 if kind == "past_4096" else 70_000
    keys = np.concatenate([np.full(n_hot, 1234), rng.integers(0, 1024 * 1024, size=3000)])
    return keys, 1024 * 1024


@pytest.mark.parametrize("group", [1, 32])
@pytest.mark.parametrize("kind,cheap", [
    ("random", True), ("random", False), ("six_levels", True), ("six_levels", False),
    ("past_4096", False), ("past_65535", False),
])
def test_telescoped_limbs_equal_limbs_of_final_counts(kind, cheap, group):
    rng = np.random.default_rng(7)
    keys, cells = _key_stream(kind, rng)
    want = glcm_sumsq_limbs(torch.from_numpy(np.bincount(keys, minlength=cells))[None], cheap)[0]
    for order in range(3):  # the same keys in another order
        got = _telescoped_limbs(rng.permutation(keys), cheap, rng, group)
        assert got.tolist() == want.tolist(), (kind, cheap, order)


@pytest.mark.parametrize("H,W,offsets,levels,want", [
    (48, 48, [(0, 5)], 256, 8192),
    (64, 64, [(0, 5)], 256, 8192),
    (48, 48, [(0, 5)], 1024, 8192),
    (64, 64, [(0, 5)], 4096, 8192),
    (64, 64, [(0, 5), (4, 4), (5, 0), (4, -4)], 256, 8192),
    (128, 128, [(0, 1)], 256, 32768),  # as large as the dense G: still the table
    # smaller than G, too large for shared memory beside 1024 levels' tables:
    # the kernel takes the bands there, and says so (launch_info)
    (128, 128, [(0, 1)], 1024, 32768),
    (255, 257, [(0, 5)], 256, 0),  # dense G
    (256, 256, [(0, 5)], 256, 0),  # bands
    (300, 300, [(0, 1)], 256, 0),  # bands
])
def test_layout_chooser(H, W, offsets, levels, want):
    slots = cuda_glcm.pair_table_slots(H, W, offsets, levels)
    assert slots == want
    if slots:
        most = max((H - abs(dr)) * (W - abs(dc)) for dr, dc in offsets)
        assert slots >= 2 * most and slots & (slots - 1) == 0 and slots < 4 * most
        assert 1 << cuda_glcm.table_bits(slots) == slots
    else:
        assert cuda_glcm.table_bits(slots) == 0


@pytest.mark.parametrize("shape,levels,offsets,mask_channels,need_diff,want", [
    ((2048, 12, 48, 48), 256, [(0, 5)], 1, False, 308_051_968),  # B1b, cytometry
    ((2048, 12, 48, 48), 1024, [(0, 5)], 1, True, 739_311_616),  # B1d, 1024 levels
    ((2048, 3, 64, 64), 256, [(0, 5)], 0, False, 120_070_144),  # B1a, bench
    ((1200, 3, 256, 256), 256, [(0, 5)], 0, True, 962_498_944),  # B1d, 256x256 fields
    ((2048, 3, 64, 64), 256, [(0, 5)], 0, True, 132_530_176),  # B1c
    ((2048, 3, 64, 64), 256, [(0, 5), (4, 4), (5, 0), (4, -4)], 0, False, 158_482_432),  # B2
    # fewer (image, channel)s than levels: one rescale row read per block
    ((8, 1, 64, 64), 4096, [(0, 5)], 0, True, 917_696),
    ((2, 1, 300, 300), 256, [(0, 1)], 0, True, 732_336),
    ((8, 2, 64, 64), 512, [(0, 5), (3, -2), (-4, 1)], 0, True, 721_792),
    # B1e reads no rescale table: the 8192-level cytometry batches, 8 items
    # at 32768 levels, and rows of 2L - 1 floats at 5001 and 20011 levels
    ((1024, 12, 48, 48), 8192, [(0, 5)], 1, True, 2_129_166_336),
    ((2048, 12, 48, 48), 8192, [(0, 5)], 1, True, 4_258_332_672),
    ((8, 1, 64, 64), 32768, [(0, 5)], 0, True, 5_374_144),
    ((3, 2, 37, 53), 5001, [(1, 2), (-2, 1)], 1, True, 1_133_403),
    ((8, 1, 64, 64), 20011, [(0, 1), (1, 0)], 1, True, 5_927_328),
])
def test_traffic_bytes(shape, levels, offsets, mask_channels, need_diff, want):
    got = cuda_glcm.traffic_bytes(shape, levels, offsets, mask_channels=mask_channels,
                                  need_diff=need_diff)
    assert got == want
    assert cuda_glcm.bound_ms(got) == pytest.approx(want / 3.35e9)


@pytest.mark.parametrize("shape,levels,offsets,table,plane,want", [
    ((2048, 12, 48, 48), 8192, [(0, 5)], False, False, 0),  # the main path: nothing outside
    ((8, 1, 64, 64), 32768, [(0, 5)], False, False, 0),
    # 128x128: 32,768 slots of 8 bytes zeroed per (image, channel) and offset
    ((2, 2, 128, 128), 8192, [(0, 1), (3, -2)], True, False, 2_097_152),
    # 300x300: 262,144 slots; the plane's 2 bytes a pixel written twice, read once
    ((1, 1, 300, 300), 4097, [(1, 2), (-2, 1)], True, True, 4_734_304),
])
def test_workspace_traffic_bytes(shape, levels, offsets, table, plane, want):
    got = cuda_glcm.workspace_traffic_bytes(shape, levels, offsets, table_in_workspace=table,
                                            plane_in_workspace=plane)
    assert got == want


@pytest.mark.parametrize("table,plane,want", [
    (True, True, "level bands"),
    (False, True, "level bands, table in workspace"),
    (True, False, "level bands, plane in workspace"),
    (False, False, "level bands, table and plane in workspace"),
])
def test_b1e_layout_names(table, plane, want):
    assert cuda_glcm.b1e_layout(table_in_smem=table, plane_in_smem=plane) == want
