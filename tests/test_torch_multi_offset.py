"""GLCM offset lists in tpumcia_torch against tpumcia: the multi-offset
statistics (the plain version of kernel form B2) against the Pallas
multi-offset kernel in interpret mode, the multi-offset wire against
tpumcia's on the same statistics, and ``extract_features`` with offset
lists against tpumcia's (XLA path, ``use_pallas='never'``).

Tolerances: integer statistics and integer wire words bit-equal;
``dstats[3]`` rel 2e-6 against the Pallas kernel's f32 sum; f32 wire words
rel 1e-6; hybrid features 1e-5; exact 1e-9; device rel 1e-5 / abs 1e-6.
"""

import numpy as np
import pytest
import torch

from torch_parity import to_chw_tensor
from tpumcia.config import FeatureConfig as JFeatureConfig
from tpumcia.config import GLCMConfig as JGLCMConfig
from tpumcia.features import hybrid as jhybrid
from tpumcia.features.extract import extract_features as jax_extract
from tpumcia.features.pallas_glcm import sufficient_stats_pallas_multi
from tpumcia_torch.config import FeatureConfig, GLCMConfig
from tpumcia_torch.features import cuda_glcm, hybrid
from tpumcia_torch.features.extract import extract_features
from tpumcia_torch.features.stats import SuffStats, prepare_mask

OFFSETS = ((0, 5), (3, -2), (-2, 1), (4, 4))
PALLAS_DSTATS3_RTOL = 2e-6
# distance 5 at 0, 45, 90 and 135 degrees: offsets (0,5) (4,4) (5,0) (4,-4)
FOUR_ANGLES = dict(distance=5, angle=(0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4))


def _batch(small_batch):
    x = small_batch[:3].copy()
    x[0, :, :, 1] = 0
    m = np.random.default_rng(9).random(x.shape[:3]) < 0.75
    m[1] = False
    m[1, 0, :3] = True  # three pixels on the top edge: pairs only at (0, 1)-like offsets
    return x, m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("need_diff", [False, True])
def test_multi_stats_match_pallas_kernel(small_batch, masked, need_diff):
    x, m = _batch(small_batch)
    mask = m if masked else None
    want = sufficient_stats_pallas_multi(
        x, mask, offsets=OFFSETS, interpret=True, need_diff_hist=need_diff
    )
    got = cuda_glcm.sufficient_stats_multi(
        to_chw_tensor(x), None if mask is None else prepare_mask(mask, x.shape, "cpu"),
        levels=256, offsets=OFFSETS, need_diff=need_diff,
    )
    assert len(got) == len(want) == 4
    for o, (w, g) in enumerate(zip(want, got)):
        assert g.hist is got[0].hist  # shared, as the Pallas form returns it
        for name in ("hist", "count", "vmax", "marg_l", "marg_r", "glcm_sumsq", "pair_count"):
            a, b = np.asarray(getattr(w, name)), getattr(g, name).numpy()
            assert a.dtype == b.dtype, (o, name)
            np.testing.assert_array_equal(a, b, err_msg=f"offset {o} {name}")
        if need_diff:
            np.testing.assert_array_equal(np.asarray(w.diff_hist), g.diff_hist.numpy())
        else:
            a, b = np.asarray(w.dstats), g.dstats.numpy()
            np.testing.assert_array_equal(a[..., :3], b[..., :3])
            np.testing.assert_allclose(b[..., 3], a[..., 3], rtol=PALLAS_DSTATS3_RTOL, atol=0)


def test_multi_equals_single_offset_calls(small_batch):
    x, m = _batch(small_batch)
    t, p = to_chw_tensor(x), prepare_mask(m, x.shape, "cpu")
    multi = cuda_glcm.sufficient_stats_multi(t, p, levels=256, offsets=OFFSETS)
    for off, st in zip(OFFSETS, multi):
        one = cuda_glcm.sufficient_stats(t, p, levels=256, offset=off)
        for name in st._fields:
            a, b = getattr(st, name), getattr(one, name)
            assert (a is None and b is None) or torch.equal(a, b), (off, name)


def test_multi_wire_matches_jax(small_batch):
    x, m = _batch(small_batch)
    js = sufficient_stats_pallas_multi(x, m, offsets=OFFSETS, interpret=True, need_diff_hist=False)
    ts = tuple(
        SuffStats(*(None if v is None else torch.from_numpy(np.array(v)) for v in s)) for s in js
    )
    want = np.asarray(jhybrid._device_reduce_wire_multi(tuple(js)))
    got = hybrid._device_reduce_wire_multi(ts).numpy().view(np.uint32)
    assert got.shape == want.shape == (3, 3, hybrid.multi_wire_words(4))
    per = hybrid.MULTI_WIRE_PER_OFFSET
    floats = [8, 9, 10, 11] + [hybrid.MULTI_WIRE_SHARED + per * o + 1 for o in range(4)]
    ints = [w for w in range(got.shape[-1]) if w not in floats]
    np.testing.assert_array_equal(got[..., ints], want[..., ints])
    np.testing.assert_allclose(
        got[..., floats].view(np.float32), want[..., floats].view(np.float32), rtol=1e-6, atol=0
    )
    port = hybrid.unpack_wire_multi(got, 4)
    ref = jhybrid.unpack_wire_multi(want, 4)
    for i, (p, r) in enumerate(zip(port, ref)):
        a = hybrid.assemble_reduced(p, include_intensity=i == 0)
        b = jhybrid.assemble_reduced(r, include_intensity=i == 0)
        np.testing.assert_array_equal(np.isnan(a.values), np.isnan(b.values))
        np.testing.assert_allclose(a.values, b.values, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(a.degenerate, np.asarray(b.degenerate))
    with pytest.raises(ValueError, match="uint32"):
        hybrid.unpack_wire_multi(got, 3)


@pytest.mark.parametrize("precision", ["hybrid", "exact", "device"])
@pytest.mark.parametrize("masked", [False, True])
def test_offset_list_extract_matches_jax(small_batch, precision, masked):
    x, m = _batch(small_batch)
    mask = m if masked else None
    want = jax_extract(x, mask, config=JFeatureConfig(
        glcm=JGLCMConfig(**FOUR_ANGLES), precision=precision, use_pallas="never"))
    got = extract_features(x, mask, device="cpu", config=FeatureConfig(
        glcm=GLCMConfig(**FOUR_ANGLES), precision=precision))
    a, b = got.to_numpy(), np.asarray(want.values, np.float64)
    assert a.shape == b.shape == (3, 3 * (17 + 4 * 6))
    assert got.names == want.names and got.names[51] == "contrast_d5a0_Ch1"
    assert got.channel_columns() == want.channel_columns()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(got.degenerate, np.asarray(want.degenerate))
    if precision == "hybrid":
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    elif precision == "exact":
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_offset_list_without_intensity_matches_jax(small_batch):
    x, m = _batch(small_batch)
    kw = dict(glcm=dict(distance=(1, 3), angle=(0.0, np.pi / 2)), include_intensity=False)
    want = jax_extract(x, m, config=JFeatureConfig(
        glcm=JGLCMConfig(**kw["glcm"]), include_intensity=False, use_pallas="never"))
    got = extract_features(x, m, device="cpu", config=FeatureConfig(
        glcm=GLCMConfig(**kw["glcm"]), include_intensity=False))
    assert got.names == want.names and got.values.shape == (3, 3 * 4 * 6)
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-5)
