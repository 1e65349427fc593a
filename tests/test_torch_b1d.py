"""Kernel form B1d (H*W >= 65536 or more than 256 levels) in tpumcia_torch
against tpumcia, on the CPU: the plain statistics against the Pallas kernel
in interpret mode and the XLA statistics, ``extract_features`` at those
sizes in every precision, tpumcia's routing rule there, and the packed f32
wire that ``precision='hybrid'`` sends above 256 levels.

Tolerances: integer statistics and difference histograms bit-equal; packed
wire integer words equal, its f32-summed words (m2, m3, m4, entropy,
homog_sum) to rel 1e-6 with an abs floor of 1e-8 (m3 sums terms of both
signs, so its relative error has no bound near zero); features exact < 1e-9, hybrid 1e-5 max abs, device
rel 1e-5 / abs 1e-5 (f32 formulas in another order); NaN patterns and
degenerate flags equal.
"""

import numpy as np
import pytest
import torch

from torch_parity import to_chw_tensor
from tpumcia.config import FeatureConfig as JFeatureConfig
from tpumcia.config import GLCMConfig as JGLCMConfig
from tpumcia.features import hybrid as jhybrid
from tpumcia.features.extract import extract_features as jax_extract
from tpumcia.features.pallas_glcm import sufficient_stats_pallas, sufficient_stats_pallas_multi
from tpumcia.features.stats import sufficient_stats as jax_stats
from tpumcia.features.stats import sufficient_stats_multi as jax_stats_multi
from tpumcia_torch.config import FeatureConfig, GLCMConfig
from tpumcia_torch.features import cuda_glcm, extract, hybrid
from tpumcia_torch.features.stats import SuffStats, prepare_mask

INT_FIELDS = ("hist", "count", "vmax", "marg_l", "marg_r", "diff_hist", "glcm_sumsq", "pair_count")


def _inputs(case):
    """(images (B, H, W, C), mask or None, levels, offsets) of each case."""
    rng = np.random.default_rng(21)
    if case == "256px":  # 16 chunks of the Pallas kernel, a two-pass band at 256 levels
        x = rng.integers(0, 256, size=(1, 256, 256, 1), dtype=np.uint8)
        return x, None, 256, [(0, 5)]
    x = rng.integers(0, 512, size=(2, 16, 16, 2)).astype(np.uint16)
    x[1, :, :, 0] = 0  # all-zero channel
    if case == "512_masked":
        m = rng.random((2, 16, 16, 2)) < 0.7
        m[0, :, :, 1] = False  # empty mask
        return x, m, 512, [(1, -2)]
    return x, None, 512, [(0, 1), (2, 1)]


def _assert_int_fields_equal(want, got, fields=INT_FIELDS):
    for name in fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        np.testing.assert_array_equal(a.astype(np.float64), b.astype(np.float64), err_msg=name)
    assert got.dstats is None


@pytest.mark.parametrize("case", ["256px", "512_masked", "512_two_offsets"])
def test_large_stats_match_pallas_and_xla(case):
    x, m, levels, offsets = _inputs(case)
    t = to_chw_tensor(x)
    p = None if m is None else prepare_mask(m, x.shape, "cpu")
    got = cuda_glcm.sufficient_stats_multi(t, p, levels=levels, offsets=offsets, need_diff=True)
    if len(offsets) == 1:
        pallas = [sufficient_stats_pallas(x, m, levels=levels, offset=offsets[0], interpret=True)]
        xla = [jax_stats(x, m, levels=levels, offset=offsets[0])]
    else:
        pallas = sufficient_stats_pallas_multi(x, m, levels=levels, offsets=tuple(offsets), interpret=True)
        xla = jax_stats_multi(x, m, levels=levels, offsets=tuple(offsets))
    for o, (g, a, b) in enumerate(zip(got, pallas, xla)):
        _assert_int_fields_equal(a, g)
        # the XLA multi-offset pass carries the histogram on offset 0 only
        _assert_int_fields_equal(b, g, INT_FIELDS[o > 0:])
    assert cuda_glcm.kernel_form(hw=x.shape[1] * x.shape[2], levels=levels, masked=m is not None,
                                 need_diff=True, num_offsets=len(offsets)) == "B1d"


def test_need_diff_false_is_refused_at_large_sizes():
    t = torch.zeros((1, 1, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="need_diff=False"):
        cuda_glcm.sufficient_stats(t, levels=512, offset=(0, 1))
    with pytest.raises(ValueError, match="need_diff=False"):
        cuda_glcm.sufficient_stats_multi(torch.zeros((1, 1, 256, 256), dtype=torch.int32),
                                         levels=256, offsets=[(0, 1)])


def _tol(precision):
    return {"exact": dict(rtol=0, atol=1e-9), "hybrid": dict(rtol=0, atol=1e-5),
            "device": dict(rtol=1e-5, atol=1e-5)}[precision]


@pytest.mark.parametrize("precision", ["exact", "hybrid", "device"])
@pytest.mark.parametrize("case", ["256px", "512_masked", "512_two_offsets"])
def test_extract_features_at_large_sizes_matches_jax(case, precision):
    x, m, levels, offsets = _inputs(case)
    dist = tuple(sorted({max(abs(dr), abs(dc)) for dr, dc in offsets}))
    if case == "512_two_offsets":  # distances 1 and 2 at angle 0 -> (0, 1), (0, 2)
        glcm = dict(levels=levels, distance=(1, 2))
    else:
        glcm = dict(levels=levels, distance=dist[0])
    want = jax_extract(x, m, config=JFeatureConfig(precision=precision, glcm=JGLCMConfig(**glcm)))
    got = extract.extract_features(x, m, device="cpu",
                                   config=FeatureConfig(precision=precision, glcm=GLCMConfig(**glcm)))
    a, b = got.to_numpy(), np.asarray(want.values, np.float64)
    assert got.names == want.names and a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.asarray(got.degenerate), np.asarray(want.degenerate))
    np.testing.assert_allclose(a, b, **_tol(precision))


def test_routing_rule_pins_need_diff(monkeypatch):
    """tpumcia's rule (tests/test_pallas_glcm.py pins its own): the
    difference histogram above 256 levels or at >= 65536 pixels, in every
    precision; hybrid runs as the host backend at >= 65536 pixels."""
    seen = {}

    class _Stop(Exception):
        pass

    def capture(img, mask=None, *, levels, offset, need_diff=False):
        seen[(levels, img.shape[-1], cfg.precision)] = need_diff
        raise _Stop()

    monkeypatch.setattr(cuda_glcm, "sufficient_stats", capture)
    for precision in ("device", "hybrid"):
        for levels, hw in [(256, 8), (512, 8), (256, 256)]:
            cfg = FeatureConfig(precision=precision, glcm=GLCMConfig(levels=levels))
            img = np.zeros((1, hw, hw, 1), np.uint16)
            if precision == "hybrid" and (levels, hw) == (256, 8):
                continue  # the fused u32-wire dispatch, no need_diff argument
            with pytest.raises(_Stop):
                extract.extract_features(img, device="cpu", config=cfg)
    assert seen == {
        (256, 8, "device"): False, (512, 8, "device"): True, (256, 256, "device"): True,
        (512, 8, "hybrid"): True, (256, 256, "hybrid"): True,
    }, seen
    # the backend at 256x256: hybrid gives the exact (host) result itself
    monkeypatch.undo()
    img = np.random.default_rng(0).integers(0, 256, size=(1, 256, 256, 1), dtype=np.uint8)
    hyb = extract.extract_features(img, device="cpu")
    exact = extract.extract_features(img, device="cpu", config=FeatureConfig(precision="exact"))
    np.testing.assert_array_equal(hyb.values, exact.values)


def _jax_and_torch_stats(levels=512):
    x, m, _, _ = _inputs("512_masked")
    js = sufficient_stats_pallas(x, m, levels=levels, offset=(1, -2), interpret=True)
    ts = SuffStats(*(None if v is None else torch.from_numpy(np.array(v)) for v in js))
    return js, ts


def test_packed_wire_matches_jax():
    js, ts = _jax_and_torch_stats()
    want = np.asarray(jhybrid._device_reduce_packed(js))
    got = hybrid._device_reduce_packed(ts).numpy()
    assert got.shape == want.shape == (2, 2, hybrid.PACKED_WORDS)
    floats = [hybrid._NARROW_FIELDS.index(f) for f in ("m2", "m3", "m4", "entropy", "homog_sum")]
    ints = [i for i in range(hybrid.PACKED_WORDS) if i not in floats]
    np.testing.assert_array_equal(got[..., ints], want[..., ints])
    np.testing.assert_allclose(got[..., floats], want[..., floats], rtol=1e-6, atol=1e-8)
    a, b = hybrid.unpack_reduced(got, levels=512), jhybrid.unpack_reduced(want, levels=512)
    assert a.keys() == b.keys()
    for k in ("n", "vmax", "total_raw", "s_i", "s_j", "dissim_raw", "s_i2", "s_j2", "s_d2",
              "sumsq_value", "idx_lo", "idx_hi", "rem", "count_overflow"):
        np.testing.assert_array_equal(np.asarray(a[k], np.float64), np.asarray(b[k], np.float64), err_msg=k)
    for inten, glcm in [(True, True), (True, False), (False, True)]:
        f_want = jhybrid.finalize_hybrid(js, include_intensity=inten, include_glcm=glcm)
        f_got = hybrid.finalize_hybrid(ts, include_intensity=inten, include_glcm=glcm)
        np.testing.assert_array_equal(np.isnan(f_got.values), np.isnan(f_want.values))
        np.testing.assert_allclose(f_got.values, f_want.values, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(f_got.degenerate, np.asarray(f_want.degenerate))


def test_quad_shift_matches_jax():
    for levels in (16, 256, 257, 512, 1024, 4096, 32768):
        assert hybrid._quad_shift(levels) == jhybrid._quad_shift(levels)
    with pytest.raises(ValueError, match="32768"):
        hybrid._quad_shift(32769)


def test_finalize_hybrid_refuses_large_counts():
    _, ts = _jax_and_torch_stats()
    big = ts._replace(count=torch.full_like(ts.count, 70000.0))
    with pytest.raises(ValueError, match="65536"):
        hybrid.finalize_hybrid(big)
