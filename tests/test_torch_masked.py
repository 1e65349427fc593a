"""Masks in tpumcia_torch against tpumcia: the masked statistics (the plain
version of kernel form B1b) against the Pallas kernel in interpret mode,
the masked reduction (wire, assembly, f32 features) on the same statistics,
mask preparation, and masked ``extract_features`` against tpumcia's and
against its golden checks.

Tolerances: every integer statistic and integer wire word bit-equal;
``dstats[3]`` to rel 2e-6 against the Pallas kernel (its own f32 sum of
65,536 products rounds to ~1e-6, see test_torch_stats.py); f32 wire words
to rel 1e-6 (f32 sums in another order); assembled features 1e-5 max abs;
f32 device features rel 1e-5 / abs 1e-6; exact features 1e-9 (the golden
tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_chw_tensor
from tpumcia.config import FeatureConfig as JFeatureConfig
from tpumcia.features import hybrid as jhybrid
from tpumcia.features.extract import extract_features as jax_extract
from tpumcia.features.finalize import _finalize as jax_finalize
from tpumcia.features.pallas_glcm import sufficient_stats_pallas
from tpumcia_torch.config import FeatureConfig
from tpumcia_torch.features import cuda_glcm, hybrid
from tpumcia_torch.features.extract import extract_features
from tpumcia_torch.features.finalize import _finalize
from tpumcia_torch.features.stats import SuffStats, prepare_mask

PALLAS_DSTATS3_RTOL = 2e-6
FLOAT_WORDS = [8, 9, 10, 11, 12]  # m2 m3 m4 entropy homog_sum
INT_WORDS = [w for w in range(hybrid.WIRE_WORDS) if w not in FLOAT_WORDS]


def _masked_batch(small_batch, rng_seed=5):
    """small_batch[:3] with an all-zero channel, and a per-channel mask with
    an empty (image, channel), a one-pixel one at a nonzero level (no pairs
    at any offset) and a rectangle touching the image edge."""
    x = small_batch[:3].copy()
    x[0, :, :, 1] = 0
    x[2, 7, 9, 2] = max(x[2, 7, 9, 2], 1)
    m = np.random.default_rng(rng_seed).random(x.shape) < 0.8
    m[1, :, :, 0] = False
    m[2, :, :, 2] = False
    m[2, 7, 9, 2] = True
    m[0, :, :, 2] = False
    m[0, :20, -24:, 2] = True
    return x, m


def _assert_stats_match(want, got, need_diff):
    for name in ("hist", "count", "vmax", "marg_l", "marg_r", "glcm_sumsq", "pair_count"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)
    if need_diff:
        assert got.dstats is None
        np.testing.assert_array_equal(np.asarray(want.diff_hist), got.diff_hist.numpy())
    else:
        assert got.diff_hist is None
        a, b = np.asarray(want.dstats), got.dstats.numpy()
        np.testing.assert_array_equal(a[..., :3], b[..., :3])
        np.testing.assert_allclose(b[..., 3], a[..., 3], rtol=PALLAS_DSTATS3_RTOL, atol=0)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("offset", [(0, 5), (3, -2), (-2, 1)])
def test_masked_stats_match_pallas_kernel(small_batch, shared, offset):
    x, m = _masked_batch(small_batch)
    mask = m[..., 0] if shared else m
    want = sufficient_stats_pallas(x, mask, offset=offset, interpret=True, need_diff_hist=False)
    got = cuda_glcm.sufficient_stats(
        to_chw_tensor(x), prepare_mask(mask, x.shape, "cpu"), levels=256, offset=offset
    )
    _assert_stats_match(want, got, need_diff=False)
    if not shared:
        assert int(got.vmax[1, 0]) == -1 and float(got.count[1, 0]) == 0
        assert float(got.count[2, 2]) == 1 and float(got.pair_count[2, 2]) == 0
        assert int(got.vmax[0, 1]) == 0  # all-zero channel


def test_mask_dtypes_and_forms_give_one_plane():
    rng = np.random.default_rng(0)
    shape = (2, 6, 7, 3)
    shared = rng.random(shape[:3]) > 0.5
    planes = [
        prepare_mask(shared, shape, "cpu"),
        prepare_mask(shared.astype(np.uint8) * 7, shape, "cpu"),
        prepare_mask(shared.tolist(), shape, "cpu"),  # a nested list mask
        prepare_mask(torch.from_numpy(shared), shape, "cpu"),
    ]
    for p in planes:
        assert p.dtype == torch.uint8 and tuple(p.shape) == (2, 1, 6, 7)  # never C-fold
        assert p.is_contiguous()
        np.testing.assert_array_equal(p[:, 0].numpy(), shared.astype(np.uint8))
    per_ch = rng.random(shape) > 0.5
    p = prepare_mask(per_ch, shape, "cpu")
    assert tuple(p.shape) == (2, 3, 6, 7)
    np.testing.assert_array_equal(p.numpy(), per_ch.transpose(0, 3, 1, 2))
    for bad in [np.ones((2, 3, 3, 3)), np.ones((2, 6, 7, 2)), np.ones((6, 7))]:
        with pytest.raises(ValueError, match="mask shape .* must equal"):
            prepare_mask(bad, shape, "cpu")


@pytest.fixture(scope="module")
def masked_stats(small_batch):
    """The masked Pallas statistics (interpret mode) as JAX and torch
    SuffStats, with an empty-mask channel, a one-pixel mask with 0 pairs and
    an all-zero channel."""
    x, m = _masked_batch(small_batch)
    js = sufficient_stats_pallas(x, m, interpret=True, need_diff_hist=False)
    ts = SuffStats(*(None if v is None else torch.from_numpy(np.array(v)) for v in js))
    return js, ts


def test_masked_reduction_matches_jax(masked_stats):
    """The masked statistics through the port's wire, assembly and f32
    finalize: integer words bit-equal, float words rel 1e-6, features 1e-5,
    NaN patterns and degenerate flags equal."""
    js, ts = masked_stats
    want = np.asarray(jhybrid._device_reduce_wire(js))
    got = hybrid._device_reduce_wire(ts).numpy().view(np.uint32)
    np.testing.assert_array_equal(got[..., INT_WORDS], want[..., INT_WORDS])
    np.testing.assert_allclose(
        got[..., FLOAT_WORDS].view(np.float32), want[..., FLOAT_WORDS].view(np.float32),
        rtol=1e-6, atol=0,
    )
    port = hybrid.assemble_reduced(hybrid.unpack_wire(got))
    ref = jhybrid.assemble_reduced(jhybrid.unpack_wire(want))
    np.testing.assert_array_equal(np.isnan(port.values), np.isnan(ref.values))
    np.testing.assert_allclose(port.values, ref.values, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(port.degenerate, np.asarray(ref.degenerate))
    # the empty mask, and the all-zero channel, are flagged; one pixel is not
    assert port.degenerate[1, 0] and port.degenerate[0, 1] and not port.degenerate[2, 2]

    dev = _finalize(ts)
    jdev = jax_finalize(js, jnp, jnp.float32, True, True)
    np.testing.assert_allclose(dev.values.numpy(), np.asarray(jdev.values), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(dev.degenerate.numpy(), np.asarray(jdev.degenerate))


def _jcfg(**kw):
    return JFeatureConfig(use_pallas="never", **kw)


@pytest.mark.parametrize("precision", ["hybrid", "exact", "device"])
def test_masked_extract_features_matches_jax(small_batch, precision):
    x, m = _masked_batch(small_batch)
    want = jax_extract(x, m, config=_jcfg(precision=precision))
    got = extract_features(x, m, device="cpu", config=FeatureConfig(precision=precision))
    a = got.to_numpy()
    b = np.asarray(want.values, np.float64)
    assert got.names == want.names and a.shape == b.shape == (3, 69)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(got.degenerate, np.asarray(want.degenerate))
    if precision == "hybrid":
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    elif precision == "exact":
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    else:
        assert isinstance(got.values, torch.Tensor) and got.values.dtype == torch.float32
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


EXACT = FeatureConfig(precision="exact")


def test_rectangular_mask_equals_the_crop(rng):
    """Masked extraction equals cropping to the masked region for a
    rectangular mask (tests/test_features_golden.py::test_masked_features)."""
    img = (rng.random((1, 32, 32, 1)) * 256).astype(np.uint8)
    mask = np.zeros((1, 32, 32, 1), dtype=bool)
    mask[:, 4:28, 2:30, :] = True
    masked = extract_features(img, mask, device="cpu", config=EXACT)
    crop = extract_features(img[:, 4:28, 2:30, :], device="cpu", config=EXACT)
    np.testing.assert_allclose(masked.values, crop.values, rtol=0, atol=1e-9)


def test_shared_mask_broadcasts_across_channels(rng):
    img = (rng.random((2, 16, 16, 3)) * 256).astype(np.uint8)
    shared = rng.random((2, 16, 16)) > 0.3
    per_ch = np.repeat(shared[..., None], 3, axis=-1)
    for precision in ("exact", "hybrid"):
        cfg = FeatureConfig(precision=precision)
        a = extract_features(img, shared, device="cpu", config=cfg)
        b = extract_features(img, per_ch, device="cpu", config=cfg)
        np.testing.assert_array_equal(a.values, b.values)


def test_mask_shape_mismatch_named_error(rng):
    img = (rng.random((2, 16, 16, 3)) * 256).astype(np.uint8)
    for bad in (np.ones((2, 8, 8, 3), np.uint8), np.ones((2, 16, 16, 2), np.uint8)):
        with pytest.raises(ValueError, match="mask shape .* must equal"):
            extract_features(img, bad, device="cpu")


def test_empty_mask_flagged():
    img = np.full((1, 8, 8, 1), 50, dtype=np.uint8)
    mask = np.zeros((1, 8, 8, 1), dtype=bool)
    for precision in ("exact", "hybrid"):
        fm = extract_features(img, mask, device="cpu", config=FeatureConfig(precision=precision))
        assert fm.degenerate.all()
        assert np.isfinite(np.asarray(fm.values, dtype=np.float64)).all()


def test_masked_fast_path_matches_single_call(small_batch):
    """extract_features_batched's fused batches (wrap-padded, the mask
    padded with the images) give the single call's values."""
    from tpumcia_torch.features.extract import extract_features_batched

    x, m = _masked_batch(small_batch)
    x = np.concatenate([x, small_batch[3:5]])
    m = np.concatenate([m, np.ones((2, *m.shape[1:]), bool)])
    one = extract_features(x, m[..., 0], device="cpu")
    batched = extract_features_batched(x, m[..., 0], device="cpu", batch_size=2)
    np.testing.assert_array_equal(batched.values, one.values)
    np.testing.assert_array_equal(batched.degenerate, one.degenerate)
    with pytest.raises(ValueError, match="masks"):
        from tpumcia_torch.features.extract import extract_features_pending

        extract_features_pending(x[..., 0], m[..., 0], device="cpu", synth_noise=2)
