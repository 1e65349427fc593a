"""Morphology and the matrix-level texture API of tpumcia_torch against
tpumcia, on the CPU: ``morphology_features``, the morphology block of
``extract_features``, ``glcm_matrix``, ``glcm_properties``/``graycoprops``
(and the oracle's skimage ``graycoprops``) and
``intensity_features_direct``.

Tolerances:
- morphology: rel 1e-5 (f32 moment sums in another order), abs 1e-5 for
  values near 0 (orientation, a centred moment);
- ``glcm_matrix``: bit-equal (integer counts, cast to f32);
- GLCM properties: rel 1e-6 (f32 sums of the normalised matrix), abs 1e-6;
- direct intensity features: rel 1e-6, abs 1e-6 of the feature's largest
  magnitude for values near 0 (skew of a symmetric sample: f32 sums of both
  signs), NaN where tpumcia has NaN.
"""

import numpy as np
import pytest
import torch

from tpumcia.config import FeatureConfig as JFeatureConfig
from tpumcia.features import registry as jregistry
from tpumcia.features.extract import extract_features as jax_extract
from tpumcia.features.intensity_direct import intensity_features_direct as jax_direct
from tpumcia.features.morphology import morphology_features as jax_morphology
from tpumcia.features.props import glcm_properties as jax_props
from tpumcia.features.props import graycoprops as jax_graycoprops
from tpumcia.features.stats import glcm_matrix as jax_glcm_matrix
from tpumcia.reference_impl import oracle
from tpumcia_torch.config import FeatureConfig
from tpumcia_torch.features import registry
from tpumcia_torch.features.extract import extract_features
from tpumcia_torch.features.intensity_direct import intensity_features_direct
from tpumcia_torch.features.morphology import MORPHOLOGY_FEATURES, morphology_features
from tpumcia_torch.features.props import glcm_properties, graycoprops
from tpumcia_torch.features.registry import GLCM_FEATURES
from tpumcia_torch.features.stats import glcm_matrix


def _shapes_mask():
    """(6, 20, 24, 5) per-channel masks: per image, channels of an empty
    mask, one pixel, a diagonal line (eccentricity 1), a ring, the full
    frame and a random blob."""
    rng = np.random.default_rng(0)
    m = np.zeros((6, 20, 24, 5), bool)
    yy, xx = np.mgrid[:20, :24]
    r = np.hypot(yy - 9.5, xx - 11)
    for b in range(6):
        m[b, 3 + b, 4 + b, 1] = True
        for i in range(12 - b):
            m[b, 2 + i, 3 + i + b, 2] = True
        m[b, ..., 3] = (r > 3 + b / 2) & (r < 7 + b / 2)
        m[b, ..., 4] = True if b % 2 else rng.random((20, 24)) < 0.4
    return m


def test_morphology_matches_jax():
    mask = _shapes_mask()
    want = np.asarray(jax_morphology(mask))
    got = morphology_features(mask, device="cpu").numpy()
    assert got.shape == want.shape == (6, 5, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[:, 0] == 0).all()  # empty masks
    np.testing.assert_array_equal(got[:, 1, 5], 0.0)  # one pixel: round
    np.testing.assert_allclose(got[:, 2, 5], 1.0, rtol=0, atol=1e-5)  # a line
    np.testing.assert_array_equal(got[1::2, 4, 7], 1.0)  # the full frame fills its box


def test_shared_mask_gives_every_channel_its_values():
    """The port's rule for a shared (B, H, W) mask: every channel gets the
    mask's 8 values, so the names, the values and the positional groups
    agree (tpumcia returns one channel's 8 values under C x 8 names)."""
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, size=(4, 16, 16, 3)).astype(np.uint8)
    shared = _shapes_mask()[:4, :16, :16, 3]
    cfg = FeatureConfig(include_morphology=True)
    fm = extract_features(images, shared, device="cpu", config=cfg)
    assert fm.values.shape == (4, 3 * 31) and len(fm.names) == 93
    own = morphology_features(shared, device="cpu").numpy()[:, 0]
    for c, cols in enumerate(fm.channel_columns()):
        morph_cols = cols[-8:]
        assert [fm.names[j] for j in morph_cols] == [f"{f}_Ch{c + 1}" for f in MORPHOLOGY_FEATURES]
        np.testing.assert_array_equal(fm.values[:, morph_cols], own.astype(np.float64))
    per_channel = np.repeat(shared[..., None], 3, axis=-1)
    np.testing.assert_array_equal(
        extract_features(images, per_channel, device="cpu", config=cfg).values, fm.values
    )


@pytest.mark.parametrize("precision", ["hybrid", "exact", "device"])
def test_extract_with_morphology_matches_jax(precision):
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, size=(6, 20, 24, 5)).astype(np.uint8)
    mask = _shapes_mask()
    want = jax_extract(images, mask, config=JFeatureConfig(precision=precision, include_morphology=True))
    got = extract_features(images, mask, device="cpu",
                           config=FeatureConfig(precision=precision, include_morphology=True))
    assert got.names == want.names and got.names[-8:] == [f"{f}_Ch5" for f in MORPHOLOGY_FEATURES]
    g, w = got.to_numpy(), np.asarray(want.values)
    assert g.shape == w.shape == (6, 5 * 31)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g[:, -40:], w[:, -40:], rtol=1e-5, atol=1e-5)
    # the other blocks at the extraction tests' bars: f64 exact, f64 hybrid,
    # f32 device values
    rtol, atol = {"exact": (0, 1e-9), "hybrid": (0, 1e-5), "device": (1e-6, 1e-5)}[precision]
    np.testing.assert_allclose(np.nan_to_num(g[:, :-40]), np.nan_to_num(w[:, :-40]), rtol=rtol, atol=atol)
    assert got.channel_columns() == want.channel_columns()


def test_registry_morphology_layout_matches_jax():
    for kw in ({}, {"include_glcm": False}, {"channel_names": ["DAPI", "CD3"]}):
        names = kw.pop("channel_names", None)
        assert registry.feature_names(2, channel_names=names, include_morphology=True, **kw) == \
            jregistry.feature_names(2, channel_names=names, include_morphology=True, **kw)
        assert registry.num_features(2, include_morphology=True, **kw) == \
            jregistry.num_features(2, include_morphology=True, **kw)
        assert registry.columns_by_channel_positional(2, include_morphology=True, num_glcm_blocks=2, **kw) == \
            jregistry.columns_by_channel_positional(2, include_morphology=True, num_glcm_blocks=2, **kw)


def _levels(seed=3, shape=(3, 18, 21, 2), levels=256):
    x = np.random.default_rng(seed).integers(0, levels, size=shape).astype(np.uint8 if levels <= 256 else np.int32)
    x[1, ..., 1] = 0  # an all-zero channel (the rescale's row 0)
    return x


@pytest.mark.parametrize("kw", [
    {},
    {"offset": (2, -3), "symmetric": True},
    {"offset": (0, 1), "normed": True},
    {"offset": (1, 1), "symmetric": True, "normed": True},
    {"offset": (0, 30)},  # leaves the image: a zero matrix
    {"distances": [1, 5], "angles": [0.0, np.pi / 4, np.pi / 2]},
    {"distances": [3], "angles": [0.0, 3 * np.pi / 4], "symmetric": True, "normed": True},
    {"levels": 64, "offset": (1, 0)},
])
@pytest.mark.parametrize("masked", ["none", "shared", "per-channel"])
def test_glcm_matrix_is_bit_equal_to_jax(kw, masked):
    levels = kw.get("levels", 256)
    x = _levels(levels=levels)
    rng = np.random.default_rng(4)
    mask = {"none": None, "shared": rng.random(x.shape[:3]) < 0.7,
            "per-channel": rng.random(x.shape) < 0.6}[masked]
    want = np.asarray(jax_glcm_matrix(x, mask, **kw))
    got = glcm_matrix(x, mask, device="cpu", **kw).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if kw.get("offset") == (0, 30):
        assert not got.any()


def test_glcm_properties_match_jax_and_the_oracle():
    x = _levels(5, (2, 16, 16, 2))
    g = glcm_matrix(x, device="cpu", distances=[1, 5], angles=[0.0, np.pi / 2])  # (B, C, L, L, 2, 2)
    jg = np.asarray(jax_glcm_matrix(x, distances=[1, 5], angles=[0.0, np.pi / 2]))
    got = glcm_properties(g.movedim(-1, 0).movedim(-1, 0), device="cpu")
    want = jax_props(np.moveaxis(np.moveaxis(jg, -1, 0), -1, 0))
    for name in GLCM_FEATURES:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-6, atol=1e-6, err_msg=name)
    for prop in ("contrast", "dissimilarity", "homogeneity", "asm", "energy", "correlation"):
        mine = graycoprops(g, prop, device="cpu").numpy()  # (B, C, 2, 2)
        np.testing.assert_allclose(mine, np.asarray(jax_graycoprops(jg, prop)), rtol=1e-6, atol=1e-6)
        sk_name = "ASM" if prop == "asm" else prop
        for b in range(2):
            for c in range(2):
                np.testing.assert_allclose(mine[b, c], oracle.graycoprops(jg[b, c].astype(np.float64), sk_name),
                                           rtol=1e-5, atol=1e-6, err_msg=prop)
    with pytest.raises(ValueError, match="unknown property"):
        graycoprops(g, "entropy", device="cpu")
    # an all-zero matrix: zeros, correlation 1
    zero = glcm_properties(torch.zeros(3, 3), device="cpu")
    assert float(zero["contrast"]) == 0.0 and float(zero["correlation"]) == 1.0


@pytest.mark.parametrize("kind", ["float", "uint16"])
def test_intensity_direct_matches_jax(kind):
    rng = np.random.default_rng(6)
    shape = (4, 16, 8, 3)
    if kind == "float":
        x = rng.normal(0.5, 0.2, size=shape).astype(np.float32)
        x[2, :6, :, 0] = 0.25  # many ties
    else:
        x = rng.integers(0, 65536, size=shape).astype(np.uint16)
        x[2, :, :, 0] //= 4096  # 16 distinct values: ties everywhere
    x[1, ..., 2] = 3  # a constant channel: NaN kurtosis and skew
    mask = rng.random(shape) < 0.6
    mask[3, ..., 1] = False  # an empty mask: zeros
    mask[1, ..., 2] = True  # 128 pixels, so tpumcia's f32 mean is exact too
    shared = np.repeat(mask[..., :1], 3, axis=-1)
    for m in (None, mask, shared):
        want = np.asarray(jax_direct(x, m))
        got = intensity_features_direct(x, m, device="cpu").numpy()
        assert got.shape == want.shape == (4, 3, 17)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        g, w = np.nan_to_num(got), np.nan_to_num(want)
        scale = np.abs(w).max(axis=(0, 1)) + 1.0  # per feature
        bad = np.abs(g - w) > 1e-6 * np.abs(w) + 1e-6 * scale
        assert not bad.any(), (np.argwhere(bad), g[bad], w[bad])
    got = intensity_features_direct(x, mask, device="cpu").numpy()
    assert (got[3, 1] == 0).all() and np.isnan(got[1, 2, 14:16]).all()
    # a (B, H, W) mask is every channel's (tpumcia raises on it: ROADMAP C)
    np.testing.assert_array_equal(intensity_features_direct(x, mask[..., 0], device="cpu").numpy(),
                                  intensity_features_direct(x, shared, device="cpu").numpy())


def test_intensity_direct_constant_channel_is_nan_at_any_count():
    """A constant channel of 120 pixels: the port's f32 mean is exact (3.0),
    so its variance is 0 and kurtosis and skew are NaN. tpumcia's XLA CPU
    mean comes out 3.0000002 there, which gives a variance of ~6e-14 and
    kurtosis -2, skew -1 (ROADMAP C)."""
    x = np.full((1, 12, 10, 1), 3.0, np.float32)
    got = intensity_features_direct(x, device="cpu").numpy()[0, 0]
    assert got[12] == 3.0 and got[13] == 0.0 and np.isnan(got[14:16]).all()
