"""``precision='exact'`` and ``'device'`` in tpumcia_torch against tpumcia:
the difference-histogram statistics (the plain version of kernel form B1c)
against the Pallas kernel in interpret mode, the host float64 finalize
against tpumcia's, ``extract_features`` in every precision against
tpumcia's (XLA path, ``use_pallas='never'``) and against the notebook
oracle, and the rest of the extraction entry (FeatureMatrix, the batched
entry, the named errors).

Tolerances: integer statistics and difference histograms bit-equal; host
finalize 1e-12 against tpumcia's on the same statistics (the same float64
formulas); exact features 1e-9 against tpumcia and the oracle (the golden
tolerance); hybrid 1e-5 (f32 wire words); device rel 1e-5 / abs 1e-6 (f32
formulas in another order).
"""

import numpy as np
import pytest
import torch

from torch_parity import to_chw_tensor
from tpumcia.config import FeatureConfig as JFeatureConfig
from tpumcia.features.extract import extract_features as jax_extract
from tpumcia.features.finalize import finalize_features as jax_finalize_features
from tpumcia.features.pallas_glcm import sufficient_stats_pallas
from tpumcia.reference_impl import oracle
from tpumcia_torch.config import FeatureConfig, GLCMConfig
from tpumcia_torch.features import cuda_glcm
from tpumcia_torch.features.extract import (
    FeatureMatrix,
    extract_features,
    extract_features_batched,
    hybrid_wire_ok,
)
from tpumcia_torch.features.finalize import finalize_features
from tpumcia_torch.features.stats import SuffStats, prepare_mask


def _edge_batch(small_batch):
    x = small_batch[:4].copy()
    x[0, :, :, 1] = 0  # all-zero channel
    x[2, :, :, 2] = 77  # constant channel
    return x


@pytest.mark.parametrize("masked", [False, True])
def test_diff_hist_stats_match_pallas_kernel(small_batch, masked):
    x = _edge_batch(small_batch)[:3]
    m = None
    if masked:
        m = np.random.default_rng(3).random(x.shape[:3]) < 0.7
        m[1] = False
    want = sufficient_stats_pallas(x, m, offset=(3, -2), interpret=True, need_diff_hist=True)
    got = cuda_glcm.sufficient_stats(
        to_chw_tensor(x), None if m is None else prepare_mask(m, x.shape, "cpu"),
        levels=256, offset=(3, -2), need_diff=True,
    )
    assert got.dstats is None
    for name in ("hist", "count", "vmax", "marg_l", "marg_r", "diff_hist",
                 "glcm_sumsq", "pair_count"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("need_diff", [True, False])
def test_host_finalize_matches_jax(small_batch, need_diff):
    """tpumcia's host backend and the port's on the same statistics."""
    x = _edge_batch(small_batch)
    js = sufficient_stats_pallas(x, interpret=True, need_diff_hist=need_diff)
    ts = SuffStats(*(None if v is None else torch.from_numpy(np.array(v)) for v in js))
    for inten, glcm in [(True, True), (True, False), (False, True)]:
        want = jax_finalize_features(js, include_intensity=inten, include_glcm=glcm, backend="host")
        got = finalize_features(ts, include_intensity=inten, include_glcm=glcm, backend="host")
        assert got.values.dtype == np.float64
        np.testing.assert_array_equal(np.isnan(got.values), np.isnan(want.values))
        np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(got.degenerate, want.degenerate)


def test_exact_matches_the_oracle(small_batch):
    """tests/test_features_golden.py::test_golden_full_pipeline for the port."""
    ref = np.stack([oracle.feature_vector(im / 255.0) for im in small_batch])
    fm = extract_features(small_batch, device="cpu", config=FeatureConfig(precision="exact"))
    assert fm.shape == ref.shape == (len(small_batch), 69)
    assert np.nanmax(np.abs(fm.values - ref)) < 1e-9
    assert not fm.degenerate.any()


@pytest.mark.parametrize("precision", ["exact", "hybrid", "device"])
@pytest.mark.parametrize("families", ["both", "intensity", "glcm"])
def test_extract_features_matches_jax(small_batch, precision, families):
    x = _edge_batch(small_batch)
    flags = dict(include_intensity=families != "glcm", include_glcm=families != "intensity")
    want = jax_extract(x, config=JFeatureConfig(precision=precision, use_pallas="never", **flags))
    got = extract_features(x, device="cpu", config=FeatureConfig(precision=precision, **flags))
    a, b = got.to_numpy(), np.asarray(want.values, np.float64)
    assert got.names == want.names and a.shape == b.shape
    assert got.channel_columns() == want.channel_columns()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(got.degenerate, np.asarray(want.degenerate))
    if precision == "exact":
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    elif precision == "hybrid":
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_exact_structured_and_edge_values_match_jax(rng):
    """Constant, two-valued and full-range channels (the golden suite's
    edge images), 72x72 past the cheap-limb gate, and an offset of each
    sign: exact features equal tpumcia's to 1e-9 with the same NaNs."""
    imgs = np.zeros((4, 32, 32, 3), dtype=np.uint8)
    imgs[0, :, :, 0] = 7
    imgs[0, :, :, 1] = np.tile(np.arange(32, dtype=np.uint8) * 8, (32, 1))
    imgs[0, 0, 0, 2] = 255
    imgs[1] = (rng.random((32, 32, 3)) * 256).astype(np.uint8)
    imgs[2, :, :, :] = 255
    imgs[3, :16] = 3
    imgs[3, 16:] = 250
    big = (rng.random((1, 72, 72, 2)) * 256).astype(np.uint8)
    for x, angle in [(imgs, 3 * np.pi / 4), (big, 0.0)]:
        kw = dict(glcm=GLCMConfig(distance=2, angle=angle), precision="exact")
        want = jax_extract(x, config=JFeatureConfig(use_pallas="never", **kw))
        got = extract_features(x, device="cpu", config=FeatureConfig(**kw))
        np.testing.assert_array_equal(np.isnan(got.values), np.isnan(want.values))
        np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-9)


def test_feature_matrix_round_trips(tmp_path, small_batch):
    cfg = FeatureConfig(glcm=GLCMConfig(distance=(1, 3)), precision="exact")
    fm = extract_features(small_batch[:2], device="cpu", config=cfg,
                          channel_names=["dapi", "cd3", "cd8"])
    assert fm.names[-1] == "correlation_d3a0_cd8"
    np.testing.assert_array_equal(fm.column("contrast_d1a0_cd3"), fm.values[:, fm.names.index("contrast_d1a0_cd3")])
    path = tmp_path / "fm.npz"
    fm.save(path)
    back = FeatureMatrix.load(path)
    np.testing.assert_array_equal(back.values, fm.values)
    assert back.names == fm.names and back.channel_names == fm.channel_names
    assert back.config == fm.config
    assert back.channel_columns() == fm.channel_columns()
    assert len(back.channel_columns()[0]) == 17 + 2 * 6
    pd = pytest.importorskip("pandas")
    df = fm.to_pandas()
    assert isinstance(df, pd.DataFrame) and list(df.columns) == fm.names


def test_batched_entry_falls_back_per_batch(small_batch):
    """Configs outside the fast path run extract_features per batch."""
    cfg = FeatureConfig(precision="exact")
    one = extract_features(small_batch[:5], device="cpu", config=cfg)
    batched = extract_features_batched(small_batch[:5], device="cpu", batch_size=2, config=cfg)
    np.testing.assert_array_equal(batched.values, one.values)
    with pytest.raises(ValueError, match="keep_device_values"):
        extract_features_batched(small_batch[:5], device="cpu", config=cfg, keep_device_values=True)
    fast = extract_features_batched(small_batch[:5], device="cpu", batch_size=2,
                                    keep_device_values=True)
    assert tuple(fast.device_values.shape) == (5, 69)


def test_hybrid_wire_ok_rules():
    multi = FeatureConfig(glcm=GLCMConfig(distance=(1, 5)))
    assert hybrid_wire_ok(FeatureConfig(), (1, 64, 64, 3))
    assert not hybrid_wire_ok(multi) and hybrid_wire_ok(multi, multi_offset=True)
    assert not hybrid_wire_ok(FeatureConfig(), (1, 256, 256, 3))
    assert not hybrid_wire_ok(FeatureConfig(precision="exact"), multi_offset=True)
    assert not hybrid_wire_ok(FeatureConfig(include_intensity=False))


@pytest.mark.parametrize("levels,shape", [(256, (1, 256, 256, 1)), (512, (1, 8, 8, 1))])
def test_b1d_sizes_run_on_the_cpu(levels, shape):
    """256x256 images and 512 levels (kernel form B1d) run on a CPU device
    through the plain statistics and give tpumcia's features (hybrid: the
    host backend at 256x256, the packed f32 wire at 512 levels)."""
    from tpumcia.config import GLCMConfig as JGLCMConfig

    x = np.random.default_rng(8).integers(0, levels, size=shape).astype(np.uint16)
    want = jax_extract(x, config=JFeatureConfig(glcm=JGLCMConfig(levels=levels)))
    got = extract_features(x, device="cpu", config=FeatureConfig(glcm=GLCMConfig(levels=levels)))
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(want.values))
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.degenerate, np.asarray(want.degenerate))


@pytest.mark.parametrize("kw,shape,exc,match", [
    ({"include_morphology": True}, (1, 8, 8, 1), ValueError, "requires a mask"),
    ({"include_intensity": False, "include_glcm": False}, (1, 8, 8, 1), ValueError, "family"),
    ({"precision": "fast"}, (1, 8, 8, 1), ValueError, "precision"),
    ({}, (8, 8, 1), ValueError, "expected"),
])
def test_entry_raises_named_errors(kw, shape, exc, match):
    with pytest.raises(exc, match=match):
        extract_features(np.zeros(shape, np.uint8), device="cpu", config=FeatureConfig(**kw))


def test_mesh_raises_named_error():
    with pytest.raises(TypeError, match="Mesh"):
        extract_features(np.zeros((1, 8, 8, 1), np.uint8), device="cpu", mesh=object())
