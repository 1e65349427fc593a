"""The slice end to end: tpumcia_torch.run_pipeline against
tpumcia.run_pipeline on the same images, on the fused path and on the
classic path that tpumcia takes for every other configuration, plus the
port's entry checks.

Both run the fused fast path (``fast_path="always"``, batch 64, so the last
of three batches is wrap-padded) over 180 numpy-made 3-channel images with
no synthesized channels, so both see identical pixels; the port runs the
kernel's plain version on the CPU. JAX's head init and sweep permutations
are replayed into the port. Tolerances:
- features: 1e-5 max abs (f32 moment/entropy/homogeneity words summed in
  another order, then assembled in f64);
- test accuracy: at most 2/N_test apart (f32 argmax near-ties after a head
  fitted with another rounding order);
- channel ranking: identical, with the signal channel first.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import jax_init_weights, jax_permutations
from tpumcia_torch import config as tcfg
from tpumcia_torch.features.extract import check_use_pallas
from tpumcia_torch.models import fused
from tpumcia_torch.pipeline.run import run_pipeline

N_PER_CLASS = 30  # 180 images


@pytest.fixture(scope="module")
def images():
    from tpumcia_torch.io.synthetic import synthetic_mednist

    gray, labels, _ = synthetic_mednist(N_PER_CLASS, num_classes=6, seed=3)
    noise = np.random.default_rng(3).normal(0, 0.1, size=(*gray.shape, 2))
    x = np.concatenate(
        [gray[..., None], (np.clip(noise, 0, 1) * 255).astype(np.uint8)], axis=-1
    )
    return x, labels


def _kw():
    return dict(
        head={"kind": "logistic", "num_steps": 60},
        split={"test_size": 0.25, "seed": 0, "stratify": True},
        fast_path="always",
        batch_size=64,
    )


def test_slice_matches_jax_pipeline(images, monkeypatch):
    from tpumcia.config import PipelineConfig as JPipelineConfig
    from tpumcia.pipeline.run import run_pipeline as jax_run_pipeline

    x, labels = images
    want = jax_run_pipeline(
        x, labels, config=JPipelineConfig.from_dict({**_kw(), "mesh": {"data": 1}})
    )
    monkeypatch.setattr(
        fused, "init_weights",
        lambda f, k, *, seed, device: torch.from_numpy(jax_init_weights(seed, f, k)),
    )
    monkeypatch.setattr(
        fused, "draw_permutations",
        lambda num_draws, n, *, seed, device: torch.from_numpy(
            jax_permutations(seed, num_draws, n)).long(),
    )
    got = run_pipeline(x, labels, config=_kw(), device="cpu")

    assert got.features.shape == want.features.shape == (180, 69)
    assert got.features.names == want.features.names
    a, b = got.features.values, np.asarray(want.features.values)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.features.degenerate, want.features.degenerate)
    np.testing.assert_array_equal(got.test_idx, want.test_idx)
    n_test = len(got.test_idx)
    assert abs(got.test_accuracy - want.test_accuracy) <= 2.0 / n_test + 1e-9
    assert got.channel_result.ranking.tolist() == want.channel_result.ranking.tolist()
    assert got.channel_result.ranking[0] == 0
    dv = got.features.device_values
    assert dv.dtype == torch.float32 and tuple(dv.shape) == (180, 69)
    assert bool(torch.isfinite(dv).all())


def test_slice_with_synthesized_noise_channels():
    """The port's own seeded noise stream: the signal channel wins."""
    from tpumcia_torch.io.synthetic import synthetic_mednist

    gray, labels, _ = synthetic_mednist(N_PER_CLASS, num_classes=6, seed=3)
    cfg = {**_kw(), "synth": {"noise_channels": 2, "seed": 0}}
    res = run_pipeline(gray, labels, config=cfg, device="cpu")
    again = run_pipeline(gray, labels, config=cfg, device="cpu")
    assert res.features.shape == (180, 69)
    np.testing.assert_array_equal(res.features.values, again.features.values)
    assert res.channel_result.ranking[0] == 0
    feat_chan = [res.feature_result.feature_importances[c].sum()
                 for c in res.features.channel_columns()]
    assert int(np.argmax(feat_chan)) == 0
    assert res.test_accuracy >= 0.8


@pytest.mark.parametrize("change", [
    {"features": {"precision": "exact"}},
    {"features": {"glcm": {"distance": [1, 5]}}},
    {"head": {"kind": "mlp", "num_steps": 60}},
    {"importance": {"channel_method": "ablation"}},
    {"fast_path": "never"},
    {"fast_path": "auto"},
])
def test_classic_configs_match_jax_pipeline(images, change, monkeypatch):
    """The configurations tpumcia's fast path does not take run its classic
    path in both packages: the same split and channel ranking, the same
    features (exact 1e-9, otherwise 1e-5), accuracy within 2/N_test; JAX's
    head init and sweep permutations are replayed into the port."""
    from torch_parity import replay_jax_draws
    from tpumcia.config import PipelineConfig as JPipelineConfig
    from tpumcia.pipeline.run import run_pipeline as jax_run_pipeline

    x, labels = images
    cfg = {**_kw(), **change}
    want = jax_run_pipeline(x, labels, config=JPipelineConfig.from_dict({**cfg, "mesh": {"data": 1}}))
    replay_jax_draws(monkeypatch)
    got = run_pipeline(x, labels, config=cfg, device="cpu")
    a, b = got.features.to_numpy(), np.asarray(want.features.values, np.float64)
    assert got.features.names == want.features.names
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    atol = 1e-9 if change.get("features", {}).get("precision") == "exact" else 1e-5
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    np.testing.assert_array_equal(got.test_idx, want.test_idx)
    assert abs(got.test_accuracy - want.test_accuracy) <= 2.0 / len(got.test_idx) + 1e-9
    assert got.channel_result.method == want.channel_result.method
    assert got.channel_result.ranking.tolist() == want.channel_result.ranking.tolist()
    assert got.feature_result.ranking.tolist() == want.feature_result.ranking.tolist()
    assert got.channel_result.ranking[0] == 0


@pytest.mark.parametrize("change,match", [
    ({"mesh": {"data": 2}}, "needs 2 devices, have 1"),
])
def test_unported_configs_raise_named_errors(images, change, match):
    """A mesh larger than the device pool: tpumcia's ValueError."""
    x, labels = images
    with pytest.raises(ValueError, match=match):
        run_pipeline(x, labels, config={**_kw(), **change}, device="cpu")


def test_masks_raise_named_error(images):
    """Masks run on the fast path (an all-ones mask changes nothing); the
    mask uses tpumcia refuses raise its named errors."""
    x, labels = images
    plain = run_pipeline(x, labels, config=_kw(), device="cpu")
    masked = run_pipeline(x, labels, mask=np.ones(x.shape[:3], np.uint8), config=_kw(), device="cpu")
    np.testing.assert_array_equal(masked.features.values, plain.features.values)
    assert masked.channel_result.ranking.tolist() == plain.channel_result.ranking.tolist()
    with pytest.raises(ValueError, match="mask shape .* must equal"):
        run_pipeline(x, labels, mask=np.ones(x.shape[:2], np.uint8), config=_kw(), device="cpu")
    with pytest.raises(ValueError, match="noise_channels does not compose with masks"):
        run_pipeline(x[..., 0], labels, mask=np.ones(x.shape[:3], np.uint8),
                     config={**_kw(), "synth": {"noise_channels": 2}}, device="cpu")


def _cyto_kw():
    return dict(
        head={"kind": "logistic", "num_steps": 300},
        split={"test_size": 0.25, "seed": 0, "group_by": "donor"},
        fast_path="always",
        batch_size=64,
    )


def test_masked_cytometry_matches_jax_pipeline(monkeypatch):
    """BASELINE config 4 at test size: 192 12-channel 32x32 uint16 objects
    quantized to 256 levels, a shared cell mask, donor-grouped split; batch
    64 (the last batch is wrap-padded)."""
    from torch_parity import cytometry_objects
    from tpumcia.config import PipelineConfig as JPipelineConfig
    from tpumcia.pipeline.run import run_pipeline as jax_run_pipeline
    from tpumcia.preprocess.normalize import quantize_to_levels as jax_quantize
    from tpumcia_torch.preprocess.normalize import quantize_to_levels

    raw, mask, labels, donors = cytometry_objects(192, hw=32, seed=0)
    levels = quantize_to_levels(raw, levels=256, src_levels=65536).numpy()
    np.testing.assert_array_equal(levels, np.asarray(jax_quantize(raw, levels=256, src_levels=65536)))
    x = levels[:190]  # 190 = 2*64 + 62: the last batch is wrap-padded
    mask, labels, donors = mask[:190], labels[:190], donors[:190]
    want = jax_run_pipeline(
        x, labels, mask=mask, groups=donors,
        config=JPipelineConfig.from_dict({**_cyto_kw(), "mesh": {"data": 1}}),
    )
    monkeypatch.setattr(
        fused, "init_weights",
        lambda f, k, *, seed, device: torch.from_numpy(jax_init_weights(seed, f, k)),
    )
    monkeypatch.setattr(
        fused, "draw_permutations",
        lambda num_draws, n, *, seed, device: torch.from_numpy(
            jax_permutations(seed, num_draws, n)).long(),
    )
    got = run_pipeline(x, labels, mask=mask, groups=donors, config=_cyto_kw(), device="cpu")

    assert got.features.shape == want.features.shape == (190, 12 * 23)
    a, b = got.features.values, np.asarray(want.features.values)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.test_idx, want.test_idx)
    assert not set(donors[got.train_idx]) & set(donors[got.test_idx])
    assert got.channel_result.ranking.tolist() == want.channel_result.ranking.tolist()
    assert got.channel_result.ranking[0] == 4 and got.channel_result.total[4] > 0


@pytest.mark.parametrize("change,match", [
    ({"importance": {"channel_method": "bogus"}}, "channel_method"),
    ({"split": {"group_by": "donor"}}, "groups"),
])
def test_bad_configs_raise_value_errors(images, change, match):
    x, labels = images
    with pytest.raises(ValueError, match=match):
        run_pipeline(x, labels, config={**_kw(), **change}, device="cpu")


def test_entry_shape_checks(images):
    x, labels = images
    with pytest.raises(ValueError, match="expects"):
        run_pipeline(x[..., 0], labels, config=_kw(), device="cpu")
    with pytest.raises(ValueError, match="labels length"):
        run_pipeline(x, labels[:-1], config=_kw(), device="cpu")
    with pytest.raises(TypeError, match="integer level images"):
        run_pipeline(x.astype(np.float32), labels, config=_kw(), device="cpu")
    with pytest.raises(TypeError, match="outside"):
        run_pipeline(x.astype(np.int32) * 2, labels, config=_kw(), device="cpu")


def test_use_pallas_never_is_refused_on_cuda():
    cfg = dataclasses.replace(tcfg.FeatureConfig(), use_pallas="never")
    with pytest.raises(ValueError, match="CUDA kernel"):
        check_use_pallas(cfg, torch.device("cuda"))
    check_use_pallas(cfg, torch.device("cpu"))  # the CPU always takes the plain version
