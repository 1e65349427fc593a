"""tpumcia_torch's workflow API against tpumcia's: ``analyze_objects`` on an
``ObjectBatch`` of masked uint16 objects with donors, the package's exports
and its import guard; the card as every entry point's default device (the
named error without one, before any work); the sub-packages' exports, the
fitted models' ``apply_fn`` and the oracle's copy.

Both packages get the same objects (numpy, from a seed) and the same config;
tpumcia's head init and permutation draws are replayed into the port.
Tolerances: the quantized levels and the split are identical; features 1e-5
max abs with the integer-derived columns bit-equal (see
``test_torch_streaming.py``); test accuracy within 0.02; the channel ranking
identical.
"""

import importlib
import inspect
import subprocess
import sys

import numpy as np
import pytest

import tpumcia
import tpumcia_torch as tt
from torch_parity import cytometry_objects, replay_jax_draws
from tpumcia.io.h5 import ObjectBatch as JObjectBatch
from tpumcia_torch.io.h5 import ObjectBatch

FLOAT_DERIVED = ("std_intensity", "kurtosis_intensity", "skew_intensity", "shannon_entropy", "homogeneity")
CHANNELS = [f"Ch{i:02d}-λ" for i in range(12)]
N = 190  # 2 * 64 + 62: the last batch is wrap-padded


def _cfg():
    return dict(
        head={"kind": "logistic", "num_steps": 300},
        split={"test_size": 0.25, "seed": 0, "group_by": "donor"},
        fast_path="always",
        batch_size=64,
    )


def _batches(dtype=np.uint16):
    raw, mask, labels, donors = cytometry_objects(192, hw=32, seed=0)
    raw, mask, labels, donors = raw[:N], mask[:N], labels[:N], donors[:N]
    if dtype == np.uint8:
        raw = (raw >> 8).astype(np.uint8)
    names = np.array(["activated", "resting"])[labels]
    kw = dict(images=raw, masks=mask.astype(np.uint8), labels=names, donors=donors,
              experiments=np.array(["exp1"] * N), channels=list(CHANNELS),
              ids=[str(i) for i in range(N)])
    return ObjectBatch(**kw), JObjectBatch(**kw)


def _assert_same_analysis(got, want, donors):
    assert got.features.names == want.features.names
    assert got.features.names[0] == f"min_intensity_{CHANNELS[0]}"
    a, b = got.features.to_numpy(), np.asarray(want.features.values, np.float64)
    assert a.shape == b.shape == (N, 12 * 23)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    exact = [i for i, n in enumerate(got.features.names) if not n.startswith(FLOAT_DERIVED)]
    np.testing.assert_array_equal(a[:, exact], b[:, exact])
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.train_idx, want.train_idx)
    np.testing.assert_array_equal(got.test_idx, want.test_idx)
    assert not set(donors[got.train_idx]) & set(donors[got.test_idx])
    assert abs(got.test_accuracy - want.test_accuracy) <= 0.02
    assert got.channel_result.ranking.tolist() == want.channel_result.ranking.tolist()
    assert got.channel_result.ranking[0] == 4 and got.channel_result.total[4] > 0


@pytest.mark.parametrize("dtype,config", [
    (np.uint16, "dataclass"), (np.uint16, "dict"), (np.uint8, "dict"),
])
def test_analyze_objects_matches_jax(monkeypatch, dtype, config):
    """Masked 12-channel objects with string labels and donors: uint16 is
    quantized with ``src_levels=65536`` (on the device in the port), uint8
    is taken as levels; a dict config and a dataclass one."""
    objs, jobjs = _batches(dtype)
    if config == "dict":
        cfg, jcfg = _cfg(), {**_cfg(), "mesh": {"data": 1}}
    else:
        cfg = tt.PipelineConfig.from_dict(_cfg())
        jcfg = tpumcia.PipelineConfig.from_dict({**_cfg(), "mesh": {"data": 1}})
    want = tpumcia.analyze_objects(jobjs, config=jcfg)
    replay_jax_draws(monkeypatch)
    got = tt.analyze_objects(objs, device="cpu", config=cfg)
    _assert_same_analysis(got, want, objs.donors)
    assert got.features.channel_names == CHANNELS


def test_analyze_objects_groups_labels_and_errors(monkeypatch):
    objs, jobjs = _batches()
    # group_by='experiment' reads the experiments; one experiment cannot be split
    by_exp = {**_cfg(), "split": {"test_size": 0.25, "seed": 0, "group_by": "experiment"}}
    objs.experiments = jobjs.experiments = np.array([f"e{i % 5}" for i in range(N)])
    want = tpumcia.analyze_objects(jobjs, config={**by_exp, "mesh": {"data": 1}})
    replay_jax_draws(monkeypatch)
    got = tt.analyze_objects(objs, device="cpu", config=by_exp)
    np.testing.assert_array_equal(got.test_idx, want.test_idx)
    assert not set(objs.experiments[got.train_idx]) & set(objs.experiments[got.test_idx])
    # explicit labels override the batch's
    flipped = np.where(objs.labels == "activated", "b", "a")
    res = tt.analyze_objects(objs, device="cpu", config=_cfg(), labels=flipped)
    assert res.channel_result.ranking[0] == 4
    # no labels anywhere; float images; a grouped split without the groups
    objs.labels = None
    with pytest.raises(ValueError, match="objects carry no labels; pass labels= explicitly"):
        tt.analyze_objects(objs, device="cpu", config=_cfg())
    objs.labels = flipped
    objs.images = objs.images.astype(np.float32)
    with pytest.raises(TypeError, match="unsupported image dtype float32"):
        tt.analyze_objects(objs, device="cpu", config=_cfg())
    objs.images = jobjs.images
    objs.donors = None
    with pytest.raises(ValueError, match="no groups were provided"):
        tt.analyze_objects(objs, device="cpu", config=_cfg())


def test_load_then_analyze_from_h5_files(tmp_path, monkeypatch):
    """The documented flow: per-object files -> ``load_objects`` ->
    ``analyze_objects``, the same in both packages."""
    objs, _ = _batches()
    for i in range(96):
        tt.io.h5.write_object(
            tmp_path / f"{i:04d}.h5", objs.images[i], mask=objs.masks[i], label=str(objs.labels[i]),
            donor=str(objs.donors[i]), channels=CHANNELS,
        )
    loaded, jloaded = tt.load_objects(tmp_path), tpumcia.load_objects(tmp_path)
    np.testing.assert_array_equal(loaded.images, jloaded.images)
    np.testing.assert_array_equal(loaded.images, objs.images[:96])
    assert loaded.masks.shape == (96, 32, 32) and loaded.channels == CHANNELS
    cfg = {**_cfg(), "head": {"kind": "logistic", "num_steps": 100}}
    want = tpumcia.analyze_objects(jloaded, config={**cfg, "mesh": {"data": 1}})
    replay_jax_draws(monkeypatch)
    got = tt.analyze_objects(loaded, device="cpu", config=cfg)
    np.testing.assert_array_equal(got.test_idx, want.test_idx)
    np.testing.assert_allclose(got.features.values, np.asarray(want.features.values), rtol=0, atol=1e-5)
    assert got.channel_result.ranking.tolist() == want.channel_result.ranking.tolist()


def test_feature_importance_matches_jax(monkeypatch):
    """``feature_importance`` is the sklearn-shaped permutation importance of
    both packages, on one head carried across."""
    from tpumcia.models.heads import fit_head as jfit_head

    rng = np.random.default_rng(0)
    X = rng.normal(size=(120, 6)).astype(np.float32)
    y = (X[:, 2] > 0).astype(np.int64)
    replay_jax_draws(monkeypatch)
    head = tt.api.fit_head(X, y, device="cpu", config=tt.HeadConfig(kind="logistic", num_steps=80))
    jhead = jfit_head(X, y, config=tpumcia.HeadConfig(kind="logistic", num_steps=80))
    got = tt.feature_importance(head, X, y, n_repeats=4, seed=3)
    want = tpumcia.feature_importance(jhead, X, y, n_repeats=4, seed=3)
    assert got.importances_mean.shape == (6,) and int(np.argmax(got.importances_mean)) == 2
    np.testing.assert_allclose(got.importances_mean, np.asarray(want.importances_mean), atol=2 / 120 + 1e-6)


def test_exports_and_import_guard():
    """What tpumcia exports for this workflow the port exports too, and
    importing the port pulls in no package it must stay free of."""
    for name in ("load_objects", "analyze_objects", "feature_importance", "run_pipeline",
                 "fit_head", "channel_importance", "extract_features"):
        assert name in tpumcia.__all__ and name in tt.__all__ and callable(getattr(tt, name))
    assert "Not ported yet: h5 ingestion" not in tt.__doc__ and "streaming" in tt.__doc__
    code = (
        "import sys, tpumcia_torch, tpumcia_torch.api, tpumcia_torch.io.h5, tpumcia_torch.io.mednist, "
        "tpumcia_torch.io.native, tpumcia_torch.io.loader, tpumcia_torch.io.staging, "
        "tpumcia_torch.pipeline.streaming, tpumcia_torch.utils.logging, tpumcia_torch.models.cnn, "
        "tpumcia_torch.models.train, tpumcia_torch.importance.occlusion, tpumcia_torch.pipeline.run_cnn, "
        "tpumcia_torch.eval, tpumcia_torch.reports.plots, tpumcia_torch.utils.profiling, "
        "tpumcia_torch.parallel, tpumcia_torch.parallel.mesh, tpumcia_torch.parallel.distributed, "
        "tpumcia_torch.parallel.sharding, tpumcia_torch.parallel.dryrun, "
        "tpumcia_torch.reference_impl, tpumcia_torch.features, tpumcia_torch.models, "
        "tpumcia_torch.importance, tpumcia_torch.preprocess\n"
        "bad = {'jax', 'flax', 'optax', 'orbax', 'tpumcia', 'sklearn', 'h5py', 'imageio', 'matplotlib'} "
        "& set(sys.modules)\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# the 14 entry points whose device defaults to the card, then the port's
# other public calls that default to it, each called with placeholders: the
# device check must come before any work
ENTRY_POINTS = {
    "api.analyze_objects": lambda f, tmp: f(None),
    "pipeline.run.run_pipeline": lambda f, tmp: f(None, None),
    "pipeline.run_cnn.run_cnn_pipeline": lambda f, tmp: f(None, None),
    "pipeline.streaming.stream_extract": lambda f, tmp: f(None, 1, tmp / "out"),
    "pipeline.streaming.stream_extract_h5": lambda f, tmp: f(tmp / "none", tmp / "out"),
    "features.extract.extract_features": lambda f, tmp: f(None),
    "features.extract.extract_features_pending": lambda f, tmp: f(None),
    "features.extract.extract_features_batched": lambda f, tmp: f(None),
    "features.stats.rescale_lut_device": lambda f, tmp: f(),
    "models.heads.fit_head": lambda f, tmp: f(None, None),
    "models.train.fit_cnn": lambda f, tmp: f(None, None),
    "models.train.CNNHead.load": lambda f, tmp: f(tmp / "none.pt"),
    "preprocess.synth.add_noise_channels_batched": lambda f, tmp: f(None, seed=0, batch_size=1),
    "io.synthetic.synthetic_multichannel": lambda f, tmp: f(1),
}
OTHER_CARD_DEFAULTS = {
    "features.stats.sufficient_stats": lambda f, tmp: f(None),
    "features.stats.sufficient_stats_multi": lambda f, tmp: f(None),
    "features.stats.glcm_matrix": lambda f, tmp: f(None),
    "features.props.glcm_properties": lambda f, tmp: f(None),
    "features.props.graycoprops": lambda f, tmp: f(None),
    "features.intensity_direct.intensity_features_direct": lambda f, tmp: f(None),
    "features.morphology.morphology_features": lambda f, tmp: f(None),
    "models.scaler.MinMaxScaler.from_stats": lambda f, tmp: f(None, None),
    "models.forest_device.DeviceForest.from_arrays": lambda f, tmp: f(None, None),
    "models.heads.LogisticHead.load": lambda f, tmp: f(tmp / "none.npz"),
    "models.heads.MLPHead.load": lambda f, tmp: f(tmp / "none.npz"),
    "models.heads.RandomForestHead.load": lambda f, tmp: f(tmp / "none.npz"),
    "models.heads.RandomForestHead.from_sklearn": lambda f, tmp: f(None),
}
assert len(ENTRY_POINTS) == 14


def _entry_point(path):
    """(the function at ``tpumcia_torch.<path>``, the name its error gives)."""
    parts = path.split(".")
    if parts[-2][0].isupper():  # a class's method
        cls = getattr(importlib.import_module("tpumcia_torch." + ".".join(parts[:-2])), parts[-2])
        return getattr(cls, parts[-1]), ".".join(parts[-2:])
    return getattr(importlib.import_module("tpumcia_torch." + ".".join(parts[:-1])), parts[-1]), parts[-1]


@pytest.mark.parametrize("path", sorted(ENTRY_POINTS) + sorted(OTHER_CARD_DEFAULTS))
def test_entry_point_defaults_to_the_card(path, tmp_path, monkeypatch):
    """``device`` defaults to ``"cuda"``; where no CUDA device is present
    the default raises the named error before any work (it never carries on
    on the CPU)."""
    import torch

    from tpumcia_torch.utils.device import NoCUDADevice

    fn, what = _entry_point(path)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = ENTRY_POINTS.get(path) or OTHER_CARD_DEFAULTS[path]
    with pytest.raises(NoCUDADevice, match=f"^{what} needs a CUDA device, but no CUDA device is present; "
                                           "pass device='cpu'"):
        call(fn, tmp_path)
    assert issubclass(NoCUDADevice, RuntimeError) and not (tmp_path / "out").exists()


def test_tpumcias_call_without_a_device(monkeypatch):
    """tpumcia's own calls, unchanged (``bench.py``'s ``run_pipeline(images,
    labels, config=cfg)``): refused without a card, never run on the CPU;
    with ``device="cpu"`` the same call runs."""
    import torch

    from tpumcia_torch.utils.device import NoCUDADevice, require_device

    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, size=(40, 16, 16)).astype(np.uint8)
    labels = np.arange(40) % 2
    cfg = tt.PipelineConfig(synth=tt.SynthConfig(noise_channels=2), fast_path="always", batch_size=16,
                            head=tt.HeadConfig(num_steps=5))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCUDADevice):
        tt.run_pipeline(gray, labels, config=cfg)
    with pytest.raises(NoCUDADevice):
        require_device(["cpu", "cuda:0"], "a pool")
    assert require_device(["cpu", "cpu"], "a pool") == ["cpu", "cpu"]
    res = tt.run_pipeline(gray, labels, config=cfg, device="cpu")
    assert res.features.shape == (40, 69)


@pytest.mark.parametrize("package", ["features", "importance", "models", "preprocess", "parallel",
                                     "reference_impl"])
def test_subpackage_exports_match_tpumcia(package):
    """tpumcia's ``__all__`` of each sub-package imports from the port's
    (exactly, where the port adds nothing), each name the object its own
    module defines."""
    want = importlib.import_module(f"tpumcia.{package}").__all__
    got = importlib.import_module(f"tpumcia_torch.{package}")
    assert set(want) <= set(got.__all__)
    if package in ("features", "importance", "models", "preprocess", "reference_impl"):
        assert sorted(got.__all__) == sorted(want)
    for name in got.__all__:
        obj = getattr(got, name)
        home = importlib.import_module(obj.__module__)
        assert getattr(home, name) is obj, name
        assert home.__name__.startswith(f"tpumcia_torch.{package}."), home.__name__


def test_apply_fn_matches_predict():
    """``DeviceForest.apply_fn()`` on scaled features gives ``predict_proba``
    and ``CNNHead.apply_fn()`` on float32 images ``predict_logits``."""
    import torch

    from tpumcia_torch.models import DeviceForest, fit_head
    from tpumcia_torch.models.cnn import init_parameters, make_resnet
    from tpumcia_torch.models.train import CNNHead

    rng = np.random.default_rng(1)
    X = rng.normal(size=(60, 5)).astype(np.float32)
    y = (X[:, 1] > 0).astype(np.int64)
    head = fit_head(X, y, device="cpu", config=tt.HeadConfig(kind="random_forest", n_estimators=5,
                                                             max_depth=3))
    forest = head.to_device()
    assert isinstance(forest, DeviceForest)
    Xs = forest.scaler.transform(torch.from_numpy(X))
    assert torch.equal(forest.apply_fn()(Xs), forest.predict_proba(X))
    model = make_resnet(2, in_channels=3, width=8, depth="10", dtype=torch.float32)
    init_parameters(model, torch.Generator().manual_seed(0))
    cnn = CNNHead(model=model, classes=np.array([0, 1]))
    images = rng.random((4, 16, 16, 3)).astype(np.float32)
    logits = cnn.apply_fn()(torch.from_numpy(images))
    assert torch.equal(logits, cnn.predict_logits(images))


def test_oracle_copy_equals_tpumcias():
    """The port's copy of the oracle gives tpumcia's values bit for bit."""
    import tpumcia.reference_impl as jref
    import tpumcia_torch.reference_impl as tref

    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(24, 24, 3)).astype(np.uint8)
    img[..., 2] = 7  # a constant channel
    np.testing.assert_array_equal(tref.feature_vector(img), jref.feature_vector(img))
    for name in ("glcm_features", "basic_statistical_features"):
        got, want = getattr(tref, name)(img), getattr(jref, name)(img)
        assert list(got) == list(want)
        np.testing.assert_array_equal(np.asarray(list(got.values())), np.asarray(list(want.values())))
    assert tref.feature_names(3) == jref.feature_names(3)
    glcm = tref.graycomatrix(img[..., 0], [1, 5], [0.0, np.pi / 2], levels=256)
    np.testing.assert_array_equal(glcm, jref.graycomatrix(img[..., 0], [1, 5], [0.0, np.pi / 2], levels=256))
    for prop in ("contrast", "homogeneity", "energy", "correlation", "ASM", "dissimilarity"):
        np.testing.assert_array_equal(tref.graycoprops(glcm, prop), jref.graycoprops(glcm, prop))
    assert tref.shannon_entropy(img[..., 1]) == jref.shannon_entropy(img[..., 1])
    gray = img[..., 0]
    np.testing.assert_array_equal(tref.add_noise_channels(gray, np.random.default_rng(3)),
                                  jref.add_noise_channels(gray, np.random.default_rng(3)))
