"""The classic ``run_pipeline`` path of tpumcia_torch against tpumcia, on the
CPU: ``fit_head`` (logistic and MLP), ``permutation_importance``,
``channel_importance`` in every ported method, the npz head checkpoints
across packages, the fast/classic routing, the classic path's noise
channels, and the whole classic slice at 512 levels and at 256 levels with
``fast_path='never'``.

JAX's draws (head init, sweep permutations) are replayed into the port.
Tolerances:
- head params after the same Adam steps from the same init: 1e-4 abs
  (f32 matmuls and Adam updates rounded in another order);
- sweep drops: at most 1/N_test per entry (an f32 argmax near-tie);
- features: 1e-5 max abs (f32 wire words summed in another order);
- rankings and splits: identical.
"""

import inspect

import numpy as np
import pytest
import torch

from torch_parity import jax_init_weights, jax_mlp_init, jax_permutations, replay_jax_draws
from tpumcia.config import HeadConfig as JHeadConfig
from tpumcia.config import ImportanceConfig as JImportanceConfig
from tpumcia.config import PipelineConfig as JPipelineConfig
from tpumcia.importance import channels as jchannels
from tpumcia.importance import permutation as jperm
from tpumcia.models import heads as jheads
from tpumcia.pipeline.run import _fast_path_ok as jax_fast_path_ok
from tpumcia.pipeline.run import run_pipeline as jax_run_pipeline
from tpumcia_torch.config import HeadConfig, ImportanceConfig, PipelineConfig
from tpumcia_torch.features import cuda_glcm
from tpumcia_torch.features.extract import FeatureMatrix, extract_features, extract_features_pending
from tpumcia_torch.importance import permutation as perm
from tpumcia_torch.importance.channels import channel_importance
from tpumcia_torch.models.heads import LogisticHead, MLPHead, fit_head
from tpumcia_torch.pipeline.run import _fast_path_ok, run_pipeline
from tpumcia_torch.preprocess.synth import add_noise_channels_batched

PARAM_ATOL = 1e-4


def _problem(n=160, channels=3, seed=0):
    """A (n, 23*channels) f32 matrix whose channel 0 carries the label (its
    first intensity column and its first GLCM column, in the positional
    layout), with labels in {3, 7} and a dead column."""
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(n) < 0.5, 3, 7)
    X = rng.normal(size=(n, 23 * channels)).astype(np.float32)
    X[:, 0] += 2.5 * (y == 7)
    X[:, 17 * channels] -= 2.0 * (y == 7)
    X[:, 5] = 1.0
    return X, y


def _fm(X, channels=3):
    from tpumcia_torch.features import registry

    return FeatureMatrix(values=X, names=registry.feature_names(channels), num_channels=channels)


def _jfm(X, channels=3):
    from tpumcia.features import registry
    from tpumcia.features.extract import FeatureMatrix as JFM

    return JFM(values=X, names=registry.feature_names(channels), num_channels=channels)


def _params_close(got: dict, want: dict):
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("kind", ["logistic", "mlp"])
def test_fit_head_matches_jax(kind, monkeypatch):
    X, y = _problem()
    # the MLP for 20 steps: by ~40 a few ReLU units die at a step that f32
    # rounding decides, and Adam's normalised update carries that difference
    cfg = dict(kind=kind, num_steps=60 if kind == "logistic" else 20, hidden=(16,))
    want = jheads.fit_head(X, y, config=JHeadConfig(**cfg))
    replay_jax_draws(monkeypatch)
    got = fit_head(X, y, device="cpu", config=HeadConfig(**cfg))
    np.testing.assert_array_equal(got.classes, want.classes)
    np.testing.assert_array_equal(got.scaler.data_min.numpy(), np.asarray(want.scaler.data_min))
    np.testing.assert_array_equal(got.scaler.data_max.numpy(), np.asarray(want.scaler.data_max))
    if kind == "logistic":
        _params_close(got.params, want.params)
        np.testing.assert_allclose(got.coefficient_importance(), want.coefficient_importance(),
                                   rtol=0, atol=1e-4)
    else:
        for g, w in zip([*got.params["hidden"], got.params["out"]],
                        [*want.params["hidden"], want.params["out"]]):
            _params_close(g, w)
    np.testing.assert_array_equal(got.predict(X), want.predict(X))
    np.testing.assert_allclose(got.predict_proba(X).numpy(), np.asarray(want.predict_proba(X)),
                               rtol=0, atol=1e-4)
    assert got.score(X, y) == want.score(X, y)


def test_mlp_init_replay_is_tpumcias_draw():
    """The replay helper gives tpumcia's own initial MLP params: with zero
    steps its fit returns them unchanged."""
    X, y = _problem()
    head = jheads.MLPHead.fit(X, y, config=JHeadConfig(kind="mlp", num_steps=0, hidden=(8, 4)))
    want = jax_mlp_init(0, [X.shape[1], 8, 4, 2])
    for g, w in zip([*head.params["hidden"], head.params["out"]], [*want["hidden"], want["out"]]):
        np.testing.assert_array_equal(np.asarray(g["w"]), w["w"])
        np.testing.assert_array_equal(np.asarray(g["b"]), w["b"])


@pytest.mark.parametrize("kind,match,exc", [
    ("svm", "unknown head kind", ValueError),
])
def test_fit_head_refuses_what_it_does_not_fit(kind, match, exc):
    X, y = _problem()
    with pytest.raises(exc, match=match):
        fit_head(X, y, device="cpu", config=HeadConfig(kind=kind))
    with pytest.raises(ValueError, match="2 distinct classes"):
        fit_head(X, np.zeros(len(X)), device="cpu")
    with pytest.raises(ValueError, match="labels"):
        fit_head(X, y[:-1], device="cpu")


def _carried_heads(X, y):
    """A fitted tpumcia head of each kind and the same head in the port."""
    out = []
    for kind, cls in (("logistic", LogisticHead), ("mlp", MLPHead)):
        jh = jheads.fit_head(X, y, config=JHeadConfig(kind=kind, num_steps=40, hidden=(16,)))
        th = cls.from_numpy(jh.params, jh.classes, jh.scaler.data_min, jh.scaler.data_max,
                            config=HeadConfig(kind=kind, num_steps=40, hidden=(16,)), device="cpu")
        out.append((kind, jh, th))
    return out


@pytest.mark.parametrize("grouped", [False, True])
def test_permutation_importance_with_injected_permutations(grouped, monkeypatch):
    X, y = _problem()
    Xte, yte = X[:64], y[:64]
    from tpumcia_torch.features import registry

    groups = registry.columns_by_channel_positional(3) if grouped else None
    monkeypatch.setattr(perm, "draw_permutations", lambda num_draws, n, *, seed, device:
                        torch.from_numpy(jax_permutations(seed, num_draws, n)).long())
    for kind, jh, th in _carried_heads(X, y):
        want = jperm.permutation_importance(jh, Xte, yte, n_repeats=4, seed=7, groups=groups)
        got = perm.permutation_importance(th, Xte, yte, n_repeats=4, seed=7, groups=groups)
        assert got.importances.shape == want.importances.shape
        assert abs(got.baseline_score - want.baseline_score) <= 1 / 64 + 1e-9, kind
        np.testing.assert_allclose(got.importances, want.importances, rtol=0, atol=1 / 64 + 1e-6)
        assert got.ranking()[0] == want.ranking()[0] == (0 if grouped else got.ranking()[0])
        assert got.ranking()[0] in ((0,) if grouped else (0, 51))
    with pytest.raises(ValueError, match="n_repeats"):
        perm.permutation_importance(th, Xte, yte, n_repeats=0)
    with pytest.raises(TypeError, match="no device scoring path"):
        perm.permutation_importance(object(), Xte, yte)


# coef reads the same carried weights; permutation and ablation score the
# same permuted or zeroed rows, so a total may differ by one of 64 test
# predictions; permutation_features sums 23 such columns per channel
_TOTAL_ATOL = {"coef": 1e-6, "permutation": 1 / 64 + 1e-6, "ablation": 1 / 64 + 1e-6,
               "permutation_features": 23 / 64}


@pytest.mark.parametrize("method", ["coef", "permutation", "permutation_features", "ablation", "auto"])
def test_channel_importance_matches_jax(method, monkeypatch):
    X, y = _problem()
    Xte, yte = X[:64], y[:64]
    monkeypatch.setattr(perm, "draw_permutations", lambda num_draws, n, *, seed, device:
                        torch.from_numpy(jax_permutations(seed, num_draws, n)).long())
    for kind, jh, th in _carried_heads(X, y):
        if method == "coef" and kind == "mlp":
            with pytest.raises(TypeError, match="LogisticHead"):
                channel_importance(th, _fm(Xte), yte, method=method)
            continue
        want = jchannels.channel_importance(jh, _jfm(Xte), yte, method=method,
                                            config=JImportanceConfig(n_repeats=4))
        got = channel_importance(th, _fm(Xte), yte, method=method, config=ImportanceConfig(n_repeats=4))
        assert got.method == want.method
        assert got.ranking.tolist() == want.ranking.tolist(), (kind, got.total, want.total)
        np.testing.assert_allclose(got.total, want.total, rtol=0, atol=_TOTAL_ATOL[got.method])
        assert got.ranking[0] == 0


def test_channel_importance_refuses_mdi_and_a_mesh():
    """MDI needs a forest (tpumcia's TypeError); a mesh must be a
    ``parallel.Mesh``."""
    X, y = _problem()
    head = fit_head(X, y, device="cpu", config=HeadConfig(num_steps=5))
    with pytest.raises(TypeError, match="mdi requires a RandomForestHead"):
        channel_importance(head, _fm(X), y, method="mdi")
    with pytest.raises(TypeError, match="Mesh"):
        channel_importance(head, _fm(X), y, mesh=object())
    with pytest.raises(ValueError, match="needs labels"):
        channel_importance(head, _fm(X), method="permutation")


@pytest.mark.parametrize("kind", ["logistic", "mlp"])
def test_head_checkpoints_load_across_packages(kind, tmp_path, monkeypatch):
    X, y = _problem()
    cfg = dict(kind=kind, num_steps=30, hidden=(8,))
    jh = jheads.fit_head(X, y, config=JHeadConfig(**cfg))
    th = fit_head(X, y, device="cpu", config=HeadConfig(**cfg))
    cls, jcls = (LogisticHead, jheads.LogisticHead) if kind == "logistic" else (MLPHead, jheads.MLPHead)
    jh.save(tmp_path / "jax.npz")
    th.save(tmp_path / "torch.npz")
    from_jax = cls.load(tmp_path / "jax.npz", device="cpu")
    from_torch = jcls.load(tmp_path / "torch.npz")
    assert from_jax.config == th.config and from_torch.config == jh.config
    np.testing.assert_array_equal(from_jax.predict(X), jh.predict(X))
    np.testing.assert_array_equal(from_torch.predict(X), th.predict(X))
    np.testing.assert_allclose(from_torch.predict_proba(X), th.predict_proba(X).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(cls.load(tmp_path / "torch.npz", device="cpu").scaler.data_max.numpy(),
                                  th.scaler.data_max.numpy())


@pytest.mark.parametrize("cls", [LogisticHead, MLPHead])
@pytest.mark.parametrize("entry", ["load", "from_numpy"])
def test_restored_heads_default_to_the_card(cls, entry):
    """A restored or carried head runs on the card unless the caller asks
    for the CPU, as every entry of the port does (read from the signature;
    nothing launches)."""
    assert inspect.signature(getattr(cls, entry)).parameters["device"].default == "cuda"


def test_routing_mirrors_jax():
    """For a grid of configs and input shapes, both packages pick the same
    path (fused fast path or classic)."""
    grid = [
        {}, {"fast_path": "always"}, {"fast_path": "never"},
        {"head": {"kind": "mlp"}, "fast_path": "always"},
        {"head": {"kind": "random_forest"}, "fast_path": "always"},
        {"importance": {"channel_method": "mdi"}, "fast_path": "always"},
        {"importance": {"channel_method": "auto"}, "fast_path": "always"},
        {"features": {"include_morphology": True}, "fast_path": "always"},
        {"normalize": "none", "fast_path": "always"},
        {"importance": {"channel_match": "substring"}, "fast_path": "always"},
        {"importance": {"channel_method": "ablation"}, "fast_path": "always"},
        {"features": {"precision": "exact"}, "fast_path": "always"},
        {"features": {"glcm": {"levels": 512}}, "fast_path": "always"},
        {"features": {"glcm": {"distance": [1, 2]}}, "fast_path": "always"},
        {"synth": {"noise_channels": 2}, "fast_path": "always"},
        {"synth": {"noise_channels": 2}},
    ]
    shapes = [(5000, 16, 16, 3), (100, 16, 16, 3), (5000, 256, 256, 1), (5000, 16, 16), (100, 16, 16)]
    picked = []
    for change in grid:
        for shape in shapes:
            for mask in (None, np.ones(1)):
                images = np.empty(shape, np.uint8)
                want = jax_fast_path_ok(JPipelineConfig.from_dict(change), images, mask, None)
                got = _fast_path_ok(PipelineConfig.from_dict(change), images, mask)
                assert got == want, (change, shape, mask is None)
                picked.append(got)
    assert any(picked) and not all(picked)


def test_classic_noise_channels_equal_the_fast_paths():
    """The classic path's channels-last synthesis draws the fast path's
    per-batch stream (wrap-padded last batch included): the same dataset,
    so the same features."""
    from tpumcia_torch.io.synthetic import synthetic_mednist

    gray, _, _ = synthetic_mednist(12, num_classes=6, seed=4)  # 72 images, batches of 32
    x = add_noise_channels_batched(gray, seed=5, batch_size=32, device="cpu")
    assert x.dtype == torch.uint8 and tuple(x.shape) == (72, 64, 64, 3)
    np.testing.assert_array_equal(x[..., 0].numpy(), gray)
    fast = extract_features_pending(gray, device="cpu", batch_size=32, synth_noise=2,
                                    synth_seed=5).result()
    classic = extract_features(x, device="cpu")
    np.testing.assert_array_equal(classic.values, fast.values)
    again = add_noise_channels_batched(torch.from_numpy(gray), seed=5, batch_size=32, device="cpu")
    assert torch.equal(again, x)
    assert not torch.equal(add_noise_channels_batched(gray, seed=6, batch_size=32, device="cpu"), x)


def _images_512(n_per_class=34, seed=6):
    """~200 small 3-channel images at 512 levels: a signal channel from
    synthetic_mednist (x2 plus a random bit) and two noise channels."""
    from tpumcia_torch.io.synthetic import synthetic_mednist

    gray, labels, _ = synthetic_mednist(n_per_class, num_classes=6, hw=32, seed=seed)
    rng = np.random.default_rng(seed)
    signal = gray.astype(np.uint16) * 2 + rng.integers(0, 2, size=gray.shape, dtype=np.uint16)
    noise = (np.clip(rng.normal(0, 0.1, size=(*gray.shape, 2)), 0, 1) * 511).astype(np.uint16)
    return np.concatenate([signal[..., None], noise], axis=-1), labels


@pytest.mark.parametrize("case", ["levels_512", "never_256"])
def test_classic_slice_matches_jax(case, monkeypatch):
    """The classic slice in both packages: at 512 levels (the packed f32
    wire, kernel form B1d) with fast_path='auto', and at 256 levels with
    fast_path='never'. The same split, features within 1e-5, the same
    channel ranking in both views, the signal channel first."""
    cfg = dict(head={"kind": "logistic", "num_steps": 100},
               split={"test_size": 0.25, "seed": 0, "stratify": True}, batch_size=64)
    if case == "levels_512":
        x, labels = _images_512()
        cfg["features"] = {"glcm": {"levels": 512}}
    else:
        x, labels = _images_512()
        x = (x >> 1).astype(np.uint8)
        cfg["fast_path"] = "never"
    want = jax_run_pipeline(x, labels, config=JPipelineConfig.from_dict({**cfg, "mesh": {"data": 1}}))
    replay_jax_draws(monkeypatch)
    cuda_glcm.reset_launch_counts()
    got = run_pipeline(x, labels, config=cfg, device="cpu")
    assert cuda_glcm.LAUNCHES == 0  # the CPU takes the plain version
    a, b = got.features.values, np.asarray(want.features.values)
    assert a.shape == b.shape == (len(x), 69)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.train_idx, want.train_idx)
    np.testing.assert_array_equal(got.test_idx, want.test_idx)
    assert abs(got.test_accuracy - want.test_accuracy) <= 2.0 / len(got.test_idx) + 1e-9
    assert got.channel_result.ranking.tolist() == want.channel_result.ranking.tolist()
    assert got.feature_result.ranking.tolist() == want.feature_result.ranking.tolist()
    assert got.channel_result.ranking[0] == 0 and got.test_accuracy >= 0.8
    assert isinstance(got.head, LogisticHead) and got.timings["features_s"] > 0


def test_classic_slice_with_noise_channels_runs_on_the_port_stream():
    """Synthesized noise channels on the classic path (fast_path='never')
    give the fast path's features (the same per-batch stream) and rank the
    signal channel first."""
    from tpumcia_torch.io.synthetic import synthetic_mednist

    gray, labels, _ = synthetic_mednist(20, num_classes=6, seed=2)
    base = dict(synth={"noise_channels": 2, "seed": 1}, head={"num_steps": 60}, batch_size=64,
                split={"stratify": True})
    classic = run_pipeline(gray, labels, config={**base, "fast_path": "never"}, device="cpu")
    fast = run_pipeline(gray, labels, config={**base, "fast_path": "always"}, device="cpu")
    np.testing.assert_allclose(classic.features.values, fast.features.values, rtol=0, atol=0)
    np.testing.assert_array_equal(classic.test_idx, fast.test_idx)
    assert classic.channel_result.ranking[0] == fast.channel_result.ranking[0] == 0


@pytest.mark.parametrize("change,exc,match", [
    ({"head": {"kind": "random_forest"}, "mesh": {"data": 2}}, ValueError, "needs 2 devices, have 1"),
    ({"importance": {"channel_method": "mdi"}}, TypeError, "mdi requires a RandomForestHead"),
    ({"features": {"include_morphology": True}}, ValueError, "requires a mask"),
])
def test_classic_path_raises_named_errors(change, exc, match):
    """What the classic path refuses, with tpumcia's errors: a mesh larger
    than the device pool, MDI on a logistic head, morphology without a
    mask."""
    x, labels = _images_512(n_per_class=2)
    with pytest.raises(exc, match=match):
        run_pipeline((x >> 1).astype(np.uint8), labels, config=change, device="cpu")


def test_jax_init_weights_still_replays_logistic_init():
    X, y = _problem()
    head = jheads.LogisticHead.fit(X, y, config=JHeadConfig(num_steps=0))
    np.testing.assert_array_equal(np.asarray(head.params["w"]), jax_init_weights(0, X.shape[1], 2))
