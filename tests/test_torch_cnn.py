"""The CNN path of tpumcia_torch against tpumcia on the CPU, at a tiny size
(depth "10", width 8, 16x16x3 images, at most 96 of them): the ResNet with
one set of weights in both packages (``state_dict_from_flax``), three AdamW
steps against ``make_train_step`` + ``optax.adamw``, the epoch order,
``fit_cnn``'s contract (the cases of ``tests/test_cnn.py`` less the sharded
one), the three occlusion probes and ``run_cnn_pipeline``.

Tolerances: float32 logits 1e-4 max abs (the same convolutions summed in
another order; measured ~1e-6); bfloat16 logits 5e-2 with the same argmax
(bf16 rounds at other places in the two frameworks); after three AdamW steps
losses rel 1e-4 and parameters 1e-4 max abs (Adam's first steps are
lr * sign-like, so a parameter moves ~3e-3 in all); occlusion and
image-permutation accuracy drops equal (the same predictions, float32 counts
over B); ``occlusion_map`` 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity
from tpumcia.io.synthetic import synthetic_multichannel
from tpumcia.models import train as jtrain
from tpumcia.models.cnn import make_resnet as jax_make_resnet
from tpumcia_torch.importance import occlusion as tocc
from tpumcia_torch.models import cnn as tcnn
from tpumcia_torch.models import train as ttrain

HW, C, K = 16, 3, 3
TINY = dict(width=8, depth="10")


@pytest.fixture(scope="module")
def dataset():
    images, labels, _ = synthetic_multichannel(32, num_classes=K, hw=HW, seed=9)
    return images.astype(np.float32) / 255.0, labels


def _flax_params(model, hw=HW, channels=C, seed=0):
    """Initial flax parameters as numpy, every leaf perturbed from a numpy
    seed so that norm scales and biases are not the trivial 1 and 0."""
    params = model.init(jax.random.key(seed), jnp.zeros((1, hw, hw, channels)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


def _torch_model(params, *, channels=C, dtype=torch.float32, num_classes=K, **kw):
    model = tcnn.make_resnet(num_classes, in_channels=channels, dtype=dtype, **(kw or TINY))
    model.load_state_dict(tcnn.state_dict_from_flax(params))
    return model


@pytest.mark.parametrize("hw", [16, 15])
def test_forward_f32_matches_flax(hw, monkeypatch):
    """An even size (flax pads the stride-2 3x3 convolutions (0, 1)) and an
    odd one ((1, 1)); GroupNorm's epsilon is flax's 1e-6."""
    jm = jax_make_resnet(K, dtype=jnp.float32, **TINY)
    params = _flax_params(jm, hw=hw)
    x = np.random.default_rng(1).random((5, hw, hw, C)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = _torch_model(params)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, K)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)
    # the epsilon and the padding are what the agreement rests on: PyTorch's
    # default epsilon moves the logits by ~3e-5, symmetric padding at stride
    # 2 on an even size by far more
    err = np.abs(got.detach().numpy() - want).max()
    other = _torch_model(params)
    for m in other.modules():
        if isinstance(m, torch.nn.GroupNorm):
            m.eps = 1e-5
    assert err < 5e-6 and np.abs(other(torch.from_numpy(x)).detach().numpy() - want).max() > 1e-5
    monkeypatch.setattr(tcnn, "_same_pads", lambda size, kernel, stride: ((kernel - 1) // 2,) * 2)
    symmetric = np.abs(_torch_model(params)(torch.from_numpy(x)).detach().numpy() - want).max()
    assert symmetric > 1e-2  # 16 -> 8 -> 4 -> 2 and 15 -> 8 -> 4 -> 2: an even size meets stride 2 either way
    monkeypatch.undo()
    assert tcnn._same_pads(16, 3, 2) == (0, 1) and tcnn._same_pads(15, 3, 2) == (1, 1)
    assert tcnn._same_pads(16, 3, 1) == (1, 1) and tcnn._same_pads(16, 1, 2) == (0, 0)


def test_forward_bf16_matches_flax():
    jm = jax_make_resnet(K, **TINY)  # dtype=bfloat16, float32 parameters
    params = _flax_params(jm, seed=2)
    x = np.random.default_rng(2).random((8, HW, HW, C)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    model = _torch_model(params, dtype=torch.bfloat16)
    got = model(torch.from_numpy(x)).detach()
    assert got.dtype == torch.float32  # the classifier stays float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-2)
    np.testing.assert_array_equal(got.numpy().argmax(1), want.argmax(1))
    f32 = _torch_model(params)(torch.from_numpy(x)).detach()
    assert not torch.equal(f32, got)  # bf16 compute did take place


def test_weights_cross_both_ways():
    """``flax_params_from_state_dict`` inverts ``state_dict_from_flax``, and
    weights that the port initialized run in tpumcia's module."""
    jm = jax_make_resnet(K, dtype=jnp.float32, **TINY)
    params = _flax_params(jm, seed=3)
    sd = tcnn.state_dict_from_flax(params)
    back = tcnn.flax_params_from_state_dict(sd)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, params))
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, params, back)))
    model = tcnn.make_resnet(K, in_channels=C, dtype=torch.float32, **TINY)
    assert set(sd) == set(model.state_dict())
    tcnn.init_parameters(model, torch.Generator().manual_seed(5))
    x = np.random.default_rng(3).random((3, HW, HW, C)).astype(np.float32)
    want = np.asarray(jm.apply({"params": tcnn.flax_params_from_state_dict(model.state_dict())}, jnp.asarray(x)))
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(), want, rtol=0, atol=1e-4)


def test_init_has_tpumcias_distributions():
    """lecun-normal convolutions and dense kernel (variance 1 / fan_in,
    truncated at 2 sigma), unit scales, zero biases; the same seed gives the
    same weights."""
    a = tcnn.make_resnet(4, in_channels=5, width=64, depth="10")
    b = tcnn.make_resnet(4, in_channels=5, width=64, depth="10")
    tcnn.init_parameters(a, torch.Generator().manual_seed(7))
    tcnn.init_parameters(b, torch.Generator().manual_seed(7))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    w = a.stage3_block0.conv2.weight.detach()  # fan_in 512 * 9
    fan_in = w[0].numel()
    assert abs(float(w.var()) * fan_in - 1.0) < 0.02
    assert float(w.abs().max()) <= 2 * (1 / fan_in) ** 0.5 / tcnn._TRUNCATED_STD + 1e-9
    assert bool((a.GroupNorm_0.weight == 1).all()) and not bool(a.classifier.bias.any())
    assert abs(float(a.classifier.weight.detach().var()) * 512 - 1.0) < 0.1


def test_resnet_forward_shapes_and_arbitrary_width():
    """A 7-channel stem; width 48 (not divisible by 32) picks 24 groups."""
    model = tcnn.make_resnet(5, in_channels=7, **TINY)
    logits = model(torch.zeros((2, 32, 32, 7)))
    assert tuple(logits.shape) == (2, 5) and logits.dtype == torch.float32
    for features in (8, 48, 64, 96, 7):
        from tpumcia.models.cnn import _num_groups as jax_num_groups

        assert tcnn._num_groups(features) == jax_num_groups(features)
    assert tcnn._num_groups(48) == 24
    wide = tcnn.make_resnet(4, in_channels=3, width=48, depth="10")
    assert tuple(wide(torch.zeros((2, 32, 32, 3))).shape) == (2, 4)
    assert [len(tcnn.STAGE_SIZES[d]) for d in ("10", "18", "34")] == [4, 4, 4]
    with pytest.raises(ValueError, match="expected"):
        model(torch.zeros((2, 32, 32, 3)))


def test_three_adamw_steps_match_optax(dataset):
    """The same float32 weights and the same three batches through
    ``make_train_step`` + ``optax.adamw`` and through the port's step."""
    images, labels = dataset
    cfg = ttrain.CNNConfig(num_classes=K, **TINY)
    jm = jax_make_resnet(K, dtype=jnp.float32, **TINY)
    params = _flax_params(jm, seed=4)
    tx = optax.adamw(cfg.learning_rate, weight_decay=cfg.weight_decay)
    step = jax.jit(jtrain.make_train_step(jm, tx))
    jparams, opt_state = jax.tree.map(jnp.asarray, params), None
    opt_state = tx.init(jparams)
    model = _torch_model(params)
    optimizer = ttrain.make_optimizer(model, cfg)
    batches = next(ttrain.epoch_batches(len(images), 16, 1, seed=4))[:3]
    for idx in batches:
        xb, yb = images[idx], labels[idx]
        jparams, opt_state, jloss = step(jparams, opt_state, jnp.asarray(xb), jax.nn.one_hot(yb, K))
        tloss = ttrain.train_step(model, optimizer, torch.from_numpy(xb), torch.from_numpy(yb).long())
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    want = tcnn.state_dict_from_flax(jax.tree.map(np.asarray, jparams))
    moved = 0.0
    start = tcnn.state_dict_from_flax(params)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-4, err_msg=name)
        moved = max(moved, float((p - start[name]).abs().max()))
    assert moved > 1e-3  # the steps did move the weights, norms included
    assert float((model.GroupNorm_0.weight - start["GroupNorm_0.weight"]).abs().max()) > 1e-4


@pytest.mark.parametrize("n,batch_size", [(96, 16), (16, 12), (16, 64), (50, 7)])
def test_epoch_order_equals_tpumcias(monkeypatch, n, batch_size):
    """The index arrays tpumcia's ``fit_cnn`` hands its epoch function,
    recorded there, against ``epoch_batches``."""
    seen = []

    def record(params, opt_state, images_all, y_all, idx_all, *, step, data_shard):
        seen.append(np.asarray(idx_all))
        return params, opt_state, jnp.zeros((idx_all.shape[0],))

    monkeypatch.setattr(jtrain, "_epoch_fn", record)
    rng = np.random.default_rng(0)
    images = rng.random((n, 8, 8, 2)).astype(np.float32)
    labels = rng.integers(0, 2, n)
    jcfg = jtrain.CNNConfig(num_classes=2, epochs=3, batch_size=batch_size, seed=5, **TINY)
    jtrain.fit_cnn(images, labels, config=jcfg)
    got = list(ttrain.epoch_batches(n, batch_size, 3, seed=5))
    assert len(got) == len(seen) == 3
    for g, w in zip(got, seen):
        np.testing.assert_array_equal(g, w)
        assert set(g.ravel().tolist()) == set(range(n))  # every sample trains each epoch


@pytest.fixture(scope="module")
def trained_head(dataset):
    images, labels = dataset
    cfg = ttrain.CNNConfig(num_classes=K, epochs=6, batch_size=16, learning_rate=3e-3, **TINY)
    return ttrain.fit_cnn(images, labels, device="cpu", config=cfg)


def test_cnn_learns(trained_head, dataset):
    images, labels = dataset
    assert [h["epoch"] for h in trained_head.history] == list(range(6))
    assert trained_head.history[-1]["loss"] < trained_head.history[0]["loss"]
    assert trained_head.score(images, labels) > 0.6
    assert trained_head.device.type == "cpu" and trained_head.is_device
    proba = trained_head.predict_proba(images[:5])
    torch.testing.assert_close(proba.sum(1), torch.ones(5))
    np.testing.assert_array_equal(trained_head.classes, np.unique(labels))


def test_cnn_history_deferred_matches_eager(dataset, capsys):
    images, labels = dataset
    cfg = ttrain.CNNConfig(num_classes=K, epochs=3, batch_size=16, learning_rate=3e-3, seed=11, **TINY)
    deferred = ttrain.fit_cnn(images, labels, device="cpu", config=cfg)
    eager = ttrain.fit_cnn(images, labels, device="cpu", config=cfg, verbose=True)
    assert capsys.readouterr().out.count("loss") == 3
    assert deferred.history == eager.history and len(eager.history) == 3
    with_eval = ttrain.fit_cnn(images, labels, device="cpu", config=cfg,
                               images_eval=images[:20], labels_eval=labels[:20])
    assert [h["loss"] for h in with_eval.history] == [h["loss"] for h in eager.history]
    assert all(0.0 <= h["eval_acc"] <= 1.0 for h in with_eval.history)


def test_cnn_trains_with_remainder_and_tiny_datasets(dataset):
    images, labels = dataset
    images, labels = images[::6], labels[::6]  # 16 images
    cfg = ttrain.CNNConfig(num_classes=K, epochs=2, batch_size=64, **TINY)
    head = ttrain.fit_cnn(images, labels, device="cpu", config=cfg)  # n = 16 < batch 64
    assert len(head.history) == 2 and np.isfinite(head.history[-1]["loss"])
    assert head.history[-1]["loss"] != head.history[0]["loss"]  # it stepped
    cfg2 = ttrain.CNNConfig(num_classes=K, epochs=1, batch_size=12, **TINY)
    assert np.isfinite(ttrain.fit_cnn(images, labels, device="cpu", config=cfg2).history[0]["loss"])
    # integer images are levels in [0, 255], divided on the device
    as_u8 = np.round(images * 255).astype(np.uint8)
    h8 = ttrain.fit_cnn(as_u8, labels, device="cpu", config=cfg2)
    hf = ttrain.fit_cnn(as_u8.astype(np.float32) / 255.0, labels, device="cpu", config=cfg2)
    assert h8.history == hf.history
    no_cfg = ttrain.fit_cnn(images[:8], labels[:8], device="cpu", config=None)
    assert no_cfg.config == ttrain.CNNConfig(num_classes=len(np.unique(labels[:8])))  # tpumcia's defaults
    assert dataclasses.asdict(no_cfg.config) == dataclasses.asdict(jtrain.CNNConfig(num_classes=K))


def test_fit_cnn_validates_inputs(dataset):
    """tpumcia's two named errors, word for word."""
    images, labels = dataset
    cfg = ttrain.CNNConfig(num_classes=K, epochs=1, batch_size=8, **TINY)
    jcfg = jtrain.CNNConfig(num_classes=K, epochs=1, batch_size=8, **TINY)
    for bad_images, bad_labels, pattern in [
        (images[..., 0], labels, r"expects \(B, H, W, C\)"), (images, labels[:-2], "does not match"),
    ]:
        with pytest.raises(ValueError, match=pattern) as ours:
            ttrain.fit_cnn(bad_images, bad_labels, device="cpu", config=cfg)
        with pytest.raises(ValueError, match=pattern) as theirs:
            jtrain.fit_cnn(bad_images, bad_labels, config=jcfg)
        assert str(ours.value) == str(theirs.value)


def test_cnn_checkpoint_roundtrip(trained_head, dataset, tmp_path):
    images, _ = dataset
    path = tmp_path / "head.pt"
    trained_head.save(path)
    saved = torch.load(path, weights_only=True)  # tensors and plain values only
    assert set(saved) == {"state_dict", "classes", "config"}
    assert isinstance(saved["classes"], list) and saved["config"]["width"] == 8
    restored = ttrain.CNNHead.load(path, device="cpu")
    assert restored.config == trained_head.config and restored.model.in_channels == C
    assert torch.equal(restored.predict_logits(images[:8]), trained_head.predict_logits(images[:8]))
    np.testing.assert_array_equal(restored.predict(images[:8]), trained_head.predict(images[:8]))
    named = ttrain.CNNHead(model=trained_head.model, classes=np.array(["a", "b", "c"]))
    named.save(path)
    with pytest.raises(ValueError, match="holds no config"):
        ttrain.CNNHead.load(path, device="cpu")
    again = ttrain.CNNHead.load(path, config=trained_head.config, device="cpu")
    assert again.predict(images[:4]).dtype.kind == "U"


# --- the probes, with one set of trained weights in both packages ------------


@pytest.fixture(scope="module")
def both_heads(trained_head, dataset):
    """float32 heads of both packages around the port's trained weights."""
    _, labels = dataset
    params = tcnn.flax_params_from_state_dict(trained_head.model.state_dict())
    jhead = jtrain.CNNHead(model=jax_make_resnet(K, dtype=jnp.float32, **TINY),
                           params=jax.tree.map(jnp.asarray, params), classes=np.unique(labels))
    model = _torch_model(params)
    return jhead, ttrain.CNNHead(model=model, classes=np.unique(labels))


def test_occlusion_probes_match_tpumcia(both_heads, dataset, monkeypatch):
    from tpumcia.importance import occlusion as jocc

    jhead, thead = both_heads
    images, labels = dataset
    np.testing.assert_allclose(thead.predict_logits(images).numpy(),
                               np.asarray(jhead.predict_logits(images)), rtol=0, atol=1e-4)
    want = jocc.channel_occlusion_importance(jhead, images, labels)
    got = tocc.channel_occlusion_importance(thead, images, labels)
    assert got.shape == (C,) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert got[0] == got.max() and got[0] > 0  # channel 1 carries the signal
    filled = tocc.channel_occlusion_importance(thead, images, labels, fill=0.5)
    np.testing.assert_array_equal(filled, jocc.channel_occlusion_importance(jhead, images, labels, fill=0.5))

    R = 3
    perms = torch_parity.jax_image_permutations(42, C, R, len(images))
    want = jocc.channel_permutation_importance_images(jhead, images, labels, n_repeats=R, seed=42)
    got = tocc.channel_permutation_importance_images(thead, images, labels, n_repeats=R, _perms=perms)
    assert got.shape == (C, R)
    np.testing.assert_array_equal(got, want)
    own = tocc.channel_permutation_importance_images(thead, images, labels, n_repeats=R, seed=42)
    assert own.shape == (C, R) and own.mean(1)[0] == own.mean(1).max()
    # a small chunk gives the same drops: an altered copy exists per chunk only
    monkeypatch.setattr(tocc, "PREDICT_CHUNK", 7)
    chunked = tocc.channel_permutation_importance_images(thead, images, labels, n_repeats=R, _perms=perms)
    np.testing.assert_array_equal(chunked, got)
    with pytest.raises(ValueError, match="n_repeats"):
        tocc.channel_permutation_importance_images(thead, images, labels, n_repeats=0)
    with pytest.raises(ValueError, match="_perms"):
        tocc.channel_permutation_importance_images(thead, images, labels, n_repeats=2, _perms=perms)


def test_occlusion_map_matches_tpumcia(both_heads, dataset):
    from tpumcia.importance import occlusion as jocc

    jhead, thead = both_heads
    images, labels = dataset
    for window, stride, shape in [(8, 8, (2, 2)), (8, 4, (3, 3)), (32, 8, (1, 1))]:
        want = jocc.occlusion_map(jhead, images[:6], labels[:6], window=window, stride=stride)
        got = tocc.occlusion_map(thead, images[:6], labels[:6], window=window, stride=stride)
        assert got.shape == (6, *shape) == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # a label never seen in training: -1, a misprediction in the accuracy
    # probes, the last class in the map, in both packages
    odd = labels[:6].copy()
    odd[0] = 99
    np.testing.assert_allclose(tocc.occlusion_map(thead, images[:6], odd),
                               jocc.occlusion_map(jhead, images[:6], odd), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tocc.channel_occlusion_importance(thead, images[:6], odd),
                                  jocc.channel_occlusion_importance(jhead, images[:6], odd))


def test_run_cnn_pipeline_ranks_the_signal_channel_in_both_packages(dataset):
    from tpumcia.pipeline.run_cnn import run_cnn_pipeline as jax_run_cnn
    from tpumcia_torch.pipeline.run_cnn import run_cnn_pipeline

    images, labels = dataset
    kw = dict(epochs=6, batch_size=16, learning_rate=3e-3, **TINY)
    ours = run_cnn_pipeline(images, labels, device="cpu", config=ttrain.CNNConfig(num_classes=K, **kw), n_repeats=2)
    theirs = jax_run_cnn(images, labels, config=jtrain.CNNConfig(num_classes=K, **kw), n_repeats=2)
    np.testing.assert_array_equal(ours.train_idx, theirs.train_idx)
    np.testing.assert_array_equal(ours.test_idx, theirs.test_idx)
    for res in (ours, theirs):
        assert 0.6 <= res.test_accuracy <= 1.0
        assert res.occlusion.num_channels == res.permutation.num_channels == C
        assert res.occlusion.top_channel() == 0 and res.permutation.top_channel() == 0
        assert "precision" in res.report
        assert set(res.timings) == {"fit_s", "importance_s"}
    assert ours.occlusion.method == theirs.occlusion.method == "occlusion"
    assert ours.permutation.method == theirs.permutation.method == "image_permutation"
    assert len(ours.permutation.per_channel[0]) == 2 and np.isfinite(ours.permutation.mean).all()
    assert "test accuracy" in ours.summary()
    # uint8 images are scaled by the dtype's maximum, as tpumcia scales them
    as_u8 = np.round(images * 255).astype(np.uint8)
    again = run_cnn_pipeline(as_u8, labels, device="cpu", config=ttrain.CNNConfig(num_classes=K, **kw), n_repeats=2)
    assert again.test_accuracy == ours.test_accuracy
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        run_cnn_pipeline(images[..., 0], labels, device="cpu")
