"""The CNN path of tpumcia_torch over a device mesh (``fit_cnn(mesh=)``,
``CNNHead`` over a mesh, the occlusion probes, ``run_cnn_pipeline(mesh=)``)
against tpumcia's on its 8-device CPU mesh and against the port's own
unsharded path, on the CPU at a tiny size (depth "10", width 8, 16x16x3, at
most 96 images).

The port's mesh is a pool of CPU "devices" (``["cpu"] * 8``): its slots run
one after the other on one replica; a pool of ``["cpu", "cpu:0"]`` names two
devices, so it keeps two replicas (both on the CPU) and sums their
gradients as it would two cards'. Tolerances:
- the float32 sharded step against tpumcia's (``make_train_step`` under
  ``_param_sharding`` over ``make_mesh(data=4, model=2)``), three steps at
  batch 16: losses rel 1e-4, parameters 1e-4 max abs, as the unsharded test
  of ``test_torch_cnn.py`` holds them;
- float32 reduced gradients against one backward over the whole batch:
  1e-5 x max |g| (the blocks' sums in another order; measured ~1e-7), losses
  rel 1e-5; two replicas against one: bit-equal (the same two additions);
- ``fit_cnn`` over 2, 3 and 8 slots against ``mesh=None``, two epochs at
  the default learning rate (bf16 autocast: each block rounds at its own
  places, and Adam's sign-like steps carry that on): each epoch's mean loss
  within rel 5e-2 (measured <= 1.6e-2; at a learning rate of 3e-3 and batch
  7 it reaches 0.22 by the second epoch) and the same predictions;
- the model axis: ``(data=2, model=2)`` equals ``(data=2, model=1)`` bit for
  bit (the classifier stays whole: the filed divergence);
- the accuracy probes over 1, 3 and 8 slots: bit-equal to the unsharded
  probes and to tpumcia's (the same predictions give the same counts);
  ``predict_logits`` and ``occlusion_map`` (float32 model) within 1e-6,
  bit-equal at 1 slot: oneDNN picks the classifier's GEMM kernel by the
  rows of the block, which moves a logit by up to 2.4e-7 at 4-row blocks;
- ``run_cnn_pipeline``: the same split as tpumcia's, the signal channel
  first in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parity
from tpumcia.io.synthetic import synthetic_multichannel
from tpumcia.models import train as jtrain
from tpumcia.models.cnn import make_resnet as jax_make_resnet
from tpumcia.parallel import mesh as jmesh
from tpumcia_torch.importance import occlusion as tocc
from tpumcia_torch.models import cnn as tcnn
from tpumcia_torch.models import train as ttrain
from tpumcia_torch.parallel import data_parallel as dp
from tpumcia_torch.parallel import mesh as tmesh

HW, C = 16, 3
TINY = dict(width=8, depth="10")
POOL = ["cpu"] * 8


def _mesh(data, model=1, devices=POOL):
    return tmesh.make_mesh(data=data, model=model, devices=devices)


@pytest.fixture(scope="module")
def dataset():
    images, labels, _ = synthetic_multichannel(32, num_classes=3, hw=HW, seed=9)
    return images.astype(np.float32) / 255.0, labels


def _flax_params(model, seed):
    """Initial flax parameters as numpy, every leaf perturbed from a numpy
    seed (as ``test_torch_cnn.py`` makes them)."""
    params = model.init(jax.random.key(seed), jnp.zeros((1, HW, HW, C)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


def _torch_model(params, num_classes):
    model = tcnn.make_resnet(num_classes, in_channels=C, dtype=torch.float32, **TINY)
    model.load_state_dict(tcnn.state_dict_from_flax(params))
    return model.to(memory_format=torch.channels_last)


def test_sharded_step_matches_tpumcias_sharded_step():
    """Three AdamW steps at batch 16 on tpumcia's (data=4, model=2) mesh of
    8 CPU devices (the classifier kernel split over ``model``, the batch at
    ``P("data")``) and on the port's (data=4, model=2) mesh of 8 slots."""
    K = 4  # divisible by the model axis, so tpumcia does split the classifier
    images, labels, _ = synthetic_multichannel(12, num_classes=K, hw=HW, seed=3)
    images = images.astype(np.float32) / 255.0
    cfg = ttrain.CNNConfig(num_classes=K, **TINY)
    jm = jax_make_resnet(K, dtype=jnp.float32, **TINY)
    params = _flax_params(jm, seed=6)

    mesh = jmesh.make_mesh(data=4, model=2)
    jparams = jax.device_put(params, jtrain._param_sharding(params, mesh))
    assert "model" in str(jparams["classifier"]["kernel"].sharding.spec)
    tx = optax.adamw(cfg.learning_rate, weight_decay=cfg.weight_decay)
    opt_state = tx.init(jparams)
    step = jax.jit(jtrain.make_train_step(jm, tx))
    batch = NamedSharding(mesh, P("data"))

    model = _torch_model(params, K)
    tm = _mesh(data=4, model=2)
    replicas = dp.replicate(model, tm)
    optimizer = ttrain.make_optimizer(model, cfg)
    for idx in next(ttrain.epoch_batches(len(images), 16, 1, seed=4))[:3]:
        xb, yb = images[idx], labels[idx]
        jparams, opt_state, jloss = step(jparams, opt_state, jax.device_put(xb, batch),
                                         jax.device_put(jax.nn.one_hot(yb, K), batch))
        tloss = dp.data_parallel_step(replicas, optimizer, tm, torch.from_numpy(xb),
                                      torch.from_numpy(yb.astype(np.int64)))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    want = tcnn.state_dict_from_flax(jax.tree.map(np.asarray, jparams))
    start = tcnn.state_dict_from_flax(params)
    moved = 0.0
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-4, err_msg=name)
        moved = max(moved, float((p - start[name]).abs().max()))
    assert moved > 1e-3


def _grads(model):
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()])


@pytest.mark.parametrize("data,bs", [(2, 16), (3, 16), (8, 16), (8, 7)])
def test_reduced_gradients_match_one_backward(dataset, data, bs):
    """16 rows over 2 slots (8/8), 3 (6/6/4) and 8 (2 each); 7 rows over 8
    slots leaves the last slot empty."""
    images, labels = dataset
    params = _flax_params(jax_make_resnet(3, dtype=jnp.float32, **TINY), seed=7)
    x, y = torch.from_numpy(images[:bs]), torch.from_numpy(labels[:bs].astype(np.int64))
    one = _torch_model(params, 3)
    loss = torch.nn.functional.cross_entropy(one(x), y)
    loss.backward()
    loss = loss.detach()
    model = _torch_model(params, 3)
    mesh = _mesh(data)
    if bs == 7:
        assert tmesh.row_ranges(bs, mesh)[-1] == (7, 7)
    got = dp.reduce_gradients(dp.replicate(model, mesh), mesh, x, y)
    want = _grads(one)
    assert float((_grads(model) - want).abs().max()) <= 1e-5 * float(want.abs().max())
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)


def test_two_replicas_sum_as_one(dataset):
    """A pool of two devices keeps two replicas: their flat gradients summed
    on the first equal one replica's accumulation over the same two slots,
    bit for bit; after a step the second replica holds the primary's
    weights."""
    images, labels = dataset
    params = _flax_params(jax_make_resnet(3, dtype=jnp.float32, **TINY), seed=8)
    x, y = torch.from_numpy(images[:16]), torch.from_numpy(labels[:16].astype(np.int64))
    cfg = ttrain.CNNConfig(num_classes=3, **TINY)
    out = {}
    for name, pool in (("one", ["cpu", "cpu"]), ("two", ["cpu", "cpu:0"])):
        model = _torch_model(params, 3)
        mesh = _mesh(2, devices=pool)
        replicas = dp.replicate(model, mesh)
        assert len(replicas) == (1 if name == "one" else 2)
        loss = dp.data_parallel_step(replicas, ttrain.make_optimizer(model, cfg), mesh, x, y)
        out[name] = (loss, _grads(model), replicas)
    assert torch.equal(out["one"][0], out["two"][0]) and torch.equal(out["one"][1], out["two"][1])
    primary, second = out["two"][2].values()
    assert second is not primary
    assert all(torch.equal(a, b) for a, b in zip(primary.parameters(), second.parameters()))
    with pytest.raises(ValueError, match="first local slot"):
        dp.replicate(_torch_model(params, 3), _mesh(2, devices=["cpu:0", "cpu"]))


@pytest.mark.parametrize("data,bs", [(2, 16), (3, 16), (8, 16), (8, 7)])
def test_fit_cnn_over_a_mesh_matches_unsharded(dataset, data, bs):
    images, labels = dataset
    cfg = ttrain.CNNConfig(num_classes=3, epochs=2, batch_size=bs, **TINY)
    one = ttrain.fit_cnn(images, labels, device="cpu", config=cfg)
    mesh = _mesh(data)
    head = ttrain.fit_cnn(images, labels, device="cuda", config=cfg, mesh=mesh)  # device gives way
    assert head.mesh is mesh and head.device.type == "cpu"
    np.testing.assert_allclose([h["loss"] for h in head.history], [h["loss"] for h in one.history], rtol=5e-2)
    np.testing.assert_array_equal(head.predict(images), one.predict(images))


def test_fit_cnn_mesh_history_with_an_eval_set(dataset):
    images, labels = dataset
    cfg = ttrain.CNNConfig(num_classes=3, epochs=2, batch_size=16, learning_rate=3e-3, **TINY)
    mesh = _mesh(3)
    deferred = ttrain.fit_cnn(images, labels, device="cpu", config=cfg, mesh=mesh)
    with_eval = ttrain.fit_cnn(images, labels, device="cpu", config=cfg, mesh=mesh,
                               images_eval=images[:20], labels_eval=labels[:20])
    assert [h["loss"] for h in with_eval.history] == [h["loss"] for h in deferred.history]
    assert all(0.0 <= h["eval_acc"] <= 1.0 for h in with_eval.history)
    with pytest.raises(TypeError, match="Mesh"):
        ttrain.fit_cnn(images, labels, device="cpu", config=cfg, mesh=object())


def test_model_axis_keeps_the_classifier_whole(dataset):
    """tpumcia splits the classifier kernel over ``model``; the port keeps
    it whole on every replica, so ``model=2`` trains the ``model=1`` head bit
    for bit (ROADMAP, Known divergences)."""
    images, labels = dataset
    cfg = ttrain.CNNConfig(num_classes=3, epochs=1, batch_size=16, learning_rate=3e-3, **TINY)
    split = ttrain.fit_cnn(images, labels, device="cpu", config=cfg, mesh=_mesh(2, model=2, devices=["cpu"] * 4))
    whole = ttrain.fit_cnn(images, labels, device="cpu", config=cfg, mesh=_mesh(2))
    assert split.mesh.shape == {"data": 2, "model": 2}
    assert split.history == whole.history
    for (name, a), b in zip(split.model.state_dict().items(), whole.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert split.model.classifier.weight.shape == (3, 64)  # the 512 * K layer at width 8: whole


# --- the probes over a mesh, one set of float32 weights in both packages -----


@pytest.fixture(scope="module")
def both_heads(dataset):
    images, labels = dataset
    cfg = ttrain.CNNConfig(num_classes=3, epochs=6, batch_size=16, learning_rate=3e-3, **TINY)
    trained = ttrain.fit_cnn(images, labels, device="cpu", config=cfg)
    params = tcnn.flax_params_from_state_dict(trained.model.state_dict())
    jhead = jtrain.CNNHead(model=jax_make_resnet(3, dtype=jnp.float32, **TINY),
                           params=jax.tree.map(jnp.asarray, params), classes=np.unique(labels),
                           mesh=jmesh.make_mesh(data=8))
    return jhead, _torch_model(params, 3), np.unique(labels)


@pytest.mark.parametrize("data", [1, 3, 8])
def test_probes_over_a_mesh_match_unsharded_and_tpumcia(both_heads, dataset, data):
    from tpumcia.importance import occlusion as jocc

    jhead, model, classes = both_heads
    images, labels = dataset
    one = ttrain.CNNHead(model=model, classes=classes)
    head = ttrain.CNNHead(model=model, classes=classes, mesh=_mesh(data))
    logits = head.predict_logits(images)
    assert logits.shape == (len(images), 3)
    torch.testing.assert_close(logits, one.predict_logits(images), rtol=0, atol=1e-6 if data > 1 else 0)
    np.testing.assert_array_equal(head.predict(images), one.predict(images))
    assert head.score(images, labels) == one.score(images, labels)

    got = tocc.channel_occlusion_importance(head, images, labels)
    np.testing.assert_array_equal(got, tocc.channel_occlusion_importance(one, images, labels))
    np.testing.assert_array_equal(got, jocc.channel_occlusion_importance(jhead, images, labels))
    assert got[0] == got.max() > 0

    R = 3
    perms = torch_parity.jax_image_permutations(42, C, R, len(images))
    got = tocc.channel_permutation_importance_images(head, images, labels, n_repeats=R, _perms=perms)
    np.testing.assert_array_equal(
        got, tocc.channel_permutation_importance_images(one, images, labels, n_repeats=R, _perms=perms))
    np.testing.assert_array_equal(
        got, jocc.channel_permutation_importance_images(jhead, images, labels, n_repeats=R, seed=42))
    seeded = tocc.channel_permutation_importance_images(head, images, labels, n_repeats=R, seed=5)
    np.testing.assert_array_equal(  # drawn once over the whole batch, at any slot count
        seeded, tocc.channel_permutation_importance_images(one, images, labels, n_repeats=R, seed=5))

    got = tocc.occlusion_map(head, images[:12], labels[:12], window=8, stride=4)
    want = tocc.occlusion_map(one, images[:12], labels[:12], window=8, stride=4)
    assert got.shape == (12, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 if data > 1 else 0)
    np.testing.assert_allclose(got, jocc.occlusion_map(jhead, images[:12], labels[:12], window=8, stride=4),
                               rtol=0, atol=1e-4)


def test_run_cnn_pipeline_over_a_mesh_matches_tpumcia(dataset):
    from tpumcia.pipeline.run_cnn import run_cnn_pipeline as jax_run_cnn
    from tpumcia_torch.pipeline.run_cnn import run_cnn_pipeline

    images, labels = dataset
    kw = dict(epochs=6, batch_size=16, learning_rate=3e-3, **TINY)
    ours = run_cnn_pipeline(images, labels, device="cpu", config=ttrain.CNNConfig(num_classes=3, **kw),
                            mesh=_mesh(3), n_repeats=2)
    theirs = jax_run_cnn(images, labels, config=jtrain.CNNConfig(num_classes=3, **kw),
                         mesh=jmesh.make_mesh(data=4, model=2), n_repeats=2)
    np.testing.assert_array_equal(ours.train_idx, theirs.train_idx)
    np.testing.assert_array_equal(ours.test_idx, theirs.test_idx)
    assert ours.head.mesh.shape["data"] == 3
    for res in (ours, theirs):
        assert 0.6 <= res.test_accuracy <= 1.0
        assert res.occlusion.top_channel() == 0 and res.permutation.top_channel() == 0
        assert set(res.timings) == {"fit_s", "importance_s"}
