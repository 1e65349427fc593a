"""The port's feature path over a device mesh (``tpumcia_torch.parallel``)
against tpumcia's on its 8-device CPU mesh (``tests/conftest.py``), on the
CPU: one counterpart of each test in ``tests/test_sharding.py``, plus the
port's own checks.

The port's mesh is a pool of CPU "devices" (``["cpu"] * 8``): its slots run
one after the other, through the kernel's plain version. Tolerances:
- integer statistics and the scaler's min/max: bit-equal;
- the sharded statistics and sweeps against the port's unsharded calls:
  bit-equal (an object's statistics, and a draw's score, do not depend on
  its batch);
- features: 1e-5 max abs in hybrid (f32 wire words summed in another
  order), 1e-9 in exact; sweep drops at most 1/N_test per entry (an f32
  argmax near-tie); rankings and splits identical.
tpumcia's keywords (``chunk_size``, ``onehot_dtype``, ``with_intensity``,
``with_glcm``, ``axis``) are held against the port's unsharded stats-level
call bit for bit, and the placements (``data_sharding``, ``replicated``,
``place_global``, ``local_to_global``, ``fetch_to_host``) on a 3-slot mesh.
JAX's draws (head init, sweep permutations) are replayed into the port;
tpumcia's sharded sweep splits its keys over the groups padded to the data
axis, so the replay takes its first G*R draws of that split.
"""

import numpy as np
import pytest
import torch

from torch_parity import jax_permutations, replay_jax_draws, to_chw_tensor
from tpumcia.config import FeatureConfig as JFeatureConfig
from tpumcia.config import GLCMConfig as JGLCMConfig
from tpumcia.config import HeadConfig as JHeadConfig
from tpumcia.config import MeshConfig as JMeshConfig
from tpumcia.parallel import mesh as jmesh
from tpumcia.parallel import sharding as jsharding
from tpumcia_torch import config as tcfg
from tpumcia_torch.features import cuda_glcm, registry
from tpumcia_torch.features.extract import FeatureMatrix, extract_features
from tpumcia_torch.features.stats import prepare_mask
from tpumcia_torch.importance import permutation as perm
from tpumcia_torch.importance.channels import channel_importance
from tpumcia_torch.models.heads import LogisticHead, fit_head
from tpumcia_torch.models.scaler import MinMaxScaler
from tpumcia_torch.parallel import mesh as tmesh
from tpumcia_torch.parallel import sharding as tsharding

POOL = ["cpu"] * 8
INT_FIELDS = ("hist", "count", "vmax", "marg_l", "marg_r", "diff_hist", "glcm_sumsq", "pair_count")


def _batch(n=8, hw=24, channels=3, seed=0):
    rng = np.random.default_rng(seed)
    imgs = (rng.random((n, hw, hw, channels)) * 256).astype(np.uint8)
    mask = rng.random((n, hw, hw)) > 0.3
    return imgs, mask


def _assert_stats_equal(got, want, fields=INT_FIELDS):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if g is None or w is None:
            continue
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f)


def _unsharded(imgs, mask, **kw):
    m = None if mask is None else prepare_mask(mask, imgs.shape, "cpu")
    return cuda_glcm.sufficient_stats(to_chw_tensor(imgs), m, levels=256, **kw)


@pytest.mark.parametrize("entry", ["make_mesh", "mesh_from_config"])
@pytest.mark.parametrize("data,model", [(-1, 1), (4, 2), (2, 1), (16, 1), (0, 1), (2, 0), (-1, 3), (1, 1)])
def test_mesh_construction_matches_jax(entry, data, model):
    """The same shape, or the same error, as tpumcia's mesh over 8 devices."""
    def build(mod, **kw):
        if entry == "make_mesh":
            return mod.make_mesh(data=data, model=model, **kw)
        cfg = (JMeshConfig if mod is jmesh else tcfg.MeshConfig)(data=data, model=model)
        return mod.mesh_from_config(cfg, **kw)

    try:
        want = build(jmesh)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            build(tmesh, devices=POOL)
        assert str(got.value) == str(e)
        return
    got = build(tmesh, devices=POOL)
    if want is None:
        assert got is None
        return
    assert got.shape == dict(want.shape)
    assert len(got.slots) == got.shape["data"] and got.group is None
    assert got.local_slots() == list(range(got.shape["data"]))


def test_row_ranges_split_as_tpumcia_pads():
    """ceil(n/d) rows a slot, the last slots short: tpumcia's padded split
    with the pad rows left out."""
    mesh = tmesh.make_mesh(devices=POOL)
    assert tmesh.row_ranges(5, mesh) == [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)] + [(5, 5)] * 3
    assert tmesh.row_ranges(37, mesh)[-1] == (35, 37)
    assert tmesh.row_ranges(0, mesh) == [(0, 0)] * 8


@pytest.mark.parametrize("masked", [False, True])
def test_sharded_stats_match_jax(masked):
    imgs, mask = _batch()
    mask = mask if masked else None
    want = jsharding.sufficient_stats_sharded(imgs, mask, mesh=jmesh.make_mesh())
    got = tsharding.sufficient_stats_sharded(imgs, mask, mesh=tmesh.make_mesh(devices=POOL))
    _assert_stats_equal(got, want)
    assert got.diff_hist is not None and got.dstats is None


def test_sharded_stats_nondivisible_batch():
    """5 objects over 8 slots (tpumcia pads; the port leaves 3 slots empty)."""
    imgs, mask = _batch(n=5)
    want = jsharding.sufficient_stats_sharded(imgs, mask, mesh=jmesh.make_mesh())
    got = tsharding.sufficient_stats_sharded(imgs, mask, mesh=tmesh.make_mesh(devices=POOL))
    assert got.hist.shape[0] == 5
    _assert_stats_equal(got, want)
    _assert_stats_equal(got, _unsharded(imgs, mask, offset=(0, 5), need_diff=True), got._fields)


@pytest.mark.parametrize("slots", [1, 3, 8])
@pytest.mark.parametrize("masked,need_diff", [(False, False), (True, False), (True, True)])
def test_sharded_stats_equal_unsharded(slots, masked, need_diff):
    imgs, mask = _batch(n=11)
    mask = mask if masked else None
    got = tsharding.sufficient_stats_sharded(
        imgs, mask, mesh=tmesh.make_mesh(data=slots, devices=POOL), need_diff_hist=need_diff)
    _assert_stats_equal(got, _unsharded(imgs, mask, offset=(0, 5), need_diff=need_diff), got._fields)


def test_sharded_multi_offset_matches_jax():
    imgs, mask = _batch(n=6)
    offsets = ((0, 5), (2, 2), (3, 0))
    want = jsharding.sufficient_stats_sharded_multi(imgs, mask, mesh=jmesh.make_mesh(), offsets=offsets)
    got = tsharding.sufficient_stats_sharded_multi(
        imgs, mask, mesh=tmesh.make_mesh(devices=POOL), offsets=offsets)
    assert len(got) == len(want) == 3
    for o, (g, w) in enumerate(zip(got, want)):
        # tpumcia carries the intensity fields on the first offset only
        _assert_stats_equal(g, w, INT_FIELDS if o == 0 else INT_FIELDS[3:])
    m = prepare_mask(mask, imgs.shape, "cpu")
    for g, w in zip(got, cuda_glcm.sufficient_stats_multi(
            to_chw_tensor(imgs), m, levels=256, offsets=offsets, need_diff=True)):
        _assert_stats_equal(g, w, g._fields)


@pytest.mark.parametrize("precision,atol", [("exact", 1e-9), ("hybrid", 1e-5)])
@pytest.mark.parametrize("distance", [5, (5, 2)])
def test_extract_features_with_mesh_matches_jax(precision, atol, distance):
    from tpumcia.features.extract import extract_features as jax_extract

    imgs, mask = _batch(n=6)
    jcfg = JFeatureConfig(precision=precision, glcm=JGLCMConfig(distance=distance))
    cfg = tcfg.FeatureConfig(precision=precision, glcm=tcfg.GLCMConfig(distance=distance))
    want = jax_extract(imgs, mask, config=jcfg, mesh=jmesh.make_mesh())
    mesh = tmesh.make_mesh(devices=POOL)
    got = extract_features(imgs, mask, device="cpu", config=cfg, mesh=mesh)
    assert got.names == want.names
    a, b = got.to_numpy(), np.asarray(want.values)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    np.testing.assert_array_equal(got.degenerate, np.asarray(want.degenerate))
    # and the port's own unsharded extraction
    one = extract_features(imgs, mask, device="cpu", config=cfg)
    np.testing.assert_allclose(a, one.to_numpy(), rtol=0, atol=atol)


def test_extract_features_sharded_matches_jax():
    imgs, _ = _batch(n=5)
    want = jsharding.extract_features_sharded(imgs, mesh=jmesh.make_mesh())
    got = tsharding.extract_features_sharded(imgs, mesh=tmesh.make_mesh(devices=POOL))
    assert got.names == want.names
    np.testing.assert_allclose(got.to_numpy(), np.asarray(want.values), rtol=0, atol=1e-9)


def test_sharded_scaler_matches_jax():
    X = np.random.default_rng(1234).normal(0, 5, size=(37, 12)).astype(np.float32)
    want = jsharding.fit_scaler_sharded(X, mesh=jmesh.make_mesh())
    got = tsharding.fit_scaler_sharded(X, mesh=tmesh.make_mesh(devices=POOL))
    np.testing.assert_array_equal(got.data_min.numpy(), np.asarray(want.data_min))
    np.testing.assert_array_equal(got.data_max.numpy(), np.asarray(want.data_max))
    local = MinMaxScaler.fit(torch.from_numpy(X))
    assert torch.equal(got.data_min, local.data_min) and torch.equal(got.data_max, local.data_max)


def _sweep_problem(n=200, f=10, seed=1234):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    X = rng.normal(0, 1, size=(n, f)).astype(np.float32)
    X[:, 0] += y * 2.0
    X[:, 5] -= y * 1.5
    return X, y


@pytest.mark.parametrize("slots", [1, 3, 8])
@pytest.mark.parametrize("kind,groups", [
    ("logistic", None), ("random_forest", None), ("logistic", [[0, 1], [2, 3], [4, 5, 6, 7, 8, 9]]),
])
def test_sharded_sweep_equals_unsharded(slots, kind, groups):
    """Bit for bit, whatever the slot count: the same permutations from the
    same seed, each draw scored on its own."""
    X, y = _sweep_problem()
    head = fit_head(X, y, device="cpu", config=tcfg.HeadConfig(kind=kind, num_steps=100, n_estimators=8))
    want = perm.permutation_importance(head, X, y, n_repeats=4, seed=42, groups=groups)
    got = tsharding.permutation_importance_sharded(
        head, X, y, mesh=tmesh.make_mesh(data=slots, devices=POOL), n_repeats=4, seed=42, groups=groups)
    np.testing.assert_array_equal(got.importances, want.importances)
    assert got.baseline_score == want.baseline_score


def _replay_sharded_draws(monkeypatch, n_repeats, data):
    """tpumcia's sharded sweep draws from ``split(key(seed), Gp * R)`` with
    the G groups padded to a multiple of the data axis: hand the port the
    first G*R of those draws."""
    def perms(num_draws, n, *, seed, device):
        G = num_draws // n_repeats
        Gp = -(-G // data) * data
        return torch.from_numpy(jax_permutations(seed, Gp * n_repeats, n)[:num_draws]).long().to(device)

    monkeypatch.setattr(perm, "draw_permutations", perms)


@pytest.mark.parametrize("groups", [None, [[0, 1], [2, 3], [4, 5, 6, 7, 8, 9]]])
def test_sharded_sweep_matches_jax(groups, monkeypatch):
    """tpumcia's sharded sweep and the port's on one carried head, with
    tpumcia's draws replayed (``test_sharded_permutation_matches_single_device``
    and ``test_sharded_grouped_permutation``)."""
    from tpumcia.models.heads import fit_head as jax_fit_head

    X, y = _sweep_problem()
    jh = jax_fit_head(X, y, config=JHeadConfig(kind="logistic", num_steps=300))
    th = LogisticHead.from_numpy(jh.params, jh.classes, jh.scaler.data_min, jh.scaler.data_max, device="cpu")
    want = jsharding.permutation_importance_sharded(
        jh, X, y, mesh=jmesh.make_mesh(), n_repeats=4, seed=42, groups=groups)
    _replay_sharded_draws(monkeypatch, 4, 8)
    got = tsharding.permutation_importance_sharded(
        th, X, y, mesh=tmesh.make_mesh(devices=POOL), n_repeats=4, seed=42, groups=groups)
    assert got.importances.shape == want.importances.shape
    assert abs(got.baseline_score - want.baseline_score) <= 1 / len(X) + 1e-9
    np.testing.assert_allclose(got.importances, want.importances, rtol=0, atol=1 / len(X) + 1e-6)
    if groups is None:
        assert set(got.ranking()[:2]) == set(want.ranking()[:2]) == {0, 5}
    else:
        assert got.importances.shape == (3, 4)
        assert got.ranking()[0] == want.ranking()[0] == 0


@pytest.mark.parametrize("method", ["permutation", "permutation_features"])
def test_channel_importance_with_mesh(method, monkeypatch):
    """``channel_importance(mesh=)`` takes the sharded sweep: the unsharded
    result bit for bit, and tpumcia's ``channel_importance(mesh=)`` with its
    draws replayed."""
    from tpumcia.config import ImportanceConfig as JImportanceConfig
    from tpumcia.features.extract import FeatureMatrix as JFeatureMatrix
    from tpumcia.importance.channels import channel_importance as jax_channel_importance
    from tpumcia.models.heads import fit_head as jax_fit_head

    rng = np.random.default_rng(0)
    y = np.where(rng.random(120) < 0.5, 3, 7)
    X = rng.normal(size=(120, 69)).astype(np.float32)
    X[:, 0] += 2.5 * (y == 7)
    names = registry.feature_names(3)
    jh = jax_fit_head(X, y, config=JHeadConfig(kind="logistic", num_steps=60))
    th = LogisticHead.from_numpy(jh.params, jh.classes, jh.scaler.data_min, jh.scaler.data_max, device="cpu")
    fm = FeatureMatrix(values=X, names=names, num_channels=3)
    cfg = tcfg.ImportanceConfig(n_repeats=3)
    mesh = tmesh.make_mesh(devices=POOL)
    got = channel_importance(th, fm, y, method=method, config=cfg, mesh=mesh)
    one = channel_importance(th, fm, y, method=method, config=cfg)
    np.testing.assert_array_equal(got.feature_importances, one.feature_importances)
    want = jax_channel_importance(
        jh, JFeatureMatrix(values=X, names=names, num_channels=3), y, method=method,
        config=JImportanceConfig(n_repeats=3), mesh=jmesh.make_mesh())
    _replay_sharded_draws(monkeypatch, 3, 8)
    got = channel_importance(th, fm, y, method=method, config=cfg, mesh=mesh)
    assert got.method == want.method
    assert got.ranking.tolist() == want.ranking.tolist()
    assert got.ranking[0] == 0
    atol = 1 / 120 + 1e-6 if method == "permutation" else 23 / 120
    np.testing.assert_allclose(got.total, want.total, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def images():
    from tpumcia_torch.io.synthetic import synthetic_mednist

    gray, labels, _ = synthetic_mednist(10, num_classes=6, hw=32, seed=3)
    noise = np.random.default_rng(3).normal(0, 0.1, size=(*gray.shape, 2))
    x = np.concatenate([gray[..., None], (np.clip(noise, 0, 1) * 255).astype(np.uint8)], axis=-1)
    return x, labels


def _pipeline_kw(**change):
    return {"head": {"kind": "logistic", "num_steps": 60},
            "split": {"test_size": 0.25, "seed": 0, "stratify": True},
            "mesh": {"data": 2}, "fast_path": "auto", **change}


def test_run_pipeline_with_mesh_matches_jax(images, monkeypatch):
    """``MeshConfig(data=2)`` in both packages: tpumcia on 2 of its 8 CPU
    devices, the port over ``device=["cpu", "cpu"]``. The same split and
    rankings, features at the hybrid tolerance, accuracy within 2/N_test."""
    from tpumcia.config import PipelineConfig as JPipelineConfig
    from tpumcia.pipeline.run import run_pipeline as jax_run_pipeline
    from tpumcia_torch.pipeline.run import run_pipeline

    x, labels = images
    want = jax_run_pipeline(x, labels, config=JPipelineConfig.from_dict(_pipeline_kw()))
    replay_jax_draws(monkeypatch)
    _replay_sharded_draws(monkeypatch, 10, 2)
    cuda_glcm.reset_launch_counts()
    got = run_pipeline(x, labels, config=_pipeline_kw(), device=["cpu", "cpu"])
    a, b = got.features.to_numpy(), np.asarray(want.features.values)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.test_idx, want.test_idx)
    assert abs(got.test_accuracy - want.test_accuracy) <= 2.0 / len(got.test_idx) + 1e-9
    assert got.channel_result.ranking.tolist() == want.channel_result.ranking.tolist()
    assert got.feature_result.ranking[0] == want.feature_result.ranking[0]
    assert got.channel_result.ranking[0] == 0
    assert cuda_glcm.LAUNCHES == 0  # the plain version on the CPU
    # the port's run on one device: the same features and split
    one = run_pipeline(x, labels, config=_pipeline_kw(mesh={"data": 1}), device="cpu")
    np.testing.assert_array_equal(got.features.to_numpy(), one.features.to_numpy())
    np.testing.assert_array_equal(got.test_idx, one.test_idx)


def test_run_pipeline_fast_path_always_refuses_a_mesh(images):
    """tpumcia's ValueError (its shape prints as an OrderedDict)."""
    from tpumcia.config import PipelineConfig as JPipelineConfig
    from tpumcia.pipeline.run import run_pipeline as jax_run_pipeline
    from tpumcia_torch.pipeline.run import run_pipeline

    x, labels = images
    msg = r"fast_path='always' is single-device but the mesh config resolved .*'data': 2, 'model': 1"
    with pytest.raises(ValueError, match=msg):
        jax_run_pipeline(x, labels, config=JPipelineConfig.from_dict(_pipeline_kw(fast_path="always")))
    with pytest.raises(ValueError, match=msg):
        run_pipeline(x, labels, config=_pipeline_kw(fast_path="always"), device=["cpu", "cpu"])


def test_default_config_on_one_device_has_no_mesh(images):
    """``data=-1`` on one device resolves to no mesh: the run is today's,
    value for value."""
    from tpumcia_torch.pipeline.run import run_pipeline

    assert tmesh.mesh_from_config(tcfg.MeshConfig(), "cpu") is None
    assert tmesh.mesh_from_config(tcfg.MeshConfig(data=2), ["cpu", "cpu"]).shape == {"data": 2, "model": 1}
    x, labels = images
    kw = _pipeline_kw(fast_path="always", batch_size=32)
    kw.pop("mesh")
    a = run_pipeline(x, labels, config=kw, device="cpu")
    b = run_pipeline(x, labels, config={**kw, "mesh": {"data": -1}}, device=["cpu"])
    np.testing.assert_array_equal(a.features.values, b.features.values)
    assert a.features.device_values is not None  # the fused path ran both times
    np.testing.assert_array_equal(a.channel_result.total, b.channel_result.total)


def test_stream_extract_with_mesh_crosses_with_jax(tmp_path):
    """tpumcia's ``test_stream_extract_with_mesh``: the same shard files in
    both packages, each directory loaded by the other package."""
    from tpumcia.features.extract import extract_features as jax_extract
    from tpumcia.pipeline import streaming as jstream
    from tpumcia_torch.pipeline import streaming as tstream

    images = (np.random.default_rng(1234).random((10, 32, 32, 2)) * 256).astype(np.uint8)

    def fetch(idx):
        return images[idx], None, None

    exact = dict(precision="exact", use_pallas="never")
    jres = jstream.stream_extract(fetch, len(images), tmp_path / "jax", shard_size=4,
                                  config=JFeatureConfig(**exact), mesh=jmesh.make_mesh())
    tres = tstream.stream_extract(fetch, len(images), tmp_path / "torch", device="cpu", shard_size=4,
                                  config=tcfg.FeatureConfig(precision="exact"),
                                  mesh=tmesh.make_mesh(devices=POOL))
    ref = jax_extract(images, config=JFeatureConfig(**exact))
    np.testing.assert_array_equal(tres.features.values, np.asarray(ref.values))
    np.testing.assert_array_equal(tres.features.values, np.asarray(jres.features.values))
    for sid in ("shard_000000000", "shard_000000004", "shard_000000008"):
        with np.load(tmp_path / "jax" / f"{sid}.npz") as j, np.load(tmp_path / "torch" / f"{sid}.npz") as t:
            np.testing.assert_array_equal(t["values"], j["values"])
            np.testing.assert_array_equal(t["indices"], j["indices"])
    tload, _ = tstream.load_feature_shards(tmp_path / "jax")
    jload, _ = jstream.load_feature_shards(tmp_path / "torch")
    np.testing.assert_array_equal(tload.values, np.asarray(jload.values))


def test_mesh_rejects_other_objects():
    with pytest.raises(TypeError, match="Mesh"):
        tmesh.check_mesh(object())
    assert tmesh.device_pool(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert tmesh.device_pool("cpu") == [torch.device("cpu")]


# --- tpumcia's keywords and placements --------------------------------------


@pytest.mark.parametrize("slots", [1, 3, 8])
@pytest.mark.parametrize("with_intensity,with_glcm", [(True, True), (False, True), (True, False)])
def test_sharded_stats_take_tpumcias_keywords(slots, with_intensity, with_glcm):
    """``chunk_size`` and ``onehot_dtype`` change nothing; ``with_*=False``
    zero the same fields as the unsharded stats-level call, bit for bit,
    and as tpumcia's sharded call on its 8 devices."""
    from tpumcia_torch.features import stats as tstats

    imgs, mask = _batch(n=11)
    kw = dict(chunk_size=4, onehot_dtype="float32", with_intensity=with_intensity, with_glcm=with_glcm)
    got = tsharding.sufficient_stats_sharded(imgs, mask, mesh=tmesh.make_mesh(data=slots, devices=POOL), **kw)
    _assert_stats_equal(got, tstats.sufficient_stats(imgs, mask, device="cpu", **kw), got._fields)
    if slots == 8:
        _assert_stats_equal(got, jsharding.sufficient_stats_sharded(imgs, mask, mesh=jmesh.make_mesh(), **kw))
    multi = tsharding.sufficient_stats_sharded_multi(
        imgs, mask, mesh=tmesh.make_mesh(data=slots, devices=POOL), offsets=((0, 5), (2, 2)),
        chunk_size=4, onehot_dtype="float32", with_intensity=with_intensity)
    one = tstats.sufficient_stats_multi(imgs, mask, device="cpu", offsets=((0, 5), (2, 2)),
                                        with_intensity=with_intensity)
    for o, (g, w) in enumerate(zip(multi, one)):
        # the sharded call shares the first offset's histogram, as tpumcia's kernel path does
        _assert_stats_equal(g, w, g._fields if o == 0 else g._fields[1:])
        assert torch.equal(g.hist, multi[0].hist)


@pytest.mark.parametrize("slots", [1, 3, 8])
def test_extract_features_sharded_takes_chunk_size(slots):
    imgs, mask = _batch(n=7)
    mesh = tmesh.make_mesh(data=slots, devices=POOL)
    got = tsharding.extract_features_sharded(imgs, mask, mesh=mesh, chunk_size=2)
    want = tsharding.extract_features_sharded(imgs, mask, mesh=mesh)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


def test_shard_across_processes_takes_the_data_axis():
    from tpumcia.parallel import distributed as jdist
    from tpumcia_torch.parallel import distributed as tdist

    x = np.arange(16).reshape(8, 2)
    mesh = tmesh.make_mesh(data=4, model=2, devices=POOL)
    rows = tdist.shard_across_processes(x, mesh, axis="data")
    assert (rows.offset, rows.total) == (0, 8) and rows.rows is x
    with pytest.raises(ValueError) as want:
        jdist.shard_across_processes(x, jmesh.make_mesh(data=4, model=2), axis="foo")
    with pytest.raises(ValueError) as got:
        tdist.shard_across_processes(x, mesh, axis="foo")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="'data' axis only"):
        tdist.shard_across_processes(x, mesh, axis="model")


def test_placements_on_a_three_slot_mesh():
    """``data_sharding`` / ``replicated`` and tpumcia's ``place_global``
    (a spec, or a Mesh as today's calls pass it) and ``local_to_global``;
    the sharded statistics of a placed batch equal the whole batch's."""
    from tpumcia_torch import parallel
    from tpumcia_torch.features.finalize import fetch_to_host
    from tpumcia_torch.parallel.distributed import ShardedRows

    mesh = tmesh.make_mesh(data=3, devices=["cpu"] * 3)
    rows_spec, whole_spec = parallel.data_sharding(mesh), parallel.replicated(mesh)
    assert (rows_spec.mesh, rows_spec.spec, whole_spec.spec) == (mesh, ("data",), ())
    imgs, mask = _batch(n=10)
    placed = tsharding.local_to_global(imgs, rows_spec)
    assert isinstance(placed, ShardedRows) and (placed.offset, placed.total) == (0, 10)
    np.testing.assert_array_equal(placed.rows, imgs)  # one process holds every slot's rows
    assert tsharding.local_to_global(imgs, whole_spec) is imgs
    assert tsharding.place_global(imgs, mesh) is imgs and tsharding.place_global(imgs, whole_spec) is imgs
    assert tsharding.place_global(placed, rows_spec) is placed
    whole = tsharding.place_global(placed, whole_spec)
    assert isinstance(whole, torch.Tensor) and np.array_equal(whole.numpy(), imgs)
    assert isinstance(tsharding.place_global(imgs, rows_spec), ShardedRows)
    with pytest.raises(TypeError, match="data_sharding"):
        tsharding.place_global(imgs, "data")
    got = tsharding.sufficient_stats_sharded(placed, mask, mesh=mesh)
    _assert_stats_equal(got, tsharding.sufficient_stats_sharded(imgs, mask, mesh=mesh), got._fields)
    # fetch_to_host: a tensor, a host array, a ShardedRows that holds the whole batch
    np.testing.assert_array_equal(fetch_to_host(got.hist), got.hist.numpy())
    assert fetch_to_host(imgs) is imgs
    np.testing.assert_array_equal(fetch_to_host(placed), imgs)
    with pytest.raises(ValueError, match="gathered 4 rows of a batch of 10"):
        fetch_to_host(ShardedRows(imgs[:4], 0, 10))  # no process group to gather from
