"""The port's repaired faults against tpumcia, on the CPU (their GPU halves
are in ``test_torch_cuda.py``):

- more than 16 GLCM offsets (the CUDA wrapper's launches of at most
  ``MAX_OFFSETS`` offsets, joined);
- ``use_pallas='never'`` (what a CPU device computes and a CUDA device
  refuses) and level counts past 4096, which kernel form B1e takes on a CUDA
  device: the plain version there (``sum(G^2)`` from the occupied cells, the
  rescale rows without the L x L table) against tpumcia up to 16384 levels;
- ``in_flight`` and per-batch uploads in the batched extraction;
- ``MinMaxScaler.inverse_transform`` / ``to_numpy``;
- the citation of the reference's permutation importance;
- tpumcia's stats-level ``sufficient_stats(_multi)`` (C6), made unchanged
  on both packages against tpumcia's XLA path, and ``glcm_sumsq_value`` in
  tpumcia's positional order.

Tolerances: integer statistics bit-equal (every field of the stats-level
call is an integer count), features 1e-5 max abs (hybrid) as
in ``test_torch_multi_offset.py``; the 8192-level features rel 1e-6 (their
values reach 1e7); scaler values rel 1e-6 against tpumcia's, the f32 round
trip itself rel 1e-5.
"""

import inspect

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (limits torch to one thread)
import tpumcia_torch as tt
from tpumcia.config import FeatureConfig as JFeatureConfig
from tpumcia.config import GLCMConfig as JGLCMConfig
from tpumcia.features.extract import extract_features as jax_extract
from tpumcia_torch.features import cuda_glcm
from tpumcia_torch.features.extract import check_use_pallas

ANGLES = (0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4)
DISTANCES = (1, 2, 3, 4, 5)


def _images(n=6, hw=24, c=2, levels=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, levels, size=(n, hw, hw, c)).astype(np.uint8 if levels <= 256 else np.int32)
    m = rng.random((n, hw, hw, c)) < 0.8
    return x, m


# --- more than 16 offsets ---------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_twenty_offsets_match_jax(masked):
    """5 distances x 4 angles through ``extract_features``: tpumcia's names,
    flags and values, and the multi-offset wire taking 20 blocks."""
    x, m = _images()
    glcm = dict(distance=DISTANCES, angle=ANGLES)
    cfg = tt.FeatureConfig(glcm=tt.GLCMConfig(**glcm))
    assert len(cfg.glcm.offsets) == 20 > cuda_glcm.MAX_OFFSETS
    mask = m if masked else None
    got = tt.extract_features(x, mask, device="cpu", config=cfg)
    want = jax_extract(x, mask=mask, config=JFeatureConfig(use_pallas="never", glcm=JGLCMConfig(**glcm)))
    assert got.names == want.names and got.shape == (6, 2 * (17 + 20 * 6))
    a, b = got.values, np.asarray(want.values)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.degenerate, want.degenerate)
    assert got.channel_columns() == want.channel_columns()


@pytest.mark.parametrize("num_offsets", [1, 16, 17, 20, 33])
def test_offset_lists_run_in_launches_of_at_most_sixteen(monkeypatch, num_offsets):
    """The CUDA route of ``sufficient_stats_multi`` with the launch replaced
    by the plain version: launches of at most MAX_OFFSETS offsets, outputs in
    order, the shared fields the first launch's own tensors."""
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.integers(0, 256, size=(2, 2, 40, 40), dtype=np.int32))
    offsets = [(dr, dc) for dr in range(-3, 4) for dc in range(0, 5)][1:num_offsets + 1]
    launched = []

    def fake_launch(img, mask, levels, offs, need_diff):
        assert 1 <= len(offs) <= cuda_glcm.MAX_OFFSETS
        launched.append(list(offs))
        return cuda_glcm.sufficient_stats_multi_reference(
            img, mask, levels=levels, offsets=offs, need_diff=need_diff)

    monkeypatch.setattr(cuda_glcm, "_launch", fake_launch)
    got = cuda_glcm._launch_chunked(img, None, 256, offsets, False)
    want = cuda_glcm.sufficient_stats_multi_reference(img, levels=256, offsets=offsets)
    assert [o for part in launched for o in part] == offsets
    assert len(launched) == -(-num_offsets // cuda_glcm.MAX_OFFSETS)
    assert len(got) == len(want) == num_offsets
    for g, w in zip(got, want):
        for name in g._fields:
            if getattr(w, name) is not None:
                assert torch.equal(getattr(g, name), getattr(w, name)), name
        assert g.hist is got[0].hist and g.count is got[0].count and g.vmax is got[0].vmax


# --- 'never' and the kernel's bounds ------------------------------------------


@pytest.mark.parametrize("precision", ["hybrid", "exact", "device"])
def test_use_pallas_never_matches_jax(precision):
    x, m = _images(seed=2)
    got = tt.extract_features(x, m, device="cpu", config=tt.FeatureConfig(use_pallas="never", precision=precision))
    want = jax_extract(x, mask=m, config=JFeatureConfig(use_pallas="never", precision=precision))
    a, b = got.to_numpy().astype(np.float64), np.asarray(want.values, np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    atol = {"hybrid": 1e-5, "exact": 1e-9, "device": 1e-3}[precision]
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=1e-5 if precision == "device" else 0, atol=atol)
    auto = tt.extract_features(x, m, device="cpu", config=tt.FeatureConfig(precision=precision))
    np.testing.assert_array_equal(got.to_numpy(), auto.to_numpy())  # one plain version on the CPU


def test_use_pallas_never_and_the_bounds_on_either_device():
    """``'never'`` is refused on a CUDA device and taken on the CPU; the
    counts hold the six kernel forms and nothing else; the kernel's bounds
    are tpumcia's 32768 levels and 2^24 pixels; a tensor on neither a CPU
    nor a CUDA device raises rather than take the plain version."""
    import dataclasses

    cfg = dataclasses.replace(tt.FeatureConfig(), use_pallas="never")
    with pytest.raises(ValueError, match="CUDA kernel"):
        check_use_pallas(cfg, torch.device("cuda"))
    check_use_pallas(cfg, torch.device("cpu"))
    for value in ("auto", "always"):
        check_use_pallas(dataclasses.replace(cfg, use_pallas=value), torch.device("cuda"))
    assert set(cuda_glcm.LAUNCHES_BY_FORM) == {"B1a", "B1b", "B1c", "B2", "B1d", "B1e"}
    cuda_glcm.LAUNCHES_BY_FORM["B2"] = 3
    cuda_glcm.reset_launch_counts()
    assert set(cuda_glcm.LAUNCHES_BY_FORM.values()) == {0} and cuda_glcm.LAUNCHES == 0
    assert cuda_glcm.past_kernel_bounds(64 * 64, 32769) and cuda_glcm.past_kernel_bounds(1 << 24, 256)
    assert not cuda_glcm.past_kernel_bounds(256 * 256, 4096)
    assert not cuda_glcm.past_kernel_bounds(64 * 64, 8192) and not cuda_glcm.past_kernel_bounds(64 * 64, 32768)
    form = dict(hw=64 * 64, masked=True, need_diff=True, num_offsets=4)
    assert cuda_glcm.kernel_form(levels=4096, **form) == "B1d"
    assert cuda_glcm.kernel_form(levels=4097, **form) == cuda_glcm.kernel_form(levels=32768, **form) == "B1e"
    with pytest.raises(ValueError, match="need_diff=False"):
        cuda_glcm.sufficient_stats(torch.zeros((1, 1, 8, 8), dtype=torch.int32), levels=8192, offset=(0, 1))
    meta = torch.empty((1, 1, 8, 8), dtype=torch.int32, device="meta")
    for levels in (256, 8192):
        with pytest.raises(ValueError, match="CPU or CUDA tensor"):
            cuda_glcm.sufficient_stats(meta, levels=levels, offset=(0, 1), need_diff=True)
    assert "plain" not in inspect.signature(cuda_glcm.sufficient_stats_multi).parameters


def _no_rescale_table(monkeypatch):
    """Fail if the port builds an L x L rescale table from here on."""
    from tpumcia_torch.features import stats as tstats

    def refuse(levels=256):
        raise AssertionError(f"the port built a {levels} x {levels} rescale table")

    monkeypatch.setattr(tstats, "rescale_lut", refuse)
    tstats.rescale_lut_device.cache_clear()


def test_8192_levels_match_jax(monkeypatch):
    """Past 4096 levels (kernel form B1e on a CUDA device): the plain
    version computes its rescale rows without the 8192 x 8192 table, and the
    packed f32 wire holds to 32768 levels in both packages. 2 x 16 x 16 x 1
    keeps tpumcia's dense G small."""
    from tpumcia.features import stats as jstats

    _no_rescale_table(monkeypatch)
    x = np.random.default_rng(0).integers(0, 8192, size=(2, 16, 16, 1)).astype(np.int32)
    x[0, :4, :4, 0] = 8191
    try:
        for precision, rtol in (("hybrid", 1e-6), ("exact", 1e-9)):
            got = tt.extract_features(
                x, device="cpu",
                config=tt.FeatureConfig(precision=precision, glcm=tt.GLCMConfig(levels=8192)))
            want = jax_extract(x, config=JFeatureConfig(
                use_pallas="never", precision=precision, chunk_size=1, glcm=JGLCMConfig(levels=8192)))
            a, b = got.values, np.asarray(want.values)
            assert a.shape == (2, 23) and np.isfinite(a).all()
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-9)
    finally:  # tpumcia's 256 MB table
        jstats.rescale_lut.cache_clear()


def test_16384_levels_match_jax(monkeypatch):
    """16384 levels, masked, the largest level count held against tpumcia
    here: its CPU run builds a 1 GB rescale table (2 GB of float64 on the
    way) and a dense G of 2^28 cells per channel, ~14 s; at 32768 levels
    both are four times that. The port's side takes 0.1 s. Above this the
    port is held to its own kernel (bit-equal to this plain version on a
    CUDA device) and to ``rescale_rows`` == ``rescale_lut`` rows."""
    from tpumcia.features import stats as jstats

    _no_rescale_table(monkeypatch)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 16384, size=(2, 16, 16, 1)).astype(np.int32)
    x[1, :3, :3, 0] = 16383
    m = rng.random((2, 16, 16)) < 0.85
    try:
        got = tt.extract_features(
            x, m, device="cpu", config=tt.FeatureConfig(glcm=tt.GLCMConfig(levels=16384)))
        want = jax_extract(x, mask=m, config=JFeatureConfig(
            use_pallas="never", chunk_size=1, glcm=JGLCMConfig(levels=16384)))
        a, b = got.values, np.asarray(want.values)
        assert a.shape == (2, 23) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    finally:
        jstats.rescale_lut.cache_clear()


@pytest.mark.parametrize("levels", [256, 1024, 8192])
def test_rescale_rows_equal_the_table_rows(levels):
    """``rescale_rows`` (what the plain version uses above 4096 levels, and
    what kernel form B1e computes per block) against every row of
    ``rescale_lut``, entry by entry, with vmax past both ends clamped."""
    from tpumcia_torch.features import stats as tstats

    try:
        lut = torch.from_numpy(tstats.rescale_lut(levels))
        vmax = torch.arange(-2, levels + 2)
        rows = tstats.rescale_rows(levels, vmax)
        assert rows.dtype == torch.int32 and tuple(rows.shape) == (levels + 4, levels)
        assert torch.equal(rows, lut[vmax.clamp(0, levels - 1)])
        assert not bool(rows[:3].any())  # vmax <= 0: the all-zero row
        few = torch.tensor([[0, 5], [levels - 1, levels // 2]])
        assert torch.equal(tstats.rescale_rows_for(levels, few), lut[few])
        assert tstats.rescale_rows_for(levels, few).dtype == torch.int32
    finally:
        tstats.rescale_lut.cache_clear()
        tstats.rescale_lut_device.cache_clear()


@pytest.mark.parametrize("shape,levels,masked", [
    ((3, 2, 20, 20), 256, False),   # the cheap limbs
    ((3, 2, 20, 20), 256, True),
    ((2, 1, 72, 72), 256, False),   # the generic limbs
    ((2, 2, 24, 24), 1024, True),
    ((2, 1, 72, 72), 4, False),     # counts past 4096 in one cell
])
def test_sumsq_limbs_from_occupied_cells_equal_dense(shape, levels, masked):
    """``sum(G^2)`` counted over the occupied cells alone (what the plain
    version does at every size) is the limbs of a dense G bit for bit."""
    from tpumcia_torch.features.stats import cheap_limbs, glcm_sumsq_limbs

    rng = np.random.default_rng(3)
    n, hw = shape[0] * shape[1], shape[2] * shape[3]
    left = torch.from_numpy(rng.integers(0, levels, size=(n, hw)))
    right = torch.from_numpy(rng.integers(0, levels, size=(n, hw)))
    keep = torch.from_numpy(rng.random((n, hw)) < 0.7) if masked else None
    if masked:
        keep[0] = False  # a row with no pair
    for cheap in {cheap_limbs(hw, levels), False}:
        dense = glcm_sumsq_limbs(cuda_glcm._row_bincount(left * levels + right, levels * levels, keep), cheap)
        sparse = cuda_glcm._sumsq_limbs_occupied(left, right, keep, levels, cheap)
        assert sparse.dtype == torch.int32 and torch.equal(sparse, dense)


def test_plain_version_sumsq_equals_dense_g():
    """The whole plain version's ``glcm_sumsq`` against an explicit G per
    (image, channel) built here, masked, two offsets, 512 levels."""
    from tpumcia_torch.features.stats import cheap_limbs, glcm_matrix, glcm_sumsq_limbs

    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.integers(0, 512, size=(2, 2, 30, 30), dtype=np.int32))
    mask = torch.from_numpy((rng.random((2, 1, 30, 30)) < 0.8).astype(np.uint8))
    offsets = [(0, 5), (3, -2)]
    got = cuda_glcm.sufficient_stats_multi_reference(img, mask, levels=512, offsets=offsets, need_diff=True)
    for st, off in zip(got, offsets):
        G = glcm_matrix(img.permute(0, 2, 3, 1), mask[:, 0], levels=512, offset=off, device="cpu")
        want = glcm_sumsq_limbs(G.reshape(4, -1).to(torch.int64), cheap_limbs(30 * 30, 512)).reshape(2, 2, 4)
        assert torch.equal(st.glcm_sumsq, want)


# --- per-batch uploads and in_flight -----------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_in_flight_is_accepted_and_changes_nothing(masked):
    """``in_flight`` in {1, 2, 8} and the default give the same bytes on both
    batched entry points, from host arrays, CPU tensors and lists; tpumcia's
    call with ``in_flight`` agrees."""
    from tpumcia.features.extract import extract_features_batched as jax_batched

    x, m = _images(n=23, hw=16, c=3, seed=5)
    mask = m[..., 0] if masked else None
    base = tt.extract_features_batched(x, mask, device="cpu", batch_size=5)
    assert base.shape == (23, 69)
    for in_flight in (1, 2, 8):
        got = tt.extract_features_batched(x, mask, device="cpu", batch_size=5, in_flight=in_flight)
        np.testing.assert_array_equal(got.values, base.values)
        np.testing.assert_array_equal(got.degenerate, base.degenerate)
        pending = tt.extract_features_pending(
            x, mask, device="cpu", batch_size=5, in_flight=in_flight, keep_device_values=True)
        assert len(pending.wires) == 5 and tuple(pending.device_values.shape) == (23, 69)
        np.testing.assert_array_equal(pending.result().values, base.values)
    as_tensor = tt.extract_features_batched(
        torch.from_numpy(x), None if mask is None else torch.from_numpy(mask), device="cpu", batch_size=5)
    np.testing.assert_array_equal(as_tensor.values, base.values)
    direct = tt.extract_features(x, mask, device="cpu")
    np.testing.assert_array_equal(base.values, direct.values)  # rows do not depend on their batch
    want = jax_batched(x, mask=mask, batch_size=5, in_flight=2, config=JFeatureConfig(use_pallas="never"))
    np.testing.assert_allclose(np.nan_to_num(base.values), np.nan_to_num(np.asarray(want.values)), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="in_flight must be >= 1"):
        tt.extract_features_pending(x, mask, device="cpu", batch_size=5, in_flight=0)


def test_pending_synth_noise_with_in_flight():
    gray = np.random.default_rng(6).integers(0, 256, size=(11, 16, 16)).astype(np.uint8)
    a = tt.extract_features_pending(gray, device="cpu", batch_size=4, synth_noise=2, synth_seed=1).result()
    b = tt.extract_features_pending(gray, device="cpu", batch_size=4, synth_noise=2, synth_seed=1, in_flight=1).result()
    np.testing.assert_array_equal(a.values, b.values)
    assert a.shape == (11, 69)


# --- the scaler and the citation ----------------------------------------------


def test_minmax_scaler_inverse_round_trip():
    from tpumcia.models.scaler import MinMaxScaler as JScaler
    from tpumcia_torch.models.scaler import MinMaxScaler

    rng = np.random.default_rng(7)
    X = (rng.normal(size=(40, 5)) * [1, 10, 100, 0.1, 1] + [0, 5, -50, 2, 0]).astype(np.float32)
    X[:, 4] = 3.0  # a zero-range column
    s, js = MinMaxScaler.fit(torch.from_numpy(X)), JScaler.fit(X)
    scaled = s.transform(torch.from_numpy(X))
    back = s.inverse_transform(scaled)
    np.testing.assert_allclose(back.numpy(), X, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(js.inverse_transform(js.transform(X))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        s.inverse_transform(torch.from_numpy(X)).numpy(), np.asarray(js.inverse_transform(X)), rtol=1e-6)
    got, want = s.to_numpy(), js.to_numpy()
    assert set(got) == set(want) == {"data_min", "data_max"}
    for k in got:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], want[k])
    Z = torch.tensor([[2.0, 1.0], [2.0, 3.0]])
    sz = MinMaxScaler.fit(Z)
    np.testing.assert_allclose(sz.inverse_transform(sz.transform(Z)).numpy(), Z.numpy(), atol=1e-6)
    again = MinMaxScaler.from_stats(**got, device="cpu")
    assert torch.equal(again.transform(torch.from_numpy(X)), scaled)


def test_permutation_importance_citation():
    """The reference's permutation importance is ipynb:493-505 (458-462 is
    its MDI aggregation)."""
    from tpumcia_torch import config

    src = inspect.getsource(config.ImportanceConfig)
    assert "'permutation' (reference default,\n    # ipynb:493-505)" in src


# --- C6: tpumcia's stats-level sufficient_stats(_multi) ----------------------


def _stats_batch(levels, mask_kind, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, levels, size=(3, 20, 18, 2)).astype(np.uint8 if levels <= 256 else np.int32)
    x[1, ..., 1] = 0  # an all-zero channel: vmax 0, rescale row 0
    shape = {"none": None, "shared": x.shape[:3], "per_channel": x.shape}[mask_kind]
    mask = None if shape is None else rng.random(shape) < 0.7
    if mask is not None:
        mask[2] = False  # an empty mask: count 0, vmax -1
    return x, mask


def _assert_suffstats_equal(got, want):
    """Every field of tpumcia's stats-level result bit-equal; ``dstats``
    absent on both."""
    assert want.dstats is None and got.dstats is None
    for name in want._fields:
        w = getattr(want, name)
        if w is None:
            continue
        g = getattr(got, name)
        assert g.dtype == {"vmax": torch.int32, "glcm_sumsq": torch.int32}.get(name, torch.float32), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("levels", [256, 1024])
@pytest.mark.parametrize("mask_kind", ["none", "shared", "per_channel"])
def test_stats_level_sufficient_stats_matches_jax(levels, mask_kind):
    from tpumcia.features import stats as jstats
    from tpumcia_torch.features import stats as tstats

    x, mask = _stats_batch(levels, mask_kind)
    kw = dict(levels=levels, offset=(1, 3), chunk_size=2, onehot_dtype="float32")
    want = jstats.sufficient_stats(x, mask, **kw)
    got = tstats.sufficient_stats(x, mask, device="cpu", **kw)
    assert got.diff_hist.shape == (3, 2, 2 * levels - 1)
    _assert_suffstats_equal(got, want)
    # tpumcia's defaults (256 levels, offset (0, 5)) and XLA knobs left out
    if levels == 256:
        _assert_suffstats_equal(tstats.sufficient_stats(x, mask, device="cpu"),
                                jstats.sufficient_stats(x, mask))


@pytest.mark.parametrize("with_intensity,with_glcm", [(False, True), (True, False), (False, False)])
def test_stats_level_fields_off_match_jax(with_intensity, with_glcm):
    """``with_*=False`` zero the fields they turn off (zeros, not None);
    without the GLCM fields an offset that leaves the image is accepted, as
    tpumcia accepts it, and with them refused with tpumcia's message."""
    from tpumcia.features import stats as jstats
    from tpumcia_torch.features import stats as tstats

    x, mask = _stats_batch(256, "shared")
    kw = dict(with_intensity=with_intensity, with_glcm=with_glcm)
    got = tstats.sufficient_stats(x, mask, device="cpu", **kw)
    _assert_suffstats_equal(got, jstats.sufficient_stats(x, mask, **kw))
    assert bool(got.count.any()) and got.diff_hist is not None
    assert bool(got.hist.any()) == with_intensity and bool(got.marg_l.any()) == with_glcm
    far = dict(kw, offset=(0, 40))
    if with_glcm:
        with pytest.raises(ValueError) as want_err:
            jstats.sufficient_stats(x, mask, **far)
        with pytest.raises(ValueError, match="leaves no valid pairs") as got_err:
            tstats.sufficient_stats(x, mask, device="cpu", **far)
        assert str(got_err.value) == str(want_err.value)
    else:
        _assert_suffstats_equal(tstats.sufficient_stats(x, mask, device="cpu", **far),
                                jstats.sufficient_stats(x, mask, **far))


@pytest.mark.parametrize("mask_kind", ["none", "per_channel"])
@pytest.mark.parametrize("with_intensity", [True, False])
def test_stats_level_sufficient_stats_multi_matches_jax(mask_kind, with_intensity):
    """One SuffStats per offset; the intensity histogram on the first only."""
    from tpumcia.features import stats as jstats
    from tpumcia_torch.features import stats as tstats

    x, mask = _stats_batch(256, mask_kind, seed=4)
    offsets = ((0, 5), (2, -2), (3, 0))
    want = jstats.sufficient_stats_multi(x, mask, offsets=offsets, with_intensity=with_intensity)
    got = tstats.sufficient_stats_multi(x, mask, offsets=offsets, with_intensity=with_intensity,
                                        device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_suffstats_equal(g, w)
    assert bool(got[0].hist.any()) == with_intensity and not got[1].hist.any()


def test_glcm_sumsq_value_in_tpumcias_positional_order():
    from tpumcia.features import stats as jstats
    from tpumcia_torch.features import stats as tstats

    rng = np.random.default_rng(5)
    limbs = rng.integers(0, 1 << 20, size=(4, 3, 4)).astype(np.int32)
    want = jstats.glcm_sumsq_value(limbs, np, np.float64)
    got = tstats.glcm_sumsq_value(limbs, np, np.float64)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tstats.glcm_sumsq_value(limbs), want)
    t = tstats.glcm_sumsq_value(torch.from_numpy(limbs))
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), jstats.glcm_sumsq_value(limbs, np, np.float32))
    np.testing.assert_array_equal(tstats.glcm_sumsq_value(torch.from_numpy(limbs), np), want)
