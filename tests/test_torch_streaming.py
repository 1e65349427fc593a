"""tpumcia_torch's ``stream_extract`` against tpumcia's on the same fetch,
and shard directories crossing between the two packages.

tpumcia runs as its own tests run it on the CPU (the XLA statistics,
``use_pallas='never'``); the port runs its kernel's plain version on
``device="cpu"``. Tolerances: feature columns derived from integer wire
words alone (min, percentiles, max, total, mean, contrast, dissimilarity,
ASM, energy, correlation) are bit-equal; the columns that read an f32 word
(std, kurtosis, skew, entropy, homogeneity: sums in another order) agree to
1e-5 max abs, the hybrid tolerance of ``test_torch_pipeline.py``;
``precision='exact'`` agrees to 1e-9. The npz keys and the manifest records
are identical, ``progress.jsonl`` has the same fields.
"""

import json

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (limits torch to one thread)
import tpumcia.pipeline.streaming as jstream
import tpumcia_torch.pipeline.streaming as tstream
from tpumcia.config import FeatureConfig as JFeatureConfig
from tpumcia.config import GLCMConfig as JGLCMConfig
from tpumcia_torch.config import FeatureConfig, GLCMConfig
from tpumcia_torch.features.extract import extract_features

FLOAT_DERIVED = ("std_intensity", "kurtosis_intensity", "skew_intensity", "shannon_entropy", "homogeneity")
HYBRID_ATOL = 1e-5
JCFG = JFeatureConfig(use_pallas="never")


def _collection(n_per_class=4, num_classes=3, seed=2, masked=False):
    """A small 3-channel collection made with numpy alone: a synthetic
    grayscale channel plus two clipped-noise channels, labels, and an 80 %
    per-channel mask."""
    from tpumcia_torch.io.synthetic import synthetic_mednist

    gray, labels, _ = synthetic_mednist(n_per_class, num_classes=num_classes, hw=32, seed=seed)
    rng = np.random.default_rng(seed)
    noise = (np.clip(rng.normal(0, 0.1, size=(*gray.shape, 2)), 0, 1) * 255).astype(np.uint8)
    images = np.concatenate([gray[..., None], noise], axis=-1)
    mask = (rng.random(images.shape) < 0.8).astype(np.uint8) if masked else None
    return images, labels, mask


def _fetcher(images, labels, mask=None, calls=None):
    def fetch(idx):
        if calls is not None:
            calls.append(tuple(int(i) for i in idx))
        return images[idx], None if mask is None else mask[idx], labels[idx]

    return fetch


def _assert_features_match(got, want, atol=HYBRID_ATOL):
    assert got.names == want.names and got.num_channels == want.num_channels
    a, b = np.asarray(got.values), np.asarray(want.values)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    exact = [i for i, n in enumerate(got.names) if not n.startswith(FLOAT_DERIVED)]
    assert 0 < len(exact) < len(got.names)
    np.testing.assert_array_equal(a[:, exact], b[:, exact])
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=0, atol=atol)
    np.testing.assert_array_equal(got.degenerate, want.degenerate)


def _records(out):
    """Everything a shard directory holds, in a comparable form."""
    shards = {}
    for p in sorted(out.glob("shard_*.npz")):
        with np.load(p) as z:
            shards[p.name] = {k: (z[k].dtype.str, z[k].shape) for k in z.files}
    manifests = {p.name: json.loads(p.read_text()) for p in sorted(out.glob("manifest*.json"))}
    progress = [
        {k: v for k, v in json.loads(line).items() if k == "shard" or k == "images" or k == "event"}
        for p in sorted(out.glob("progress*.jsonl")) for line in p.read_text().splitlines()
    ]
    fields = {
        frozenset(json.loads(line)) for p in out.glob("progress*.jsonl")
        for line in p.read_text().splitlines()
    }
    return shards, manifests, progress, fields


@pytest.mark.parametrize("masked", [False, True])
def test_stream_extract_matches_jax(tmp_path, masked):
    """The same fetch through both packages: features, labels, counts, the
    npz keys, the manifest and the progress log."""
    images, labels, mask = _collection(masked=masked)
    fetch = _fetcher(images, labels, mask)
    want = jstream.stream_extract(fetch, len(images), tmp_path / "jax", shard_size=5, config=JCFG)
    got = tstream.stream_extract(fetch, len(images), tmp_path / "torch", device="cpu", shard_size=5)
    assert isinstance(got, tstream.StreamResult)
    assert (got.shards_computed, got.shards_skipped) == (want.shards_computed, want.shards_skipped) == (3, 0)
    assert got.features.shape == (12, 69)
    _assert_features_match(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert set(got.profile) == set(want.profile) == {"ingest_wait_s", "device_s", "save_s", "total_s"}
    assert got.images_per_second > 0
    assert _records(tmp_path / "torch") == _records(tmp_path / "jax")
    assert not (tmp_path / "torch" / "manifest.jsonl").exists()  # compacted away


def test_directories_cross_between_packages(tmp_path):
    """A directory written by tpumcia is resumed by the port with every
    shard skipped and loads to the same matrix, and the other way round; a
    half-done directory of either is finished by the other."""
    images, labels, _ = _collection()
    n = len(images)
    calls = []
    fetch = _fetcher(images, labels, calls=calls)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    want = jstream.stream_extract(fetch, n, jdir, shard_size=5, config=JCFG)
    got = tstream.stream_extract(fetch, n, tdir, device="cpu", shard_size=5)

    calls.clear()
    res = tstream.stream_extract(fetch, n, jdir, device="cpu", shard_size=5)
    assert (res.shards_computed, res.shards_skipped) == (0, 3) and not calls
    np.testing.assert_array_equal(res.features.values, np.asarray(want.features.values))
    assert res.features.names == want.features.names
    fm, lab = tstream.load_feature_shards(jdir)
    np.testing.assert_array_equal(fm.values, np.asarray(want.features.values))
    np.testing.assert_array_equal(lab, labels)

    jres = jstream.stream_extract(fetch, n, tdir, shard_size=5, config=JCFG)
    assert (jres.shards_computed, jres.shards_skipped) == (0, 3) and not calls
    np.testing.assert_array_equal(np.asarray(jres.features.values), got.features.values)
    jfm, jlab = jstream.load_feature_shards(tdir)
    np.testing.assert_array_equal(np.asarray(jfm.values), got.features.values)
    np.testing.assert_array_equal(jlab, labels)

    # each package finishes what the other left: only the missing shard runs
    (jdir / "shard_000000005.npz").unlink()
    res = tstream.stream_extract(fetch, n, jdir, device="cpu", shard_size=5)
    assert (res.shards_computed, res.shards_skipped) == (1, 2) and calls == [(5, 6, 7, 8, 9)]
    _assert_features_match(res.features, want.features)
    (tdir / "shard_000000000.npz").unlink()
    jres = jstream.stream_extract(fetch, n, tdir, shard_size=5, config=JCFG)
    assert (jres.shards_computed, jres.shards_skipped) == (1, 2)
    _assert_features_match(got.features, jres.features)


def test_stream_extract_resume(tmp_path):
    images, labels, _ = _collection()
    calls = []
    fetch = _fetcher(images, labels, calls=calls)
    out = tmp_path / "features"
    res1 = tstream.stream_extract(fetch, len(images), out, device="cpu", shard_size=5)
    assert res1.shards_computed == 3 and res1.shards_skipped == 0
    np.testing.assert_array_equal(res1.labels, labels)
    n_calls = len(calls)
    res2 = tstream.stream_extract(fetch, len(images), out, device="cpu", shard_size=5)
    assert res2.shards_computed == 0 and res2.shards_skipped == 3 and len(calls) == n_calls
    assert res2.images_per_second == 0.0
    np.testing.assert_array_equal(res2.features.values, res1.features.values)
    (out / "shard_000000005.npz").unlink()
    res3 = tstream.stream_extract(fetch, len(images), out, device="cpu", shard_size=5)
    assert res3.shards_computed == 1 and res3.shards_skipped == 2
    np.testing.assert_array_equal(res3.features.values, res1.features.values)


def test_stream_manifest_o1_appends_and_compaction(tmp_path, monkeypatch):
    """Shard completions are O(1) appends to manifest.jsonl; a run writes the
    full .json once, at its end, and removes the log."""
    images, labels, _ = _collection()
    saves = []
    real_save = tstream._save_manifest
    monkeypatch.setattr(
        tstream, "_save_manifest", lambda *a, **k: (saves.append(1), real_save(*a, **k)))
    out = tmp_path / "f"
    res = tstream.stream_extract(_fetcher(images, labels), len(images), out, device="cpu", shard_size=5)
    assert res.shards_computed == 3 and len(saves) == 1
    assert (out / "manifest.json").exists() and not (out / "manifest.jsonl").exists()
    m = json.loads((out / "manifest.json").read_text())
    assert m["config_tag"] == "default" and sorted(m["shards"]) == [
        "shard_000000000", "shard_000000005", "shard_000000010"]
    assert m["shards"]["shard_000000010"] == {
        "status": "done", "start": 10, "stop": 12, "file": "shard_000000010.npz"}


@pytest.mark.parametrize("crashed", ["torch", "jax"])
def test_stream_resume_from_interrupted_jsonl_and_mixed_dirs(tmp_path, crashed):
    """An interrupted run of either package leaves manifest.jsonl with its
    header line; the port resumes from it, beside an older manifest.json and
    with a torn last line."""
    images, labels, _ = _collection()
    calls = []
    fetch = _fetcher(images, labels, calls=calls)

    def fetch_crash_after_2(idx):
        if len(calls) >= 2:
            raise RuntimeError("simulated mid-run crash")
        return fetch(idx)

    out = tmp_path / "f"
    with pytest.raises(RuntimeError, match="simulated"):
        if crashed == "torch":
            tstream.stream_extract(fetch_crash_after_2, len(images), out, device="cpu", shard_size=5,
                                   prefetch_depth=0, stage_on_device=False)
        else:
            jstream.stream_extract(fetch_crash_after_2, len(images), out, shard_size=5, config=JCFG,
                                   prefetch_depth=0, stage_on_device=False)
    jl = out / "manifest.jsonl"
    assert jl.exists() and not (out / "manifest.json").exists()
    lines = jl.read_text().splitlines()
    assert json.loads(lines[0]) == {"version": 2, "config_tag": "default"}
    done_lines = [l for l in lines if '"sid"' in l]
    assert len(done_lines) >= 1
    recs = [json.loads(l) for l in done_lines]
    legacy = {"version": 1, "config_tag": "default", "shards": {recs[0].pop("sid"): recs[0]}}
    (out / "manifest.json").write_text(json.dumps(legacy))
    kept = [l for l in lines if json.loads(l).get("sid") != list(legacy["shards"])[0]]
    jl.write_text("\n".join(kept) + "\n" + '{"sid": "shard_0000')  # torn

    calls.clear()
    res = tstream.stream_extract(fetch, len(images), out, device="cpu", shard_size=5)
    assert res.shards_computed + res.shards_skipped == 3 and res.shards_skipped >= 1
    assert len(calls) == res.shards_computed
    assert res.features.shape == (12, 69)
    np.testing.assert_array_equal(res.labels, labels)
    assert not jl.exists()
    assert len(json.loads((out / "manifest.json").read_text())["shards"]) == 3
    direct = extract_features(images, device="cpu")
    _assert_features_match(res.features, direct)


@pytest.mark.parametrize("prefetch_depth", [0, 2])
def test_stream_extract_staging_parity(tmp_path, prefetch_depth):
    """With the upload on the prefetch worker or in the consumer, with or
    without prefetch: the same bytes."""
    images, labels, mask = _collection(masked=True)
    fetch = _fetcher(images, labels, mask)
    kw = dict(device="cpu", shard_size=5, prefetch_depth=prefetch_depth)
    on = tstream.stream_extract(fetch, len(images), tmp_path / "on", **kw)
    off = tstream.stream_extract(fetch, len(images), tmp_path / "off", stage_on_device=False, **kw)
    np.testing.assert_array_equal(on.features.values, off.features.values)
    np.testing.assert_array_equal(on.labels, off.labels)


def test_stream_partial_final_shard_matches_direct(tmp_path):
    """The partial last shard runs at its own size; every row equals direct
    extraction of the whole collection, bit for bit, and no shard file holds
    more rows than its index range."""
    images, labels, mask = _collection(seed=7, masked=True)
    assert len(images) % 5 != 0
    res = tstream.stream_extract(
        _fetcher(images, labels, mask), len(images), tmp_path / "s", device="cpu", shard_size=5)
    direct = extract_features(images, mask, device="cpu")
    np.testing.assert_array_equal(res.features.values, direct.values)
    np.testing.assert_array_equal(res.features.degenerate, direct.degenerate)
    with np.load(tmp_path / "s" / "shard_000000010.npz") as z:
        assert z["values"].shape == (2, 69) and z["indices"].tolist() == [10, 11]
        assert z["labels"].tolist() == labels[10:].tolist()


def test_stream_fetch_may_return_tensors(tmp_path):
    images, labels, mask = _collection(masked=True)

    def fetch(idx):
        return torch.from_numpy(images[idx]), torch.from_numpy(mask[idx]), labels[idx]

    res = tstream.stream_extract(fetch, len(images), tmp_path / "t", device="cpu", shard_size=5)
    direct = extract_features(images, mask, device="cpu")
    np.testing.assert_array_equal(res.features.values, direct.values)


@pytest.mark.parametrize("kind", ["exact", "multi_offset", "intensity_only"])
def test_stream_extract_other_branch_matches_jax(tmp_path, kind):
    """Configs outside the u32 wire run ``extract_features`` per shard in
    both packages (``precision='exact'``: 1e-9, the host float64 backend)."""
    kw = {"exact": dict(precision="exact"), "multi_offset": dict(),
          "intensity_only": dict(include_glcm=False)}[kind]
    glcm = dict(distance=(1, 5)) if kind == "multi_offset" else {}
    images, labels, mask = _collection(masked=True)
    fetch = _fetcher(images, labels, mask)
    jcfg = JFeatureConfig(use_pallas="never", glcm=JGLCMConfig(**glcm), **kw)
    cfg = FeatureConfig(glcm=GLCMConfig(**glcm), **kw)
    want = jstream.stream_extract(fetch, len(images), tmp_path / "jax", shard_size=5, config=jcfg)
    got = tstream.stream_extract(fetch, len(images), tmp_path / "torch", device="cpu", shard_size=5, config=cfg)
    assert got.features.names == want.features.names
    a, b = got.features.values, np.asarray(want.features.values)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), rtol=0,
                               atol=1e-9 if kind == "exact" else HYBRID_ATOL)
    assert _records(tmp_path / "torch") == _records(tmp_path / "jax")


def test_stream_config_tag_guard(tmp_path):
    images, labels, _ = _collection(n_per_class=2, num_classes=2)
    fetch = _fetcher(images, labels)
    tstream.stream_extract(fetch, 4, tmp_path / "f", device="cpu", shard_size=4, config_tag="a")
    with pytest.raises(ValueError, match="config_tag='a', refusing to mix with 'b'"):
        tstream.stream_extract(fetch, 4, tmp_path / "f", device="cpu", shard_size=4, config_tag="b")
    # a directory tagged by tpumcia is guarded too
    jstream.stream_extract(fetch, 4, tmp_path / "j", shard_size=4, config=JCFG, config_tag="a")
    with pytest.raises(ValueError, match="config_tag"):
        tstream.stream_extract(fetch, 4, tmp_path / "j", device="cpu", shard_size=4)


def test_stream_extract_entry_errors(tmp_path):
    images, labels, _ = _collection()

    def never(idx):  # pragma: no cover - must never be called
        raise AssertionError("fetch called")

    with pytest.raises(ValueError, match="n >= 1"):
        tstream.stream_extract(never, 0, tmp_path, device="cpu", shard_size=8)
    with pytest.raises(ValueError, match="shard_size must be >= 1"):
        tstream.stream_extract(never, 4, tmp_path, device="cpu", shard_size=0)
    flo = images.astype(np.float32) / 255.0
    for depth in (0, 2):  # in the consumer and through the prefetch worker
        with pytest.raises(TypeError, match="integer level"):
            tstream.stream_extract(lambda idx: (flo[idx], None, labels[idx]), len(flo),
                                   tmp_path / f"f{depth}", device="cpu", shard_size=6, prefetch_depth=depth)
    raw = images.astype(np.uint16) * 200
    with pytest.raises(TypeError, match="outside"):
        tstream.stream_extract(lambda idx: (raw[idx], None, labels[idx]), len(raw),
                               tmp_path / "raw", device="cpu", shard_size=6)
    with pytest.raises(TypeError, match="Mesh"):
        tstream.stream_extract(never, 4, tmp_path / "m", device="cpu", mesh=object())


@pytest.mark.parametrize("kwargs,match", [
    (dict(process_count=2), "an explicit process_count > 1 requires an explicit process_index"),
    (dict(process_index=1), "process_index was given without process_count"),
    (dict(process_index=0, process_count=2, mesh=object()), "mutually exclusive"),
    (dict(process_index=2, process_count=2), "process_index 2 out of range for process_count 2"),
    (dict(process_index=-1, process_count=1), "out of range"),
])
def test_stream_extract_rejects_inconsistent_process_topology(tmp_path, kwargs, match):
    images, labels, _ = _collection(n_per_class=2, num_classes=2)
    with pytest.raises(ValueError, match=match):
        tstream.stream_extract(_fetcher(images, labels), len(images), tmp_path / "a", device="cpu", **kwargs)


def test_stream_extract_explicit_process_split(tmp_path):
    """Two calls in sequence with an explicit (index, count): each owns a
    round-robin half of the shards and fetches only those; the per-process
    manifests merge to the full matrix, which tpumcia loads too; a resume at
    another process count recomputes nothing."""
    images, labels, _ = _collection(n_per_class=5, seed=3)  # 15 images, shards of 4
    fetched = {0: [], 1: []}
    fetch = {p: _fetcher(images, labels, calls=fetched[p]) for p in (0, 1)}
    out = tmp_path / "split"
    kw = dict(device="cpu", shard_size=4, process_count=2)
    res0 = tstream.stream_extract(fetch[0], len(images), out, process_index=0, barrier_timeout_s=0, **kw)
    res1 = tstream.stream_extract(fetch[1], len(images), out, process_index=1, **kw)
    assert res0.shards_computed == 2 and res1.shards_computed == 2
    assert res0.profile["process_count"] == 2 and res1.profile["process_index"] == 1
    assert sorted(sum(fetched[0], ())) == list(range(0, 4)) + list(range(8, 12))
    assert sorted(sum(fetched[1], ())) == list(range(4, 8)) + list(range(12, 15))
    assert sorted(p.name for p in out.glob("manifest*")) == ["manifest_p0000.json", "manifest_p0001.json"]
    assert sorted(p.name for p in out.glob("progress*")) == ["progress_p0000.jsonl", "progress_p0001.jsonl"]
    assert len(res0.features) == 8  # p0 assembled what existed when it ran

    direct = extract_features(images, device="cpu")
    fm, lab = tstream.load_feature_shards(out)
    assert fm.names == direct.names
    np.testing.assert_array_equal(fm.values, direct.values)
    np.testing.assert_array_equal(res1.features.values, direct.values)
    np.testing.assert_array_equal(lab, labels)
    jfm, _ = jstream.load_feature_shards(out)
    np.testing.assert_array_equal(np.asarray(jfm.values), direct.values)

    resume = tstream.stream_extract(fetch[0], len(images), out, device="cpu", shard_size=4,
                                    process_index=0, process_count=1)
    assert resume.shards_computed == 0 and resume.shards_skipped == 4
    assert resume.features.names == direct.names


def test_stream_extract_explicit_split_barrier_raises_on_missing_shards(tmp_path, monkeypatch):
    images, labels, _ = _collection(n_per_class=3, seed=1)
    fetch = _fetcher(images, labels)
    with pytest.raises(RuntimeError, match="barrier timed out after 0s: 1/3 shards not done"):
        tstream.stream_extract(fetch, len(images), tmp_path / "lone", device="cpu", shard_size=4,
                               process_index=0, process_count=2, barrier_timeout_s=0.2)
    # the default comes from the environment variable tpumcia reads
    monkeypatch.setenv("TPUMCIA_STREAM_BARRIER_TIMEOUT", "0.1")
    with pytest.raises(RuntimeError, match="TPUMCIA_STREAM_BARRIER_TIMEOUT"):
        tstream.stream_extract(fetch, len(images), tmp_path / "env", device="cpu", shard_size=4,
                               process_index=0, process_count=2)


def test_load_feature_shards_carries_config_grouping(tmp_path):
    images, labels, _ = _collection(n_per_class=3, num_classes=2)
    cfg = FeatureConfig(glcm=GLCMConfig(distance=(1, 5)))
    out = tmp_path / "multioffset"
    tstream.stream_extract(_fetcher(images, labels), len(images), out, device="cpu", shard_size=4, config=cfg)
    fm, _ = tstream.load_feature_shards(out, config=cfg)
    direct = extract_features(images, device="cpu", config=cfg)
    assert fm.names == direct.names and fm.channel_columns() == direct.channel_columns()
    fm_default, _ = tstream.load_feature_shards(out)
    assert fm_default.channel_columns() != direct.channel_columns()
    with pytest.raises(FileNotFoundError, match="no completed shards"):
        tstream.load_feature_shards(tmp_path)


def test_stream_extract_h5_directory(tmp_path, rng):
    """Per-object h5 files (written by tpumcia) through both packages'
    ``stream_extract_h5``: uint16 quantized on the host, masks and labels
    threaded through, the files' channel names in the columns, resume."""
    import tpumcia.io.h5 as jh5

    root = tmp_path / "objects"
    root.mkdir()
    for i in range(6):
        h, w = int(rng.integers(20, 40)), int(rng.integers(20, 40))
        jh5.write_object(
            root / f"{1000 + i}.h5", (rng.random((h, w, 3)) * 65535).astype(np.uint16),
            mask=(rng.random((h, w, 3)) > 0.4).astype(np.uint8),
            label=["tcell", "bcell"][i % 2], donor=f"D{i % 3}", channels=["BF", "GFP", "DAPI"],
        )
    want = jstream.stream_extract_h5(root, tmp_path / "jax", shard_size=4, config=JCFG)
    got = tstream.stream_extract_h5(root, tmp_path / "torch", device="cpu", shard_size=4)
    assert got.shards_computed == 2 and got.features.shape == (6, 69)
    assert got.features.names[0] == "min_intensity_BF" and got.features.channel_names == ["BF", "GFP", "DAPI"]
    _assert_features_match(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    again = tstream.stream_extract_h5(root, tmp_path / "torch", device="cpu", shard_size=4)
    assert again.shards_computed == 0 and again.shards_skipped == 2
    assert again.features.names == got.features.names
    limited = tstream.stream_extract_h5(sorted(root.glob("*.h5")), tmp_path / "lim", device="cpu",
                                        shard_size=4, limit=3, target_hw=(24, 24), decode_threads=1)
    assert limited.features.shape == (3, 69)
