"""tpumcia_torch's ingestion layer against tpumcia's on the same files and
arrays: per-object h5 files (written by one package, read by the other), the
native packer and quantizer against their numpy paths, the prefetch loader,
folder indexing, ``synthetic_multichannel`` and the metrics logger.

Everything here is integer data on the host, so every comparison is
bit-equal, except the port's own noise stream (``synthetic_multichannel``'s
channels 2..C), which is held by its statistics: the mean and variance of
``clip(N(0, sqrt(var)), 0, 1) * 255`` truncated, to 3 standard errors.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import tpumcia.io.h5 as jh5
import tpumcia.io.native as jnative
import tpumcia_torch.io.h5 as th5
import tpumcia_torch.io.native as tnative
from tpumcia_torch.io.loader import PrefetchLoader, batched_indices

META = dict(label="müde", donor="dønor-1", experiment="exp-β", channels=["DAPI-α", "CD45_β", "BF"])


def _write_objects(write_object, root, rng, *, dtype=np.uint16, mask_rank=3, n=6):
    """Variable-size crops with (h, w, c) masks (``mask_rank=3``), plain
    (h, w) ones (2), a mix of (h, w) and (h, w, 1) (``"mixed"``) or none."""
    top = 65535 if dtype == np.uint16 else 255
    paths = []
    for i in range(n):
        h, w = int(rng.integers(14, 30)), int(rng.integers(14, 30))
        img = (rng.random((h, w, 3)) * top).astype(dtype)
        if mask_rank is None:
            msk = None
        elif mask_rank == "mixed":
            msk = (rng.random((h, w) if i % 2 else (h, w, 1)) > 0.4).astype(np.uint8)
        else:
            msk = (rng.random((h, w, 3)[:mask_rank]) > 0.4).astype(np.uint8)
        p = root / f"{1000 + i}.h5"
        write_object(p, img, mask=msk, **{**META, "label": ["müde", "santé"][i % 2]})
        paths.append(p)
    return paths


def _assert_batches_equal(got, want):
    np.testing.assert_array_equal(got.images, want.images)
    assert got.images.dtype == want.images.dtype
    if want.masks is None:
        assert got.masks is None
    else:
        np.testing.assert_array_equal(got.masks, want.masks)
        assert got.masks.shape == want.masks.shape
    for field in ("labels", "donors", "experiments"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.channels == want.channels and got.ids == want.ids


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax"), ("torch", "torch")])
def test_objects_cross_between_packages(tmp_path, rng, writer, reader):
    """A file written by one package reads back in the other: arrays
    bit-equal, the UTF-8 metadata and channel names intact, the id the file's
    stem."""
    mods = {"jax": jh5, "torch": th5}
    img = (rng.random((17, 21, 3)) * 65535).astype(np.uint16)
    msk = (rng.random((17, 21, 3)) > 0.5).astype(np.uint8)
    path = tmp_path / "4711.h5"
    mods[writer].write_object(path, img, mask=msk, **META)
    obj = mods[reader].read_object(path)
    np.testing.assert_array_equal(obj["image"], img)
    np.testing.assert_array_equal(obj["mask"], msk)
    assert obj["image"].dtype == np.uint16
    assert {k: obj[k] for k in ("label", "donor", "experiment", "channels")} == META
    assert obj["id"] == "4711"
    assert obj == {**jh5.read_object(path), "image": obj["image"], "mask": obj["mask"]}


@pytest.mark.parametrize("mask_rank", [3, 2, "mixed", None])
@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_load_objects_matches_jax(tmp_path, rng, mask_rank, dtype):
    """Variable-size crops written by tpumcia load to the same batch in both
    packages, with (h, w, c), plain (h, w), mixed-rank and no masks; an
    explicit ``target_hw`` and ``limit`` too."""
    _write_objects(jh5.write_object, tmp_path, rng, dtype=dtype, mask_rank=mask_rank)
    got, want = th5.load_objects(tmp_path), jh5.load_objects(tmp_path)
    assert isinstance(got, th5.ObjectBatch) and len(got) == 6 and got.num_channels == 3
    _assert_batches_equal(got, want)
    if mask_rank == 2:
        assert got.masks.ndim == 3
    if mask_rank == "mixed":
        assert got.masks.shape[-1] == 1
    _assert_batches_equal(
        th5.load_objects(tmp_path, target_hw=(20, 32), limit=4),
        jh5.load_objects(tmp_path, target_hw=(20, 32), limit=4),
    )
    assert [p.name for p in th5.list_object_files(tmp_path)] == [
        p.name for p in jh5.list_object_files(tmp_path)]


def test_load_objects_other_dtypes_use_center_crop_or_pad(tmp_path, rng):
    """int16 images leave the native packer's types: the port packs them
    with its own ``center_crop_or_pad``, to tpumcia's arrays."""
    for i, hw in enumerate([(12, 15), (16, 11), (9, 9)]):
        jh5.write_object(tmp_path / f"{i}.h5", rng.integers(0, 3000, size=(*hw, 2)).astype(np.int16))
    got, want = th5.load_objects(tmp_path), jh5.load_objects(tmp_path)
    assert got.images.dtype == np.int16 and got.labels is None
    _assert_batches_equal(got, want)


def test_load_objects_errors(tmp_path, rng):
    import h5py

    bad = tmp_path / "missing"
    bad.mkdir()
    with h5py.File(bad / "bad.h5", "w") as f:
        f.create_dataset("mask", data=np.zeros((4, 4, 1)))
    with pytest.raises(KeyError, match="image"):
        th5.load_objects(bad)
    with pytest.raises(FileNotFoundError, match="no .h5"):
        th5.load_objects(tmp_path / "missing" / "nowhere")
    counts = tmp_path / "counts"
    counts.mkdir()
    for i, shape in enumerate([(18, 18), (18, 18, 3)]):  # (h, w) vs (h, w, 3) masks
        th5.write_object(counts / f"{i}.h5", (rng.random((18, 18, 3)) * 65535).astype(np.uint16),
                         mask=(rng.random(shape) > 0.5).astype(np.uint8), label="x")
    with pytest.raises(ValueError, match="channel counts"):
        th5.load_objects(counts)


def test_h5_stream_source_matches_jax(tmp_path, rng):
    """The streaming adapter's batches (native pack + quantize) equal
    tpumcia's and ``load_objects`` + quantize; channel names are read."""
    _write_objects(th5.write_object, tmp_path, rng)
    got, want = th5.h5_stream_source(tmp_path), jh5.h5_stream_source(tmp_path)
    assert len(got) == len(want) == 6 and got.target_hw == want.target_hw
    assert got.channels == META["channels"]
    for idx in (np.arange(6), np.array([4, 1])):
        for a, b in zip(got.fetch(idx), want.fetch(idx)):
            np.testing.assert_array_equal(a, b)
    batch = th5.load_objects(tmp_path)
    images, masks, labels = got(np.arange(6))
    np.testing.assert_array_equal(images, (batch.images >> 8).astype(np.uint8))
    np.testing.assert_array_equal(masks, batch.masks)
    np.testing.assert_array_equal(labels, batch.labels)


def test_h5_stream_uint8_quantize_and_mixed_mask_guards(tmp_path, rng):
    d = tmp_path / "u8"
    d.mkdir()
    _write_objects(jh5.write_object, d, rng, dtype=np.uint8, mask_rank=None, n=4)
    got = th5.h5_stream_source(d, quantize_levels=64).fetch(np.arange(4))
    want = jh5.h5_stream_source(d, quantize_levels=64).fetch(np.arange(4))
    assert got[0].max() < 64 and got[1] is None
    np.testing.assert_array_equal(got[0], want[0])

    m = tmp_path / "mixed"
    m.mkdir()
    for i in range(4):
        img = (rng.random((12, 12, 2)) * 255).astype(np.uint8)
        msk = (rng.random((12, 12, 2)) > 0.5).astype(np.uint8) if i < 2 else None
        th5.write_object(m / f"{i}.h5", img, mask=msk, label="x")
    with pytest.raises(ValueError, match="mixes masked and mask-less objects \\("):
        th5.h5_stream_source(m).fetch(np.arange(4))  # within one batch
    src = th5.h5_stream_source(m, decode_threads=1)
    src.fetch(np.arange(2))
    with pytest.raises(ValueError, match="across batches"):
        src.fetch(np.arange(2, 4))
    with pytest.raises(ValueError, match="no h5 object files"):
        th5.h5_stream_source([])


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_native_packer_matches_numpy_and_jax(rng, dtype):
    """The port's native path (built from the shared packer.cpp into
    build/tpumcia_torch/) equals its numpy path and tpumcia's output, on
    crops larger and smaller than the target."""
    from tpumcia_torch import _build

    shipped = jnative._SO_PATH
    before = shipped.stat().st_mtime_ns if shipped.exists() else None
    assert tnative.get_lib() is not None
    lib = tnative.library_path()
    assert lib.exists() and lib.parent == _build.BUILD_DIR
    arrays = [
        (rng.random((int(rng.integers(8, 40)), int(rng.integers(8, 40)), 4)) * 65535).astype(dtype)
        for _ in range(33)
    ]
    for hw in [(24, 24), (48, 40), (7, 9)]:
        got = tnative.pack_objects(arrays, hw)
        np.testing.assert_array_equal(got, tnative.pack_objects_numpy(arrays, hw))
        np.testing.assert_array_equal(got, jnative.pack_objects(arrays, hw))
        assert got.dtype == dtype and got.shape == (33, *hw, 4)
    np.testing.assert_array_equal(
        tnative.pack_objects(arrays, (24, 24), num_threads=3), tnative.pack_objects(arrays, (24, 24)))
    after = shipped.stat().st_mtime_ns if shipped.exists() else None
    assert after == before  # the port never builds over tpumcia's library
    with pytest.raises(ValueError, match="empty"):
        tnative.pack_objects([], (4, 4))
    with pytest.raises(ValueError, match="share"):
        tnative.pack_objects([arrays[0], arrays[1][..., :2]], (4, 4))


@pytest.mark.parametrize("levels", [256, 64, 7])
def test_native_quantize_matches_numpy_and_jax(rng, levels):
    src = rng.integers(0, 65536, size=(5, 31, 17, 3)).astype(np.uint16)
    src.flat[:2] = (0, 65535)
    got = tnative.quantize_u16(src, levels=levels)
    np.testing.assert_array_equal(got, tnative.quantize_u16_numpy(src, levels=levels))
    np.testing.assert_array_equal(got, jnative.quantize_u16(src, levels=levels))
    assert got.dtype == np.uint8 and got.max() == levels - 1


def test_prefetch_loader_order_and_errors():
    fetched = []

    def fetch(idx):
        fetched.append(idx[0])
        return idx * 2

    out = list(PrefetchLoader(fetch, 10, 3))
    np.testing.assert_array_equal(np.concatenate(out), np.arange(10) * 2)
    assert len(out) == 4 and fetched == [0, 3, 6, 9]

    def bad_fetch(idx):
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(PrefetchLoader(bad_fetch, 4, 2))
    with pytest.raises(ValueError, match="chunks"):
        PrefetchLoader(fetch)
    assert [len(c) for c in batched_indices(10, 4, drop_remainder=True)] == [4, 4]
    assert [len(c) for c in batched_indices(10, 4)] == [4, 4, 2]


def test_prefetch_loader_two_stage_pipeline():
    """With ``stage`` the fetch and the staging run on two threads, in
    order; an error in the stage surfaces in the consumer."""
    threads = {"fetch": set(), "stage": set()}

    def fetch(idx):
        threads["fetch"].add(threading.get_ident())
        return idx

    def stage(batch):
        threads["stage"].add(threading.get_ident())
        return batch + 100

    chunks = [np.arange(s, s + 3) for s in (6, 0, 3)]
    loader = PrefetchLoader(fetch, chunks=chunks, depth=1, stage=stage)
    assert len(loader) == 3 and loader.chunks[0][0] == 6
    out = list(loader)
    np.testing.assert_array_equal(np.concatenate(out), np.concatenate(chunks) + 100)
    me = threading.get_ident()
    assert len(threads["fetch"]) == len(threads["stage"]) == 1
    assert me not in threads["fetch"] | threads["stage"] and threads["fetch"] != threads["stage"]

    def bad_stage(batch):
        raise RuntimeError("upload failed")

    with pytest.raises(RuntimeError, match="upload failed"):
        list(PrefetchLoader(fetch, 6, 2, stage=bad_stage))


@pytest.mark.parametrize("staged", [False, True])
def test_prefetch_loader_early_stop_releases_workers(staged):
    before = threading.active_count()

    def fetch(idx):
        return np.zeros((len(idx), 4), np.float32)

    for _ in range(5):
        it = iter(PrefetchLoader(fetch, 1000, 10, depth=2, stage=(lambda b: b) if staged else None))
        next(it)
        it.close()  # the consumer stops early
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= before + 1, threading.active_count()


def test_folder_index_and_load_images_match_jax(tmp_path, rng):
    import imageio.v3 as iio

    import tpumcia.io.mednist as jmednist
    import tpumcia_torch.io.mednist as tmednist

    written = {}
    for cls in ("cxr", "abd", "hand"):
        (tmp_path / cls).mkdir()
        for i in range(3):
            arr = (rng.random((16, 16)) * 255).astype(np.uint8)
            iio.imwrite(tmp_path / cls / f"{i}.png", arr)
            written[(cls, i)] = arr
        (tmp_path / cls / "notes.txt").write_text("not an image")
    got, want = tmednist.index_image_folder(tmp_path), jmednist.index_image_folder(tmp_path)
    assert got.class_names == want.class_names == ["abd", "cxr", "hand"]
    assert got.files == want.files and len(got) == 9
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == np.int32
    imgs = tmednist.load_images(got.files, num_threads=2)
    np.testing.assert_array_equal(imgs, jmednist.load_images(want.files))
    for k, f in enumerate(got.files):
        np.testing.assert_array_equal(imgs[k], written[(f.parent.name, int(f.stem))])
    with pytest.raises(FileNotFoundError, match="class subdirectories"):
        tmednist.index_image_folder(tmp_path / "abd")


def test_synthetic_multichannel_channel0_equals_jax_noise_by_statistics():
    import tpumcia.io.synthetic as jsyn
    import tpumcia_torch.io.synthetic as tsyn

    got, labels, names = tsyn.synthetic_multichannel(20, device="cpu", num_classes=3, hw=32, num_noise=3, seed=4)
    want, jlabels, jnames = jsyn.synthetic_multichannel(20, num_classes=3, hw=32, num_noise=3, seed=4)
    assert got.shape == want.shape == (60, 32, 32, 4) and got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(labels, jlabels)
    assert names == jnames
    again, _, _ = tsyn.synthetic_multichannel(20, device="cpu", num_classes=3, hw=32, num_noise=3, seed=4)
    np.testing.assert_array_equal(got, again)
    # the noise channels: trunc(clip(z * 0.1, 0, 1) * 255) with z ~ N(0, 1).
    # Moments from a fine grid over z > 0 (z <= 0 gives 0).
    z = np.linspace(0, 10, 200_001)
    pdf = np.exp(-z * z / 2) / np.sqrt(2 * np.pi) * (z[1] - z[0])
    v = np.floor(np.clip(z * 0.1, 0, 1) * 255)
    mean, second = float((v * pdf).sum()), float((v * v * pdf).sum())
    var = second - mean * mean
    noise = got[..., 1:].astype(np.float64)
    n = noise.size
    assert noise.min() == 0 and noise.max() <= 255
    zero = 0.5 + float(pdf[v == 0].sum())  # z < 1/25.5 truncates to 0 too
    assert abs((noise == 0).mean() - zero) < 3 * 0.5 / np.sqrt(n) + 1e-4
    assert abs(noise.mean() - mean) < 3 * np.sqrt(var / n) + 0.01
    assert abs(noise.var() - var) < 0.02 * var
    # tpumcia's own stream has the same distribution
    jn = want[..., 1:].astype(np.float64)
    assert abs(jn.mean() - noise.mean()) < 6 * np.sqrt(var / n) + 0.01
    # channels are drawn independently
    assert abs(np.corrcoef(noise[..., 0].ravel(), noise[..., 1].ravel())[0, 1]) < 0.02


def test_metrics_logger_serialises_arrays_and_tensors(tmp_path, capsys):
    from tpumcia.utils.logging import MetricsLogger as JLogger
    from tpumcia_torch.utils.logging import MetricsLogger

    fields = dict(step=np.int64(3), rate=np.float32(0.5), hist=np.arange(3))
    log = MetricsLogger(tmp_path / "t.jsonl")
    log.log("a", **fields, scalar=torch.tensor(2.5), vec=torch.arange(4).reshape(2, 2))
    log.close()
    jlog = JLogger(tmp_path / "j.jsonl")
    jlog.log("a", **fields)
    jlog.close()
    got = json.loads((tmp_path / "t.jsonl").read_text())
    want = json.loads((tmp_path / "j.jsonl").read_text())
    assert got.pop("scalar") == 2.5 and got.pop("vec") == [[0, 1], [2, 3]]
    got.pop("ts"), want.pop("ts")
    assert got == want == {"event": "a", "step": 3, "rate": 0.5, "hist": [0, 1, 2]}
    assert capsys.readouterr().out == ""  # a file and no echo
    MetricsLogger().log("echoed", n=1)
    assert json.loads(capsys.readouterr().out)["event"] == "echoed"
    with pytest.raises(TypeError, match="not JSON serializable"):
        MetricsLogger(tmp_path / "x.jsonl").log("bad", o=object())
