"""HDF5 per-object ingestion — the reference's real public data contract
(counterpart of ``tpumcia.io.h5``: numpy on the host, ``h5py`` imported
inside the functions that need it; files written by either package are read
by the other).

README.md:5-14 defines one HDF5 file per cell object with keys:

  * ``image``      (h, w, c) 16-bit array           [required]
  * ``mask``       (h, w, c) array                  [optional]
  * ``label``      str                              [optional]
  * ``donor``      str                              [optional]
  * ``experiment`` str                              [optional]
  * ``channels``   list of channel names            [optional]
  * filename = object number in the source .cif file

The reference repository contains no code for this contract (the notebook
reads MedNIST PNGs); this module implements it: batched ingestion into
(B, H, W, C) device-ready arrays plus a host-side metadata table, with
variable-size crops standardised by center crop/pad.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from tpumcia_torch.preprocess.normalize import center_crop_or_pad


@dataclass
class ObjectBatch:
    """A batch of cell objects plus metadata (host side)."""

    images: np.ndarray  # (B, H, W, C) uint16/uint8
    masks: np.ndarray | None  # (B, H, W, C) uint8/bool or None
    labels: np.ndarray | None  # (B,) object labels (str) or None
    donors: np.ndarray | None
    experiments: np.ndarray | None
    channels: list[str] | None  # channel names
    ids: list[str] = field(default_factory=list)  # object ids (filenames)

    def __len__(self):
        return len(self.images)

    @property
    def num_channels(self) -> int:
        return self.images.shape[-1]


def write_object(
    path: str | Path,
    image: np.ndarray,
    *,
    mask: np.ndarray | None = None,
    label: str | None = None,
    donor: str | None = None,
    experiment: str | None = None,
    channels: list[str] | None = None,
) -> None:
    """Write one object file in the README contract layout."""
    import h5py

    def _bytes(s):
        # np.bytes_(str) encodes ascii and dies on e.g. "müde"; store UTF-8
        # bytes (read_object decodes utf-8, so round trips are exact).
        return np.bytes_(s if isinstance(s, bytes) else str(s).encode("utf-8"))

    with h5py.File(path, "w") as f:
        f.create_dataset("image", data=np.asarray(image))
        if mask is not None:
            f.create_dataset("mask", data=np.asarray(mask))
        if label is not None:
            f.create_dataset("label", data=_bytes(label))
        if donor is not None:
            f.create_dataset("donor", data=_bytes(donor))
        if experiment is not None:
            f.create_dataset("experiment", data=_bytes(experiment))
        if channels is not None:
            f.create_dataset(
                "channels", data=np.array([_bytes(c) for c in channels])
            )


def _read_str(f, key) -> str | None:
    if key not in f:
        return None
    v = f[key][()]
    if isinstance(v, bytes):
        return v.decode()
    return str(v)


def read_object(path: str | Path) -> dict:
    """Read one object file -> dict of the contract keys (missing -> None)."""
    import h5py

    with h5py.File(path, "r") as f:
        if "image" not in f:
            raise KeyError(f"{path}: missing required key 'image'")
        out = {
            "image": np.asarray(f["image"]),
            "mask": np.asarray(f["mask"]) if "mask" in f else None,
            "label": _read_str(f, "label"),
            "donor": _read_str(f, "donor"),
            "experiment": _read_str(f, "experiment"),
            "channels": None,
            "id": Path(path).stem,
        }
        if "channels" in f:
            raw = f["channels"][()]
            out["channels"] = [
                c.decode() if isinstance(c, bytes) else str(c) for c in raw
            ]
    return out


def list_object_files(root: str | Path) -> list[Path]:
    """Sorted .h5/.hdf5 files under ``root`` (recursive)."""
    root = Path(root)
    files = sorted(
        p for p in root.rglob("*") if p.suffix.lower() in (".h5", ".hdf5")
    )
    if not files:
        raise FileNotFoundError(f"no .h5/.hdf5 object files under {root}")
    return files


@dataclass
class H5StreamSource:
    """Indexable fetch over a directory of per-object h5 files — the adapter
    that composes the README contract (README.md:5-14) with
    ``pipeline.streaming.stream_extract`` so "millions of objects" never
    need to fit in RAM.

    ``fetch(idx)`` decodes just the requested objects (threaded native
    packing via ``io.native``), returning the ``(images, mask, labels)``
    tuple ``stream_extract`` expects. uint16 images are level-quantised on
    host with the native kernel (identical floor semantics to
    ``preprocess.quantize_to_levels``) when ``quantize_levels`` is set.
    """

    paths: list[Path]
    target_hw: tuple[int, int]
    quantize_levels: int | None = None
    decode_threads: int = 4
    channels: list[str] | None = None
    # set by the first fetch; later batches must agree (a collection mixing
    # masked and mask-less objects would silently mix feature semantics
    # across shards)
    expect_mask: bool | None = None

    def __len__(self) -> int:
        return len(self.paths)

    def fetch(self, idx: np.ndarray):
        from concurrent.futures import ThreadPoolExecutor

        paths = [self.paths[int(i)] for i in np.asarray(idx)]
        if self.decode_threads > 1 and len(paths) > 1:
            with ThreadPoolExecutor(self.decode_threads) as ex:
                objs = list(ex.map(read_object, paths))
        else:
            objs = [read_object(p) for p in paths]

        from tpumcia_torch.io.native import pack_objects, quantize_u16

        images = pack_objects(
            [np.ascontiguousarray(o["image"]) for o in objs], self.target_hw
        )
        if self.quantize_levels:
            if images.dtype == np.uint16:
                images = quantize_u16(images, levels=self.quantize_levels)
            elif images.dtype == np.uint8 and self.quantize_levels < 256:
                # same floor semantics as quantize_u16, over the u8 range:
                # without this, uint8 sources would silently feed raw
                # 0..255 values into a < 256-level feature config
                images = (
                    (images.astype(np.uint32) * self.quantize_levels) >> 8
                ).astype(np.uint8)

        has_mask = [o["mask"] is not None for o in objs]
        masks = None
        if all(has_mask) and objs:
            masks = pack_objects(
                [np.ascontiguousarray(o["mask"]).astype(np.uint8) for o in objs],
                self.target_hw,
            )
        elif any(has_mask):
            raise ValueError(
                f"h5 batch mixes masked and mask-less objects "
                f"({sum(has_mask)}/{len(has_mask)} have masks) — masked and "
                "unmasked features have different semantics; add masks to "
                "all objects or none"
            )
        batch_masked = masks is not None
        if self.expect_mask is None:
            self.expect_mask = batch_masked
        elif self.expect_mask != batch_masked:
            raise ValueError(
                "h5 collection mixes masked and mask-less objects across "
                "batches — shard features would silently mix masked and "
                "unmasked semantics"
            )
        labels = None
        if all(o["label"] is not None for o in objs):
            labels = np.array([o["label"] for o in objs])
        return images, masks, labels

    __call__ = fetch


def h5_stream_source(
    source,
    *,
    target_hw: tuple[int, int] | None = None,
    quantize_levels: int | None = 256,
    limit: int | None = None,
    decode_threads: int = 4,
) -> H5StreamSource:
    """Build a streaming fetch over per-object h5 files.

    With ``target_hw=None`` the shapes of all files are scanned first
    (header-only reads) to find the max H/W; pass it explicitly to skip the
    scan on very large collections. ``quantize_levels`` (default 256)
    level-quantises uint16 images for the exact feature path; None keeps the
    raw dtype.
    """
    import h5py

    if isinstance(source, (str, Path)):
        paths = list_object_files(source)
    else:
        paths = [Path(p) for p in source]
    if limit is not None:
        paths = paths[:limit]
    if not paths:
        raise ValueError(f"no h5 object files found in {source!r}")

    channels = None
    if target_hw is None:
        h = w = 0
        for p in paths:
            with h5py.File(p, "r") as f:
                sh = f["image"].shape
                h, w = max(h, sh[0]), max(w, sh[1])
        target_hw = (h, w)
    with h5py.File(paths[0], "r") as f:
        if "channels" in f:
            raw = f["channels"][()]
            channels = [
                c.decode() if isinstance(c, bytes) else str(c) for c in raw
            ]
    return H5StreamSource(
        paths=paths,
        target_hw=target_hw,
        quantize_levels=quantize_levels,
        decode_threads=decode_threads,
        channels=channels,
    )


def load_objects(
    source,
    *,
    target_hw: tuple[int, int] | None = None,
    limit: int | None = None,
) -> ObjectBatch:
    """Load a directory (or explicit list) of per-object h5 files into one
    batch. Variable-size crops are standardised to ``target_hw`` (default:
    the max H/W over the batch) by center crop/pad; masks are padded with 0.
    """
    if isinstance(source, (str, Path)):
        paths = list_object_files(source)
    else:
        paths = [Path(p) for p in source]
    if limit is not None:
        paths = paths[:limit]

    objs = [read_object(p) for p in paths]
    shapes = np.array([o["image"].shape for o in objs])
    if shapes.shape[1] != 3:
        raise ValueError("object images must be (h, w, c)")
    C = int(shapes[0, 2])
    if not (shapes[:, 2] == C).all():
        raise ValueError("inconsistent channel counts across objects")
    if target_hw is None:
        target_hw = (int(shapes[:, 0].max()), int(shapes[:, 1].max()))

    def stack(key):
        arrs = [o[key] for o in objs]
        if any(a is None for a in arrs):
            return None
        arrs = [np.asarray(a) for a in arrs]
        # 2-D per-object arrays (the contract's plain (h, w) masks) ride the
        # same packers as (h, w, c) images via a trailing singleton channel.
        # Rank is normalised PER ARRAY so a collection mixing (h, w) and
        # (h, w, 1) masks still packs; the batch squeezes back to (h, w)
        # when every object is effectively single-channel.
        bad = [a.shape for a in arrs if a.ndim not in (2, 3)]
        if bad:
            raise ValueError(
                f"per-object '{key}' arrays must be (h, w) or (h, w, c); "
                f"got shapes {bad[:3]}"
            )
        squeeze = all(a.ndim == 2 for a in arrs)  # mixed ranks → (h, w, 1)
        arrs = [a[:, :, None] if a.ndim == 2 else a for a in arrs]
        cs = {a.shape[2] for a in arrs}
        if len(cs) != 1:
            raise ValueError(
                f"inconsistent channel counts across per-object '{key}' "
                f"arrays: {sorted(cs)}"
            )
        dtypes = {a.dtype for a in arrs}
        if len(dtypes) == 1 and arrs[0].dtype in (np.uint8, np.uint16):
            from tpumcia_torch.io.native import pack_objects

            out = pack_objects(arrs, target_hw)  # the threaded native packer
        else:
            out = np.stack(
                [
                    center_crop_or_pad(a[None], target_hw)[0].numpy()
                    for a in arrs
                ]
            )
        return out[..., 0] if squeeze else out

    images = stack("image")
    masks = stack("mask")

    def meta(key):
        vals = [o[key] for o in objs]
        return np.array(vals) if any(v is not None for v in vals) else None

    channels = next((o["channels"] for o in objs if o["channels"]), None)
    return ObjectBatch(
        images=images,
        masks=masks,
        labels=meta("label"),
        donors=meta("donor"),
        experiments=meta("experiment"),
        channels=channels,
        ids=[o["id"] for o in objs],
    )
