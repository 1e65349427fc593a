"""MedNIST-style folder indexing and image loading (numpy; a copy of
``tpumcia.io.mednist``).

Mirrors the reference's dataset indexer (cell 5, ipynb:63-97): a root
directory with one subdirectory per class; ``class_names`` is the sorted
subdirectory list, ``image_file_list`` the flat file list, labels the class
indices. Decoding uses imageio (libpng) on host — decode stays on CPU, the
uint8 tensor is what goes to device (SURVEY.md §2.2).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class FolderIndex:
    class_names: list[str]
    files: list[Path]
    labels: np.ndarray  # (N,) int32

    def __len__(self):
        return len(self.files)


def index_image_folder(root: str | Path, extensions=(".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")) -> FolderIndex:
    root = Path(root)
    class_names = sorted(
        d.name for d in root.iterdir() if d.is_dir()
    )
    if not class_names:
        raise FileNotFoundError(f"no class subdirectories under {root}")
    files: list[Path] = []
    labels: list[int] = []
    for ci, cname in enumerate(class_names):
        cfiles = sorted(
            p for p in (root / cname).iterdir()
            if p.suffix.lower() in extensions
        )
        files.extend(cfiles)
        labels.extend([ci] * len(cfiles))
    return FolderIndex(
        class_names=class_names,
        files=files,
        labels=np.asarray(labels, np.int32),
    )


def load_images(files, *, num_threads: int = 8) -> np.ndarray:
    """Decode a list of image files into a stacked (N, H, W[, C]) array using
    a host thread pool (decode is the only stage that stays on CPU)."""
    from concurrent.futures import ThreadPoolExecutor

    import imageio.v3 as iio

    def decode(p):
        return np.asarray(iio.imread(p))

    with ThreadPoolExecutor(max_workers=num_threads) as ex:
        arrs = list(ex.map(decode, files))
    return np.stack(arrs)
