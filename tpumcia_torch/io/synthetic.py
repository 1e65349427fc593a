"""Synthetic datasets for tests and benchmarks (counterpart of
``tpumcia.io.synthetic``: ``synthetic_mednist`` is a numpy copy,
``synthetic_multichannel`` draws its noise channels on a device).

The reference demonstrates on MedNIST (12 000 images, 6 classes, 64x64
grayscale — ipynb:70-73) downloaded from Dropbox; this environment has no
egress, so benchmarks and integration tests use a seeded synthetic stand-in
with 6 visually distinct class structures (disk / ring / stripes / checker /
gradient / cross) whose intensity and texture statistics separate the classes
the same way the MedNIST modalities do.
"""

from __future__ import annotations

import numpy as np

CLASS_NAMES = ("disk", "ring", "stripesH", "checker", "gradient", "cross")


def _pattern(cls: int, hw: int, rng: np.random.Generator) -> np.ndarray:
    yy, xx = np.mgrid[:hw, :hw]
    cy, cx = rng.uniform(0.35 * hw, 0.65 * hw, size=2)
    r = np.hypot(yy - cy, xx - cx)
    scale = rng.uniform(0.8, 1.2)
    if cls == 0:  # disk
        img = (r < 0.28 * hw * scale) * 200.0
    elif cls == 1:  # ring
        img = (np.abs(r - 0.3 * hw * scale) < 0.06 * hw) * 220.0
    elif cls == 2:  # horizontal stripes
        period = rng.uniform(6, 10)
        img = (np.sin(2 * np.pi * yy / period) > 0) * 180.0
    elif cls == 3:  # checkerboard
        period = rng.uniform(8, 12)
        img = (((yy // period) + (xx // period)) % 2) * 190.0
    elif cls == 4:  # diagonal gradient
        img = (yy + xx) / (2 * hw) * 230.0 * scale
    else:  # cross
        w = 0.08 * hw * scale
        img = (
            (np.abs(yy - cy) < w) | (np.abs(xx - cx) < w)
        ) * 210.0
    img = img + rng.normal(0, 12, size=(hw, hw))
    return np.clip(img, 0, 255).astype(np.uint8)


def synthetic_mednist(
    n_per_class: int,
    *,
    num_classes: int = 6,
    hw: int = 64,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """-> (images (N, hw, hw) uint8, labels (N,) int, class_names)."""
    if num_classes > len(CLASS_NAMES):
        raise ValueError(f"at most {len(CLASS_NAMES)} classes")
    if n_per_class < 1 or num_classes < 1:
        raise ValueError(
            f"synthetic data needs n_per_class >= 1 and num_classes >= 1; "
            f"got n_per_class={n_per_class}, num_classes={num_classes}"
        )
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for cls in range(num_classes):
        for _ in range(n_per_class):
            images.append(_pattern(cls, hw, rng))
            labels.append(cls)
    order = rng.permutation(len(images))
    images = np.stack(images)[order]
    labels = np.asarray(labels, np.int32)[order]
    return images, labels, list(CLASS_NAMES[:num_classes])


def synthetic_multichannel(
    n_per_class: int,
    *,
    device="cuda",
    num_classes: int = 6,
    hw: int = 64,
    num_noise: int = 2,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Synthetic MedNIST + the reference's noise-channel synthesis: channel 1
    carries the class signal, the rest are clipped gaussian noise — the setup
    whose ground-truth channel ranking (Ch1 first) the importance pipeline
    must recover (markdown cells 24/27 of the notebook). The noise is drawn
    on ``device`` from a ``torch.Generator`` seeded with ``seed``: channel 1
    equals tpumcia's bit for bit, the noise channels follow the same
    distribution from another stream.

    -> (images (N, hw, hw, 1 + num_noise) uint8, labels, class_names)
    """
    import torch

    from tpumcia_torch.preprocess.synth import add_noise_channels
    from tpumcia_torch.utils.device import require_device

    require_device(device, "synthetic_multichannel")
    gray, labels, class_names = synthetic_mednist(
        n_per_class, num_classes=num_classes, hw=hw, seed=seed
    )
    device = torch.device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    out = add_noise_channels(
        torch.from_numpy(gray).to(device), generator, num_noise=num_noise
    )
    return out.cpu().numpy(), labels, class_names
