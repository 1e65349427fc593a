"""Per-channel morphology statistics from object masks (counterpart of
``tpumcia.features.morphology``).

The reference computes no morphology (its h5 contract merely carries masks,
README.md:9), so these semantics are the framework's: the image-moment shape
descriptors (skimage.measure.regionprops conventions) of each channel's mask
region, computed as weighted reductions on the device. The sums are taken
in float64 and the features returned as float32: the orientation of a
near-round region is the angle of two small differences of moments, which
f32 sums in another order (the card's, the CPU's) would move.

Features (suffix ``_Ch{i}`` like the rest of the registry):
  area             pixel count of the mask
  centroid_row/col center of mass (pixels)
  major_axis       ellipse-equivalent major axis length
  minor_axis       minor axis length
  eccentricity     sqrt(1 - minor/major ratio of the covariance eigenvalues)
  orientation      ellipse orientation, radians in (-pi/2, pi/2]
  extent           area / bounding-box area

Empty masks give zeros, and a single pixel an eccentricity of 0.
"""

from __future__ import annotations

import torch

from tpumcia_torch.features.stats import on_device
from tpumcia_torch.utils.device import require_device

MORPHOLOGY_FEATURES: tuple[str, ...] = (
    "area",
    "centroid_row",
    "centroid_col",
    "major_axis",
    "minor_axis",
    "eccentricity",
    "orientation",
    "extent",
)


def morphology_features(mask, *, device="cuda") -> torch.Tensor:
    """(B, H, W, C) or (B, H, W) mask (numpy or a tensor; nonzero selects a
    pixel) -> (B, C, 8) float32 shape features on ``device``; a (B, H, W)
    mask gives C = 1."""
    m = on_device(mask, require_device(device, "morphology_features"))
    if m.dim() == 3:
        m = m[..., None]
    w = (m != 0).permute(0, 3, 1, 2).to(torch.float64)  # (B, C, H, W)
    H, W = w.shape[2], w.shape[3]
    rows = torch.arange(H, dtype=torch.float64, device=w.device)[:, None]
    cols = torch.arange(W, dtype=torch.float64, device=w.device)[None, :]

    area = w.sum((2, 3))
    safe = torch.clamp(area, min=1.0)
    empty = area == 0
    cr = (w * rows).sum((2, 3)) / safe
    cc = (w * cols).sum((2, 3)) / safe
    dr = rows - cr[..., None, None]
    dc = cols - cc[..., None, None]
    # raw discrete central moments (regionprops adds 1/12 per pixel; the
    # JAX package documents the divergence)
    mu20 = (w * dr * dr).sum((2, 3)) / safe
    mu02 = (w * dc * dc).sum((2, 3)) / safe
    mu11 = (w * dr * dc).sum((2, 3)) / safe

    common = torch.sqrt(torch.clamp((mu20 - mu02) ** 2 + 4 * mu11 ** 2, min=0.0))
    l1 = (mu20 + mu02 + common) / 2.0
    l2 = torch.clamp((mu20 + mu02 - common) / 2.0, min=0.0)
    major = 4.0 * torch.sqrt(torch.clamp(l1, min=0.0))
    minor = 4.0 * torch.sqrt(l2)
    # a single pixel (l1 == 0) is round: eccentricity 0
    ecc = torch.where(
        l1 <= 0.0, 0.0, torch.sqrt(torch.clamp(1.0 - l2 / torch.clamp(l1, min=1e-12), 0.0, 1.0))
    )
    orientation = 0.5 * torch.atan2(2.0 * mu11, mu20 - mu02)

    on = w > 0
    r_idx = torch.arange(H, device=w.device)
    c_idx = torch.arange(W, device=w.device)
    row_any, col_any = on.any(3), on.any(2)
    r_min = torch.where(row_any, r_idx, H).amin(-1)
    r_max = torch.where(row_any, r_idx, -1).amax(-1)
    c_min = torch.where(col_any, c_idx, W).amin(-1)
    c_max = torch.where(col_any, c_idx, -1).amax(-1)
    bbox = torch.clamp((r_max - r_min + 1) * (c_max - c_min + 1), min=1).to(torch.float64)
    extent = area / bbox

    feats = torch.stack([area, cr, cc, major, minor, ecc, orientation, extent], dim=-1)
    return torch.where(empty[..., None], 0.0, feats).to(torch.float32)


def morphology_feature_names(num_channels: int, channel_names: list[str] | None = None) -> list[str]:
    def suffix(c):
        return f"_{channel_names[c]}" if channel_names else f"_Ch{c + 1}"

    return [f + suffix(c) for c in range(num_channels) for f in MORPHOLOGY_FEATURES]
