"""Preprocessing ops on (B, H, W, C) batches: bit-depth normalisation,
level quantisation, masking, crop/pad (the counterpart of
``tpumcia.preprocess.normalize``, with its semantics):

* ``normalize_uint16`` — v / 65535 -> float32 in [0, 1]
* ``quantize_to_levels`` — any integer/float image -> L integer levels
  (floor quantisation), the input of the feature path
* ``percentile_normalize`` — per-channel robust rescale (clip to a
  percentile window, then [0, 1])
* ``apply_mask`` / ``center_crop_or_pad`` — mask application and shape
  standardisation for variable-size cell objects

Each takes a tensor (on any device) or a numpy array and returns a tensor on
the input's device (a numpy array's goes to the CPU). Integer arithmetic is
int32 and float arithmetic float32, as in the JAX package, so results are
bit-equal to it.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(images) -> torch.Tensor:
    if isinstance(images, torch.Tensor):
        return images
    return torch.from_numpy(np.ascontiguousarray(np.asarray(images)))


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """Any integer or bool tensor -> int32 values. uint16 (16-bit
    microscopy) goes through its int16 bit pattern: torch's CUDA support for
    uint16 covers little beyond copies."""
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(torch.int32) & 0xFFFF
    return x.to(torch.int32)


def _as_float32(x: torch.Tensor) -> torch.Tensor:
    """float32 values, as the JAX package computes (64-bit floats are
    narrowed, integers converted exactly below 2^24)."""
    if x.dtype.is_floating_point:
        return x.to(torch.float32)
    return as_int32(x).to(torch.float32)


def normalize_uint16(images) -> torch.Tensor:
    """(B, H, W, C) uint16 -> float32 in [0, 1], as a product with the f32
    reciprocal of 65535 (what XLA makes of the JAX package's division)."""
    return _as_float32(_tensor(images)) * float(np.float32(1 / 65535))


def quantize_to_levels(images, *, levels: int = 256, src_levels: int | None = None) -> torch.Tensor:
    """Map an image to int32 levels in [0, levels) by floor quantisation.

    * integer input with ``src_levels`` (e.g. 65536 for uint16): level =
      ``v * levels // src_levels`` in int32 (for uint16 -> 256 this is
      ``v >> 8``);
    * float input in [0, 1]: level = ``floor(v * (levels - 1) + 0.5)`` in
      float32 (round-to-nearest of the scaled value).
    """
    if levels < 1:
        raise ValueError(f"levels must be >= 1; got {levels}")
    x = _tensor(images)
    if x.dtype.is_floating_point:
        lev = torch.floor(x.to(torch.float32) * float(levels - 1) + 0.5)
        return lev.clamp(0, levels - 1).to(torch.int32)
    if src_levels is None:
        raise ValueError("src_levels is required for integer inputs")
    v = as_int32(x)
    return torch.div(v * levels, src_levels, rounding_mode="floor").clamp(0, levels - 1).to(torch.int32)


def _percentile(x: torch.Tensor, q: float, dims: tuple[int, ...]) -> torch.Tensor:
    """numpy's linear-interpolation percentile over ``dims`` (kept as size
    1), from a sort: ``torch.quantile`` refuses inputs above 2^24 elements,
    which batch-global percentiles of a real collection exceed."""
    rest = [d for d in range(x.dim()) if d not in dims]
    moved = x.permute(*rest, *dims)
    flat = moved.reshape(*moved.shape[:len(rest)], -1)
    srt = flat.sort(dim=-1).values
    n = srt.shape[-1]
    pos = q / 100.0 * (n - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = float(pos - lo)
    val = srt[..., lo] + frac * (srt[..., hi] - srt[..., lo])
    shape = [1 if d in dims else x.shape[d] for d in range(x.dim())]
    return val.reshape(shape)


def percentile_normalize(images, *, low: float = 1.0, high: float = 99.0, per_image: bool = True) -> torch.Tensor:
    """Per-channel robust normalisation: clip to the [low, high] percentile
    window and rescale to [0, 1]. ``per_image=False`` uses batch-global
    percentiles per channel."""
    x = _as_float32(_tensor(images))
    dims = (1, 2) if per_image else (0, 1, 2)
    lo = _percentile(x, low, dims)
    hi = _percentile(x, high, dims)
    scale = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    return ((x - lo) / scale).clamp(0.0, 1.0)


def apply_mask(images, mask, fill=0) -> torch.Tensor:
    """Zero (or ``fill``) everything outside the mask. Mask is (B, H, W, C)
    or (B, H, W) (broadcast across channels), nonzero selects pixels."""
    x = _tensor(images)
    m = _tensor(mask).to(x.device)
    if m.dim() == x.dim() - 1:
        m = m.unsqueeze(-1)
    return torch.where(m != 0, x, torch.as_tensor(fill, dtype=x.dtype, device=x.device))


def center_crop_or_pad(images, target_hw: tuple[int, int], fill=0) -> torch.Tensor:
    """(B, H, W, C) -> (B, th, tw, C) by symmetric crop and/or pad with
    ``fill``, the split of the JAX package (the odd pixel of a crop or a
    pad goes to the bottom/right)."""
    x = _tensor(images)
    B, H, W, C = x.shape
    th, tw = target_hw
    if H > th:
        top = (H - th) // 2
        x = x[:, top:top + th]
    if W > tw:
        left = (W - tw) // 2
        x = x[:, :, left:left + tw]
    H2, W2 = x.shape[1], x.shape[2]
    if H2 < th or W2 < tw:
        pt = max((th - H2) // 2, 0)
        pl = max((tw - W2) // 2, 0)
        out = x.new_full((B, max(th, H2), max(tw, W2), C), fill)
        out[:, pt:pt + H2, pl:pl + W2] = x
        x = out
    return x
