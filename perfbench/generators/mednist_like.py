"""MedNIST-like grayscale images made on the device from the seed.

A rewrite of the port's ``io/synthetic.py::synthetic_mednist`` (numpy, on
the host) that draws from a ``torch.Generator`` on the card in a few large
calls: six class structures (disk, ring, horizontal stripes, checkerboard,
diagonal gradient, cross) with a centre in [0.35, 0.65] of the side, a scale
in [0.8, 1.2], a stripe period in [6, 10) or a checker period in [8, 12),
plus N(0, 12) pixel noise, clipped to [0, 255] and truncated to uint8.
Every seed gives the same number of images of each class, in another order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 2048  # images made at once


def _patterns(cls, cy, cx, scale, period, hw, device):
    """(b,) parameters -> (b, hw, hw) float32 images before the noise."""
    yy = torch.arange(hw, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(hw, device=device, dtype=torch.float32)[None, None, :]
    cy, cx, scale, period = (t[:, None, None] for t in (cy, cx, scale, period))
    r = torch.hypot(yy - cy, xx - cx)
    width = 0.08 * hw * scale
    out = torch.stack([
        (r < 0.28 * hw * scale) * 200.0,
        ((r - 0.3 * hw * scale).abs() < 0.06 * hw) * 220.0,
        (torch.sin(2 * math.pi * yy / period) > 0).expand(-1, -1, hw) * 180.0,
        ((torch.floor(yy / period) + torch.floor(xx / period)) % 2) * 190.0,
        ((yy + xx) / (2 * hw) * 230.0 * scale).expand(-1, hw, hw),
        (((yy - cy).abs() < width) | ((xx - cx).abs() < width)) * 210.0,
    ])  # (6, b, hw, hw)
    return torch.gather(out, 0, cls[None, :, None, None].expand(1, -1, hw, hw))[0]


def make(params: dict, seed: int, device) -> dict:
    """``params``: ``objects``, ``classes``, ``hw``. Returns the images
    ((n, hw, hw) uint8 on ``device``) and their labels (numpy int32)."""
    n, k, hw = params["objects"], params["classes"], params["hw"]
    if n % k:
        raise ValueError(f"{n} images do not split evenly into {k} classes")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    labels = torch.arange(n, device=device) % k
    labels = labels[torch.randperm(n, generator=gen, device=device)]
    u = torch.rand((5, n), generator=gen, device=device)
    cy = (0.35 + 0.3 * u[0]) * hw
    cx = (0.35 + 0.3 * u[1]) * hw
    scale = 0.8 + 0.4 * u[2]
    # the stripes' period in [6, 10), the checkerboard's in [8, 12)
    period = torch.where(labels == 2, 6 + 4 * u[3], 8 + 4 * u[4])
    images = torch.empty((n, hw, hw), dtype=torch.uint8, device=device)
    for s in range(0, n, BLOCK):
        e = min(s + BLOCK, n)
        img = _patterns(labels[s:e], cy[s:e], cx[s:e], scale[s:e], period[s:e], hw, device)
        img += 12.0 * torch.randn((e - s, hw, hw), generator=gen, device=device)
        images[s:e] = img.clamp_(0, 255).to(torch.uint8)
    return {"images": images, "labels": labels.cpu().numpy().astype(np.int32),
            "mask": None, "groups": None}
