"""Imaging-flow-cytometry-like masked objects made on the device from the
seed, by the rule of BASELINE config 4 (``config4_cytometry``), quantized to
the cell's levels.

Drawn from a ``torch.Generator`` on the card, block by block: (n, hw, hw,
channels) uint16-range stacks uniform over [0, 65536); on the signal
channel ``v // signal_divisor + label * signal_step``; labels ``i %
classes``; a mask per channel that keeps a pixel where U[0, 1) >
``mask_drop``; donors ``D{i % donors}``, so every donor holds every class.
The levels handed on are ``v * levels // 65536`` (``v >> 8`` at 256
levels, ``v >> 3`` at 8192).
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 2048  # objects made at once
SRC_LEVELS = 65536


def make(params: dict, seed: int, device) -> dict:
    """``params``: ``objects``, ``hw``, ``channels``, ``classes``,
    ``signal_channel``, ``signal_divisor``, ``signal_step``,
    ``mask_channels`` (the channels' count: a mask each), ``mask_drop``,
    ``donors``, ``levels``. Returns the levels ((n, hw, hw, channels) int32
    on ``device``), the (n, hw, hw, channels) bool mask on ``device``, the
    labels and the donors (numpy)."""
    n, hw, ch = params["objects"], params["hw"], params["channels"]
    sig, levels = params["signal_channel"], params["levels"]
    if params["mask_channels"] != ch:
        raise ValueError("the cytometry generator draws one mask per channel")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    labels = torch.arange(n, device=device) % params["classes"]
    images = torch.empty((n, hw, hw, ch), dtype=torch.int32, device=device)
    mask = torch.empty((n, hw, hw, ch), dtype=torch.bool, device=device)
    for s in range(0, n, BLOCK):
        e = min(s + BLOCK, n)
        raw = torch.randint(0, SRC_LEVELS, (e - s, hw, hw, ch), generator=gen, device=device,
                            dtype=torch.int32)
        raw[..., sig] = (torch.div(raw[..., sig], params["signal_divisor"], rounding_mode="floor")
                         + labels[s:e, None, None] * params["signal_step"])
        images[s:e] = torch.div(raw * levels, SRC_LEVELS, rounding_mode="floor")
        mask[s:e] = torch.rand((e - s, hw, hw, ch), generator=gen, device=device) > params["mask_drop"]
    groups = np.array([f"D{i % params['donors']}" for i in range(n)])
    return {"images": images, "labels": labels.cpu().numpy().astype(np.int64),
            "mask": mask, "groups": groups}
