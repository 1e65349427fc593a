"""Seeded noise-channel synthesis on the device (the reference's
``add_two_noise_channels``, ipynb:148-156; counterpart of
``tpumcia.preprocess.synth``).

Channel 1 is the grayscale image, passed through unchanged; each extra
channel is ``clip(N(0, sqrt(var)), 0, 1) * 255`` truncated toward zero, as
the reference's uint8 cast does. The draws come from an explicit
``torch.Generator``: they follow the same distribution as the JAX package's
but are not the same numbers (its threefry stream cannot be reproduced), so
the tests hand both packages the same normal draws. The fused fast path
(:func:`noise_channels_chw`, channels first) and the classic pipeline
(:func:`add_noise_channels_batched`, channels last) draw the same per-batch
stream, so a dataset is the same on either path.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpumcia_torch.utils.device import require_device


def synth_batch_seed(seed: int, batch: int) -> int:
    """The per-batch seed stream that replaces ``synth_batch_keys``: batch
    ``i`` of a run draws from ``torch.Generator(device).manual_seed(
    synth_batch_seed(seed, i))``. Derived with numpy's SeedSequence, so
    neighbouring (seed, batch) pairs give unrelated streams."""
    return int(np.random.SeedSequence([seed, batch]).generate_state(1, np.uint64)[0])


def noise_from_normal(gray: torch.Tensor, normal: torch.Tensor, var: float) -> torch.Tensor:
    """(B, H, W) levels + (B, n, H, W) f32 standard-normal draws ->
    (B, 1 + n, H, W) int32 with the noise channels computed from the draws
    exactly as ``tpumcia.preprocess.synth.noise_channels_chw`` computes its
    own: f32 ``clip(z * sqrt(f32(var)), 0, 1) * 255``, truncated."""
    scale = torch.sqrt(torch.tensor(var, dtype=torch.float32, device=normal.device))
    noise = (torch.clamp(normal * scale, 0.0, 1.0) * 255.0).to(torch.int32)
    return torch.cat([gray[:, None].to(torch.int32), noise], dim=1)


def noise_channels_chw(
    images: torch.Tensor,
    generator: torch.Generator,
    *,
    num_noise: int = 2,
    var: float = 0.01,
) -> torch.Tensor:
    """(B, H, W) grayscale levels -> (B, 1 + num_noise, H, W) int32, the
    noise drawn on ``images``' device from ``generator``."""
    if images.dim() != 3:
        raise ValueError(f"expected (B, H, W) grayscale batch, got {tuple(images.shape)}")
    B, H, W = images.shape
    normal = torch.randn(
        (B, num_noise, H, W), generator=generator, dtype=torch.float32,
        device=images.device,
    )
    return noise_from_normal(images, normal, var)


def add_noise_channels(
    images: torch.Tensor,
    generator: torch.Generator,
    *,
    num_noise: int = 2,
    var: float = 0.01,
) -> torch.Tensor:
    """(B, H, W) grayscale -> (B, H, W, 1 + num_noise) uint8, channels last
    (tpumcia's ``add_noise_channels``): the values of
    :func:`noise_channels_chw` from the same draw."""
    chw = noise_channels_chw(images, generator, num_noise=num_noise, var=var)
    return chw.permute(0, 2, 3, 1).to(torch.uint8)


def add_noise_channels_batched(
    images,
    *,
    seed: int,
    batch_size: int,
    device="cuda",
    num_noise: int = 2,
    var: float = 0.01,
) -> torch.Tensor:
    """(N, H, W) grayscale (numpy or a tensor) -> (N, H, W, 1 + num_noise)
    uint8 on ``device``, drawn per fixed-size batch as the fused fast path
    draws it: batch ``i`` from :func:`synth_batch_seed` ``(seed, i)``, the
    last batch wrap-padded to ``batch_size`` rows with the first images (the
    pad rows' draws are dropped), so both paths synthesize the same data."""
    device = torch.device(require_device(device, "add_noise_channels_batched"))
    gray = images.to(device) if isinstance(images, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(images)).to(device)
    if gray.dim() != 3:
        raise ValueError(f"expected (N, H, W) grayscale input, got {tuple(gray.shape)}")
    n = gray.shape[0]
    batch_size = min(batch_size, n)
    parts = []
    for i in range(math.ceil(n / batch_size)):
        lo, hi = i * batch_size, min((i + 1) * batch_size, n)
        b = gray[lo:hi]
        short = batch_size - (hi - lo)
        if short:
            b = torch.cat([b, gray[:short]])
        gen = torch.Generator(device=device)
        gen.manual_seed(synth_batch_seed(seed, i))
        parts.append(add_noise_channels(b, gen, num_noise=num_noise, var=var)[:hi - lo])
    return torch.cat(parts)
