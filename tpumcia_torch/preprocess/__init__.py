"""Noise-channel synthesis and image normalisation (counterpart of
``tpumcia.preprocess``, with its exports)."""

from tpumcia_torch.preprocess.normalize import (
    apply_mask,
    center_crop_or_pad,
    normalize_uint16,
    percentile_normalize,
    quantize_to_levels,
)
from tpumcia_torch.preprocess.synth import add_noise_channels

__all__ = [
    "add_noise_channels",
    "quantize_to_levels",
    "normalize_uint16",
    "percentile_normalize",
    "apply_mask",
    "center_crop_or_pad",
]
