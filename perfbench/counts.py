"""The yardstick's own counts: bytes and operations a call must move and do,
computed from a cell's shapes, and the card's published peaks.

Frozen copies of sound rules, so that a change to the program cannot move
what it is measured against: ``glcm_launch_bytes`` is the byte rule of the
GLCM statistics kernel (the port's ``features.cuda_glcm.traffic_bytes``, as
``bench_torch.py`` copied it), ``head_flops`` and ``sweep_flops`` the logistic
head's and the permutation sweeps' matrix products, and ``flops_peak`` the
peak of the precision the head runs in.
"""

from __future__ import annotations

import math

# one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet, dense rates)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
FEATURES_PER_CHANNEL = 23


def glcm_launch_bytes(shape, levels: int, num_offsets: int, *, mask_channels: int = 0,
                      need_diff: bool = False) -> int:
    """The bytes one GLCM statistics launch must move, each input read once
    and each output written once: the int32 levels, the (B, mask_channels,
    H, W) uint8 mask and one rescale-table row of L int32 per (image,
    channel) up to L rows (none past 4096 levels) in; the histogram, count
    and vmax, and per offset both marginals, the difference histogram (2L-1
    bins) or dstats (4 words), 4 limbs and the pair count out, 4 bytes each."""
    B, C, H, W = shape
    n = B * C
    table = 0 if levels > 4096 else 4 * levels * min(n, levels)
    read = 4 * n * H * W + B * mask_channels * H * W + table
    written = 4 * n * (levels + 2)
    per_offset = 4 * n * (2 * levels + (2 * levels - 1 if need_diff else 4) + 4 + 1)
    return read + written + num_offsets * per_offset


def glcm_call_bytes(n: int, batch: int, channels: int, hw: int, levels: int, *,
                    mask_channels: int, need_diff: bool) -> int:
    """Over one call's launches, each at its real batch (the last one holds
    what is left; the wrapper pads it, and the padding is not counted).
    ``mask_channels``: 0 without a mask, 1 for a mask shared by the
    channels, the channels' count for a mask each."""
    b = min(batch, n)
    return sum(glcm_launch_bytes((min(b, n - s), channels, hw, hw), levels, 1,
                                 mask_channels=mask_channels, need_diff=need_diff)
               for s in range(0, n, b))


def glcm_launches(n: int, batch: int) -> int:
    return math.ceil(n / min(batch, n))


def head_flops(n_train: int, features: int, classes: int, steps: int) -> int:
    """The logistic head's matrix products: per full-batch Adam step the
    logits X @ W and the weight gradient X^T @ dlogits, 2 n F K each (the
    features take no gradient)."""
    return 4 * n_train * features * classes * steps


def sweep_flops(n_test: int, features: int, classes: int, groups: int, repeats: int) -> int:
    """Both permutation sweeps: one forward pass (2 n F K) over the test rows
    per (group, repeat) and per (feature, repeat), two baselines and the
    test predictions."""
    return 2 * n_test * features * classes * ((groups + features) * repeats + 3)


def flops_peak(tf32: bool) -> float:
    """The peak of the head's precision: float32 outside the tensor cores
    unless TF32 is on for matrix products."""
    return TF32_FLOPS_PER_S if tf32 else FP32_FLOPS_PER_S
