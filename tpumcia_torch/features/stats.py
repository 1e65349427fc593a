"""The sufficient-statistics contract of the feature set, in torch.

Each (image, channel) is reduced to integer-valued statistics from which
every feature follows (see ``tpumcia.features.stats`` for the derivation):
the raw-level histogram, the GLCM marginals of the rescaled levels, the
difference reductions ``dstats`` and the exact ``sum(G^2)`` limbs of the
co-occurrence matrix G. :class:`SuffStats` has the fields and dtypes that
``tpumcia.features.pallas_glcm._pallas_stats_core`` returns, so the two
packages can be compared field by field. The statistics themselves are
computed in ``cuda_glcm``; :func:`prepare_mask` lays a mask out for it.
:func:`glcm_matrix` gives the co-occurrence matrices themselves, for users
who want them (the feature path never builds them).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from tpumcia_torch.utils.device import require_device


class SuffStats(NamedTuple):
    """Per-(image, channel) sufficient statistics. Leading dims (B, C)."""

    hist: torch.Tensor  # (B, C, L) f32   raw-level histogram
    count: torch.Tensor  # (B, C) f32     number of pixels
    vmax: torch.Tensor  # (B, C) i32      max raw level
    marg_l: torch.Tensor  # (B, C, L) f32 GLCM left marginal (rescaled levels)
    marg_r: torch.Tensor  # (B, C, L) f32 GLCM right marginal
    diff_hist: torch.Tensor | None  # (B, C, 2L-1) f32 histogram of i-j+L-1,
    #                                 or None when dstats carries its sums
    glcm_sumsq: torch.Tensor  # (B, C, 4) i32 limbs of sum(G^2)
    pair_count: torch.Tensor  # (B, C) f32  number of valid pixel pairs
    dstats: torch.Tensor | None = None  # (B, C, 4) f32: [sum G*(d^2>>8),
    #   sum G*(d^2&255), sum G*|d|, sum G/(1+d^2)] with d = i-j; under the
    #   cheap gate the first two are [T>>8, T&255] of T = sum G*d^2. Either
    #   way s_d2 = 256*w0 + w1 exactly.


@functools.lru_cache(maxsize=8)
def rescale_lut(levels: int = 256) -> np.ndarray:
    """(levels, levels) int32 LUT of the reference's GLCM rescale (a copy of
    ``tpumcia.features.stats.rescale_lut``).

    ``LUT[m, v]`` is the uint8 level the reference assigns to raw level ``v``
    in a channel whose max raw level is ``m``: the notebook computes
    ``(ch/255) / (ch.max()/255) * 255`` in float64 and truncates with
    ``astype(uint8)`` (ipynb:293-295), replicated bit for bit here. Row 0 (an
    all-zero channel, where the reference divides 0/0) is all zeros; callers
    flag it as degenerate.
    """
    top = float(levels - 1)
    vals = np.arange(levels, dtype=np.float64) / top
    with np.errstate(divide="ignore", invalid="ignore"):
        scaled = (vals[None, :] / vals[:, None]) * top
    lut = np.clip(np.nan_to_num(scaled, nan=0.0, posinf=top), 0.0, top)
    lut = lut.astype(np.uint8 if levels <= 256 else np.int32).astype(np.int32)
    lut[0, :] = 0
    return lut


@functools.lru_cache(maxsize=16)
def rescale_lut_device(levels: int = 256, device="cuda") -> torch.Tensor:
    """Cached copy of :func:`rescale_lut` on ``device`` (one upload per
    process, not one per batch)."""
    require_device(device, "rescale_lut_device")
    return torch.from_numpy(rescale_lut(levels)).to(device)


# above this many levels no L x L rescale table is built on any device (256
# MB at 8192 levels, 4 GB at 32768): rescale_rows_for computes the rows asked for
MAX_TABLE_LEVELS = 4096


def rescale_rows(levels: int, vmax: torch.Tensor) -> torch.Tensor:
    """The rows ``rescale_lut(levels)[clamp(vmax, 0, levels - 1)]`` as a
    (..., levels) int32 tensor on ``vmax``'s device, without the table: each
    entry in float64 and in :func:`rescale_lut`'s order of operations,
    ``trunc(((v/top) / (m/top)) * top)`` clipped to [0, top], so it equals
    the table's (every step is one IEEE operation on either device; row 0 is
    all zeros; the table's uint8 cast at <= 256 levels truncates values
    already clipped to [0, 255], as the int32 cast here does)."""
    top = float(levels - 1)
    m = vmax.clamp(0, levels - 1)
    # divide by a tensor: on a CUDA device PyTorch turns tensor / Python
    # scalar into a product with the reciprocal, which rounds differently
    top_t = torch.tensor(top, dtype=torch.float64, device=vmax.device)
    vals = torch.arange(levels, dtype=torch.float64, device=vmax.device) / top_t
    scaled = (vals / vals[m.to(torch.int64)][..., None]) * top
    rows = torch.nan_to_num(scaled, nan=0.0, posinf=top).clamp_(0.0, top).to(torch.int32)
    return torch.where((m > 0)[..., None], rows, 0)


def rescale_rows_for(levels: int, vmax: torch.Tensor) -> torch.Tensor:
    """``rescale_lut(levels)[clamp(vmax)]`` as int32 rows on ``vmax``'s
    device: from the cached table up to :data:`MAX_TABLE_LEVELS` levels,
    computed by :func:`rescale_rows` above."""
    if levels > MAX_TABLE_LEVELS:
        return rescale_rows(levels, vmax)
    return rescale_lut_device(levels, vmax.device)[vmax.clamp(0, levels - 1).to(torch.int64)]


def on_device(a, device) -> torch.Tensor:
    """A tensor (moved) or an array-like (copied) on ``device``."""
    return a.to(device) if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a), device=device)


def prepare_mask(mask, images_shape, device) -> torch.Tensor:
    """The counterpart of ``tpumcia.features.stats._prep_inputs``' mask
    half: a (B, H, W) mask shared by every channel, or a (B, H, W, C) mask
    (numpy, a nested sequence or a tensor; nonzero selects a pixel) ->
    a contiguous (B, C_m, H, W) uint8 plane on ``device`` with ``C_m`` 1 for
    a shared mask (never copied C-fold) and C otherwise. ``images_shape``
    is the (B, H, W, C) shape of the images it masks."""
    m = mask if isinstance(mask, torch.Tensor) else np.asarray(mask)
    check_mask_shape(m, images_shape)
    if isinstance(m, torch.Tensor):
        m = (m != 0).to(torch.uint8).to(device)
    else:
        m = torch.from_numpy((m != 0).astype(np.uint8)).to(device)
    return mask_plane(m)


def check_mask_shape(mask, images_shape) -> None:
    """Raise unless ``mask`` has the (B, H, W, C) ``images_shape`` or its
    per-object (B, H, W)."""
    mshape, ishape = tuple(np.shape(mask)), tuple(images_shape)
    if mshape not in (ishape, ishape[:3]):
        raise ValueError(
            f"mask shape {mshape} must equal the images' {ishape} or "
            f"per-object {ishape[:3]}"
        )


def mask_plane(m: torch.Tensor) -> torch.Tensor:
    """A binarized (B, H, W) or (B, H, W, C) uint8 mask -> the kernel's
    contiguous (B, 1 or C, H, W) plane."""
    m = m.unsqueeze(1) if m.dim() == 3 else m.permute(0, 3, 1, 2)
    return m.contiguous()


def cheap_limbs(hw: int, levels: int) -> bool:
    """The gate of the cheap ``sum(G^2)`` / ``dstats`` encoding, the same as
    ``tpumcia.features.stats`` (hw <= 4096 and levels <= 256) and
    ``pallas_glcm._kernel``: every pair count is then <= 2^12, so
    ``sum(G^2) <= 2^24`` is exact in one pass. The two encodings reassemble
    to the same value but their limbs differ, so the gate must match for the
    integer fields to be bit-equal."""
    return hw <= 4096 and levels <= 256


def glcm_sumsq_limbs(glcm: torch.Tensor, cheap: bool) -> torch.Tensor:
    """(..., L*L) integer co-occurrence counts -> (..., 4) int32 limbs of
    ``sum(G^2)``. Generic: with ``g = a*2^12 + b``,
    ``sum(g^2) = 2^24*sum(a^2) + 2^13*sum(a*b) + 2^8*sum(b^2>>8)
    + sum(b^2&255)``; cheap: ``[0, 0, s2>>8, s2&255]``."""
    g = glcm.to(torch.int64)
    if cheap:
        s2 = (g * g).sum(-1)
        z = torch.zeros_like(s2)
        limbs = [z, z, s2 >> 8, s2 & 255]
    else:
        a, b = g >> 12, g & 4095
        bb = b * b
        limbs = [
            (a * a).sum(-1), (a * b).sum(-1), (bb >> 8).sum(-1), (bb & 255).sum(-1)
        ]
    return torch.stack(limbs, -1).to(torch.int32)


def glcm_sumsq_value(limbs, xp=None, dtype=None):
    """Reassemble the (.., 4) limbs into ``sum(G^2)`` (tpumcia's positional
    order): with ``xp`` numpy (the default for anything but a tensor) a
    float64 array (exact), or ``dtype``; with ``xp`` torch (the default for
    a tensor) a float32 tensor, or ``dtype``."""
    if xp is None:
        xp = torch if isinstance(limbs, torch.Tensor) else np
    if xp is torch:
        s = torch.as_tensor(limbs).to(dtype or torch.float32)
    else:
        host = limbs.cpu().numpy() if isinstance(limbs, torch.Tensor) else np.asarray(limbs)
        s = host.astype(dtype or np.float64)
    return (
        s[..., 0] * 16777216.0
        + s[..., 1] * 8192.0
        + s[..., 2] * 256.0
        + s[..., 3]
    )


def disable_fields(st: SuffStats, *, with_intensity: bool = True, with_glcm: bool = True) -> SuffStats:
    """tpumcia's ``with_intensity=False`` and ``with_glcm=False``: the
    fields each turns off, zeroed (``hist``; the marginals, the difference
    histogram or ``dstats``, the ``sum(G^2)`` limbs and the pair count).
    ``count`` and ``vmax`` stay."""
    if not with_intensity:
        st = st._replace(hist=torch.zeros_like(st.hist))
    if not with_glcm:
        z = torch.zeros_like
        st = st._replace(
            marg_l=z(st.marg_l), marg_r=z(st.marg_r), glcm_sumsq=z(st.glcm_sumsq),
            pair_count=z(st.pair_count),
            diff_hist=None if st.diff_hist is None else z(st.diff_hist),
            dstats=None if st.dstats is None else z(st.dstats),
        )
    return st


def _stats_level(images, mask, *, levels, offsets, device, what) -> tuple[SuffStats, ...]:
    """(B, H, W, C) levels and tpumcia's raw mask -> the difference-histogram
    contract of ``cuda_glcm.sufficient_stats_multi`` on ``device``."""
    from tpumcia_torch.features import cuda_glcm
    from tpumcia_torch.features.extract import _as_level_array, _chw_levels, _to_device

    device = torch.device(require_device(device, what))
    rows = _as_level_array(images, levels)
    if rows.ndim != 4:
        raise ValueError(f"expected (B, H, W, C) images, got shape {tuple(rows.shape)}")
    m = None if mask is None else prepare_mask(mask, rows.shape, device)
    return cuda_glcm.sufficient_stats_multi(
        _chw_levels(_to_device(rows, device)), m, levels=levels, offsets=offsets, need_diff=True,
    )


def sufficient_stats(
    images,
    mask=None,
    *,
    levels: int = 256,
    offset: tuple[int, int] = (0, 5),
    chunk_size: int = 32,
    onehot_dtype: str = "bfloat16",
    with_intensity: bool = True,
    with_glcm: bool = True,
    device="cuda",
) -> SuffStats:
    """Per-(image, channel) sufficient statistics, tpumcia's stats-level
    call: (B, H, W, C) levels in [0, levels) and an optional (B, H, W) or
    (B, H, W, C) mask (nonzero selects a pixel; a pair needs both) ->
    :class:`SuffStats` with the difference histogram (kernel form B1c on a
    CUDA device; B1d or B1e at their sizes). ``chunk_size`` and
    ``onehot_dtype`` are tpumcia's XLA memory knobs: the kernel has no
    counterpart, so they are ignored. ``with_intensity`` / ``with_glcm``
    zero the fields they turn off (:func:`disable_fields`)."""
    # without the GLCM fields the offset is not used: (0, 0) fits any image,
    # as tpumcia then accepts any offset
    (st,) = _stats_level(
        images, mask, levels=levels, offsets=[tuple(offset) if with_glcm else (0, 0)],
        device=device, what="sufficient_stats",
    )
    return disable_fields(st, with_intensity=with_intensity, with_glcm=with_glcm)


def sufficient_stats_multi(
    images,
    mask=None,
    *,
    levels: int = 256,
    offsets: tuple[tuple[int, int], ...] = ((0, 5),),
    chunk_size: int = 32,
    onehot_dtype: str = "bfloat16",
    with_intensity: bool = True,
    device="cuda",
) -> tuple[SuffStats, ...]:
    """:func:`sufficient_stats` for several offsets in one pass (kernel form
    B2 on a CUDA device): one :class:`SuffStats` per offset, the intensity
    histogram on the first only (the others' ``hist`` zero), as tpumcia
    returns them."""
    out = _stats_level(
        images, mask, levels=levels, offsets=[tuple(o) for o in offsets],
        device=device, what="sufficient_stats_multi",
    )
    out = [st if i == 0 else st._replace(hist=torch.zeros_like(st.hist)) for i, st in enumerate(out)]
    return tuple(disable_fields(st, with_intensity=with_intensity) for st in out)


def glcm_matrix(
    images,
    mask=None,
    *,
    levels: int = 256,
    offset=(0, 5),
    distances=None,
    angles=None,
    symmetric: bool = False,
    normed: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Co-occurrence matrices as float32 exact counts on ``device``
    (tpumcia's ``glcm_matrix``, ``skimage.feature.graycomatrix``'s API with
    its ``symmetric`` and ``normed`` options), after the reference's
    per-channel max rescale (ipynb:293-298). ``images``: (B, H, W, C) levels
    in [0, levels) (a level outside counts as level 0 after the rescale, as
    in tpumcia); ``mask``: optional (B, H, W) or (B, H, W, C), a pair counts
    when both of its pixels are selected.

    - ``offset=(dr, dc)`` -> (B, C, L, L);
    - ``distances=[...], angles=[...]`` (the reference's call, ipynb:298)
      -> (B, C, L, L, D, A), one matrix per (distance, angle) at
      ``(round(d sin a), round(d cos a))``.

    An offset that leaves the image gives a zero matrix. Counts are summed
    as integers (``bincount`` of ``left * L + right``) and cast to float32.
    """
    list_api = distances is not None or angles is not None
    if list_api:
        distances = tuple(distances if distances is not None else (5,))
        angles = tuple(angles if angles is not None else (0.0,))
        offsets = [
            (int(round(math.sin(a) * d)), int(round(math.cos(a) * d)))
            for d in distances for a in angles
        ]
    else:
        offsets = [tuple(offset)]
    x = on_device(images, require_device(device, "glcm_matrix"))
    if x.dim() != 4:
        raise ValueError(f"expected (B, H, W, C) images, got shape {tuple(x.shape)}")
    from tpumcia_torch.preprocess.normalize import as_int32

    B, H, W, C = x.shape
    img = as_int32(x.permute(0, 3, 1, 2)).to(torch.int64)  # (B, C, H, W)
    if mask is None:
        valid = torch.ones((B, 1, H, W), dtype=torch.bool, device=img.device)
    else:
        valid = prepare_mask(mask, x.shape, img.device) > 0
    valid = valid.expand(B, C, H, W)
    L = levels
    vmax = torch.where(valid, img, -1).amax((2, 3))
    rows = rescale_rows_for(L, vmax).to(torch.int64)  # (B, C, L)
    inside = (img >= 0) & (img < L)
    resc = torch.gather(rows, 2, img.clamp(0, L - 1).flatten(2)).view(B, C, H, W)
    resc = torch.where(inside, resc, 0)
    cell = torch.arange(B * C, device=img.device).view(B, C, 1, 1) * (L * L)
    out = torch.zeros((B, len(offsets), C, L, L), dtype=torch.float32, device=img.device)
    for o, (dr, dc) in enumerate(offsets):
        r0, r1 = max(0, -dr), H - max(0, dr)
        c0, c1 = max(0, -dc), W - max(0, dc)
        if r0 >= r1 or c0 >= c1:
            continue  # no pair inside the image: a zero matrix
        left = resc[:, :, r0:r1, c0:c1]
        right = resc[:, :, r0 + dr:r1 + dr, c0 + dc:c1 + dc]
        pair = valid[:, :, r0:r1, c0:c1] & valid[:, :, r0 + dr:r1 + dr, c0 + dc:c1 + dc]
        key = (cell + left * L + right)[pair]
        g = torch.bincount(key, minlength=B * C * L * L).view(B, C, L, L).to(torch.float32)
        if symmetric:
            g = g + g.transpose(-1, -2)
        if normed:
            total = g.sum((-1, -2), keepdim=True)
            g = g / torch.where(total == 0, 1.0, total)
        out[:, o] = g
    if not list_api:
        return out[:, 0]
    out = out.permute(0, 2, 3, 4, 1)  # (B, C, L, L, O)
    return out.reshape(B, C, L, L, len(distances), len(angles))
