"""Sufficient statistics -> the reference feature values (the counterpart
of ``tpumcia.features.finalize``), by three backends of
:func:`finalize_features`:

- ``'device'``: float32 torch on the statistics' device (:func:`_finalize`,
  tpumcia's ``_finalize`` with ``xp=jnp, dtype=float32``). This is also the
  device-resident feature block that the head and the permutation sweeps
  read. It takes the ``dstats`` contract or the difference histogram.
- ``'host'``: the statistics are copied to the host (narrowed losslessly to
  16 bits) and finalised in numpy float64 (:func:`_host_finalize`, a copy
  of tpumcia's ``_finalize`` with ``xp=np``), from ``dstats`` or from the
  difference histogram: the exact backend (< 1e-9 against the notebook).
- ``'hybrid'``: ``hybrid.finalize_hybrid``, the u32 wire (the packed f32
  wire above 256 levels) assembled in float64.

Feature order matches ``registry``: 17 intensity features x channel, then 6
GLCM features x channel. The reference quirks are kept: percentiles at
q = 0.1..0.9 (ipynb:242-250), NaN skew/kurtosis for a zero-variance
channel, and an all-zero channel or an empty mask flagged degenerate.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from tpumcia_torch.features.stats import SuffStats, glcm_sumsq_value

_QS = np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9])


class FinalizedFeatures(NamedTuple):
    values: Any  # (B, F) np.ndarray (host assembly) or torch.Tensor (device)
    degenerate: Any  # (B, C) bool: empty or all-zero channel


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none), as argmax
    over a bool axis gives in numpy/JAX (torch's argmax rejects bool)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _intensity_block(hist: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """(B, C, L) histogram + (B, C) count -> (B, C, 17) f32 features."""
    f32 = torch.float32
    dev = hist.device
    L = hist.shape[-1]
    top = float(L - 1)
    lev = torch.arange(L, device=dev).to(f32)
    n = count.to(f32)
    safe_n = torch.clamp(n, min=1)
    empty = n == 0

    nz = hist > 0
    min_lev = _first_true(nz).to(f32)
    max_lev = (L - 1) - _first_true(nz.flip(-1)).to(f32)
    min_v = torch.where(empty, 0, min_lev / top)
    max_v = torch.where(empty, 0, max_lev / top)

    # numpy-linear-interpolated percentiles from the exact CDF at the
    # reference's q = 0.1..0.9
    cdf = torch.cumsum(hist.to(f32), dim=-1)
    qs = torch.as_tensor(_QS, device=dev).to(f32)
    pos = qs[None, None, :] / 100.0 * (safe_n[..., None] - 1)
    k_lo = torch.floor(pos)
    k_hi = torch.ceil(pos)
    frac = pos - k_lo

    def value_at(k):  # (B, C, 9) sorted-order index -> level index
        return (cdf[:, :, None, :] <= k[..., None]).sum(-1).to(f32)

    v_lo = value_at(k_lo)
    v_hi = value_at(k_hi)
    pct = (v_lo + frac * (v_hi - v_lo)) / top
    pct = torch.where(empty[..., None], 0, pct)

    hist_d = hist.to(f32)
    total = (hist_d * lev).sum(-1) / top
    mean = total / safe_n
    dev_ = lev[None, None, :] / top - mean[..., None]
    dev2 = dev_ * dev_
    hd2 = hist_d * dev2
    m2 = hd2.sum(-1) / safe_n
    m3 = (hd2 * dev_).sum(-1) / safe_n
    m4 = (hd2 * dev2).sum(-1) / safe_n
    std = torch.sqrt(m2)
    # zero variance detected exactly (one occupied level), not by m2 == 0
    # alone: the rounded f32 mean can leave m2 = O(eps) on a constant channel
    zero_var = (min_lev == max_lev) | (m2 == 0)
    safe_m2 = torch.where(zero_var, 1, m2)
    nan = torch.full_like(m2, float("nan"))
    kurt = torch.where(zero_var, nan, m4 / (safe_m2 * safe_m2) - 3.0)
    skew = torch.where(zero_var, nan, m3 / safe_m2**1.5)

    p = hist_d / safe_n[..., None]
    plogp = torch.where(p > 0, p * torch.log2(torch.where(p > 0, p, 1)), 0)
    entropy = -plogp.sum(-1)

    def z(a):
        return torch.where(empty, 0, a)

    return torch.stack(
        [min_v]
        + [pct[..., i] for i in range(9)]
        + [max_v, z(total), z(mean), z(std), z(kurt), z(skew), z(entropy)],
        dim=-1,
    )


def _glcm_block(marg_l, marg_r, diff_hist, sumsq, npairs, dstats) -> torch.Tensor:
    """GLCM sufficient stats -> (B, C, 6) f32 [contrast, dissimilarity,
    homogeneity, ASM, energy, correlation], skimage ``graycoprops``
    semantics (ipynb:301-306), from the kernel's ``dstats`` reductions or,
    when they are None, from the difference histogram."""
    f32 = torch.float32
    L = marg_l.shape[-1]
    i = torch.arange(L, device=marg_l.device).to(f32)
    i2 = i * i

    N = npairs.to(f32)
    safe_N = torch.clamp(N, min=1)
    ml = marg_l.to(f32)
    mr = marg_r.to(f32)
    Pl = ml / safe_N[..., None]
    Pr = mr / safe_N[..., None]

    if dstats is not None:
        ds = dstats.to(f32)
        s_d2 = 256.0 * ds[..., 0] + ds[..., 1]
        contrast = s_d2 / safe_N
        dissimilarity = ds[..., 2] / safe_N
        homogeneity = ds[..., 3] / safe_N
    else:
        d = torch.arange(2 * L - 1, device=marg_l.device).to(f32) - (L - 1)
        d2 = d * d
        dh = diff_hist.to(f32)
        Pd = dh / safe_N[..., None]
        contrast = (Pd * d2).sum(-1)
        dissimilarity = (Pd * d.abs()).sum(-1)
        homogeneity = (Pd / (1.0 + d2)).sum(-1)
        s_d2 = dh @ d2
    asm = glcm_sumsq_value(sumsq, dtype=f32) / (safe_N * safe_N)
    energy = torch.sqrt(asm)

    mu_i = (i * Pl).sum(-1)
    mu_j = (i * Pr).sum(-1)
    di = i[None, None, :] - mu_i[..., None]
    dj = i[None, None, :] - mu_j[..., None]
    var_i = (Pl * di * di).sum(-1)
    var_j = (Pr * dj * dj).sum(-1)
    std_i, std_j = torch.sqrt(var_i), torch.sqrt(var_j)
    # sum_ij G_ij*i*j from the three integer histograms:
    # 2*S_ij = S_i2 + S_j2 - S_d2 since (i-j)^2 = i^2 + j^2 - 2ij
    s_i2 = ml @ i2
    s_j2 = mr @ i2
    s_ij = (s_i2 + s_j2 - s_d2) / 2
    cov = s_ij / safe_N - mu_i * mu_j
    denom = std_i * std_j
    ok = (std_i > 1e-15) & (std_j > 1e-15)
    correlation = torch.where(ok, cov / torch.where(ok, denom, 1), 1.0)

    return torch.stack(
        [contrast, dissimilarity, homogeneity, asm, energy, correlation], dim=-1
    )


def _finalize(
    stats: SuffStats, include_intensity: bool = True, include_glcm: bool = True
) -> FinalizedFeatures:
    """(B, 23*C) f32 features on the stats' device, plus degenerate flags."""
    B = stats.count.shape[0]
    blocks = []
    if include_intensity:
        blocks.append(_intensity_block(stats.hist, stats.count).reshape(B, -1))
    if include_glcm:
        blocks.append(
            _glcm_block(
                stats.marg_l, stats.marg_r, stats.diff_hist, stats.glcm_sumsq,
                stats.pair_count, stats.dstats,
            ).reshape(B, -1)
        )
    values = torch.cat(blocks, dim=1)
    degenerate = (stats.count == 0) | (stats.vmax <= 0)
    return FinalizedFeatures(values=values, degenerate=degenerate)


# --- the host float64 backend (numpy copies of tpumcia.features.finalize) ----


def _host_intensity_block(hist, count):
    """(B, C, L) histogram + (B, C) count -> (B, C, 17) float64 features."""
    xp, dtype = np, np.float64
    B, C, L = hist.shape
    top = float(L - 1)
    lev = xp.arange(L).astype(dtype)
    n = count.astype(dtype)
    safe_n = xp.maximum(n, 1)
    empty = n == 0

    nz = hist > 0
    min_lev = xp.argmax(nz, axis=-1).astype(dtype)
    max_lev = (L - 1) - xp.argmax(nz[..., ::-1], axis=-1).astype(dtype)
    min_v = xp.where(empty, 0, min_lev / top)
    max_v = xp.where(empty, 0, max_lev / top)

    cdf = xp.cumsum(hist.astype(dtype), axis=-1)
    qs = xp.asarray(_QS).astype(dtype)
    pos = qs[None, None, :] / 100.0 * (safe_n[..., None] - 1)
    k_lo = xp.floor(pos)
    k_hi = xp.ceil(pos)
    frac = pos - k_lo

    def value_at(k):  # (B, C, 9) sorted-order index -> level index
        return xp.sum(cdf[:, :, None, :] <= k[..., None], axis=-1).astype(dtype)

    v_lo = value_at(k_lo)
    v_hi = value_at(k_hi)
    pct = (v_lo + frac * (v_hi - v_lo)) / top
    pct = xp.where(empty[..., None], 0, pct)

    hist_d = hist.astype(dtype)
    total = xp.sum(hist_d * lev, axis=-1) / top
    mean = total / safe_n
    dev = lev[None, None, :] / top - mean[..., None]
    dev2 = dev * dev
    hd2 = hist_d * dev2
    m2 = xp.sum(hd2, axis=-1) / safe_n
    m3 = xp.sum(hd2 * dev, axis=-1) / safe_n
    m4 = xp.sum(hd2 * dev2, axis=-1) / safe_n
    std = xp.sqrt(m2)
    zero_var = (min_lev == max_lev) | (m2 == 0)
    safe_m2 = xp.where(zero_var, 1, m2)
    nan = xp.full_like(m2, np.nan)
    kurt = xp.where(zero_var, nan, m4 / (safe_m2 * safe_m2) - 3.0)
    skew = xp.where(zero_var, nan, m3 / safe_m2**1.5)

    p = hist_d / safe_n[..., None]
    plogp = xp.where(p > 0, p * xp.log2(xp.where(p > 0, p, 1)), 0)
    entropy = -xp.sum(plogp, axis=-1)

    def z(a):
        return xp.where(empty, 0, a)

    return xp.stack(
        [min_v]
        + [pct[..., i] for i in range(9)]
        + [max_v, z(total), z(mean), z(std),
           xp.where(empty, 0, kurt), xp.where(empty, 0, skew), z(entropy)],
        axis=-1,
    )


def _host_glcm_block(marg_l, marg_r, diff_hist, sumsq, npairs, dstats=None):
    """GLCM sufficient stats -> (B, C, 6) float64 [contrast, dissimilarity,
    homogeneity, ASM, energy, correlation], from ``dstats`` or, when it is
    None, from the difference histogram."""
    xp, dtype = np, np.float64
    L = marg_l.shape[-1]
    i = xp.arange(L).astype(dtype)
    i2 = i * i

    N = npairs.astype(dtype)
    safe_N = xp.maximum(N, 1)
    ml = marg_l.astype(dtype)
    mr = marg_r.astype(dtype)
    Pl = ml / safe_N[..., None]
    Pr = mr / safe_N[..., None]

    if dstats is not None:
        ds = dstats.astype(dtype)
        s_d2 = 256.0 * ds[..., 0] + ds[..., 1]
        contrast = s_d2 / safe_N
        dissimilarity = ds[..., 2] / safe_N
        homogeneity = ds[..., 3] / safe_N
    else:
        d = xp.arange(2 * L - 1).astype(dtype) - (L - 1)
        d2 = d * d
        dh = diff_hist.astype(dtype)
        Pd = dh / safe_N[..., None]
        contrast = xp.sum(Pd * d2, axis=-1)
        dissimilarity = xp.sum(Pd * xp.abs(d), axis=-1)
        homogeneity = xp.sum(Pd / (1.0 + d2), axis=-1)
        s_d2 = dh @ d2
    asm = glcm_sumsq_value(sumsq, dtype=dtype) / (safe_N * safe_N)
    energy = xp.sqrt(asm)

    mu_i = xp.sum(i * Pl, axis=-1)
    mu_j = xp.sum(i * Pr, axis=-1)
    di = i[None, None, :] - mu_i[..., None]
    dj = i[None, None, :] - mu_j[..., None]
    var_i = xp.sum(Pl * di * di, axis=-1)
    var_j = xp.sum(Pr * dj * dj, axis=-1)
    std_i, std_j = xp.sqrt(var_i), xp.sqrt(var_j)
    s_i2 = ml @ i2
    s_j2 = mr @ i2
    s_ij = (s_i2 + s_j2 - s_d2) / 2
    cov = s_ij / safe_N - mu_i * mu_j
    denom = std_i * std_j
    ok = (std_i > 1e-15) & (std_j > 1e-15)
    correlation = xp.where(ok, cov / xp.where(ok, denom, 1), 1.0)

    return xp.stack(
        [contrast, dissimilarity, homogeneity, asm, energy, correlation], axis=-1
    )


def _host_finalize(stats: SuffStats, include_intensity: bool, include_glcm: bool):
    """:class:`SuffStats` of numpy arrays -> (B, F) float64 features."""
    B = stats.count.shape[0]
    blocks = []
    if include_intensity:
        blocks.append(_host_intensity_block(stats.hist, stats.count).reshape(B, -1))
    if include_glcm:
        blocks.append(_host_glcm_block(
            stats.marg_l, stats.marg_r, stats.diff_hist, stats.glcm_sumsq,
            stats.pair_count, dstats=stats.dstats,
        ).reshape(B, -1))
    values = np.concatenate(blocks, axis=1)
    degenerate = (stats.count == 0) | (stats.vmax <= 0)
    return FinalizedFeatures(values=values, degenerate=degenerate)


def fetch_to_host(s) -> np.ndarray:
    """A tensor on any device, a host array, or a ``parallel.ShardedRows``
    (this process's rows of a batch spread over the ranks, gathered over
    the default process group first) -> numpy (tpumcia's
    ``fetch_to_host``)."""
    from tpumcia_torch.parallel.distributed import ShardedRows, all_gather_rows, is_initialized

    if isinstance(s, ShardedRows):
        rows = s.rows if isinstance(s.rows, torch.Tensor) else torch.from_numpy(np.asarray(s.rows))
        if len(rows) != s.total:
            import torch.distributed as dist

            rows = all_gather_rows(rows, dist.group.WORLD if is_initialized() else None)
        if len(rows) != s.total:
            raise ValueError(f"gathered {len(rows)} rows of a batch of {s.total}")
        s = rows
    if isinstance(s, torch.Tensor):
        return s.detach().cpu().numpy()
    return np.asarray(s)


def _pack_for_transfer(stats: SuffStats) -> SuffStats:
    """Copy the statistics to the host as numpy, with the count histograms
    narrowed to 16 bits while every count is < 65536 (tpumcia's
    ``_pack_for_transfer``): a histogram bin never exceeds its pixel or pair
    count, so the narrowing is lossless and halves the device-to-host bytes.
    The 16 bits travel as int16 and are read back as uint16 (torch's CUDA
    support for uint16 is limited)."""
    narrow = bool(stats.count.max() < 65536) if stats.count.numel() else True

    def hist_field(t):
        if t is None:
            return None
        if narrow:
            return t.to(torch.int32).to(torch.int16).cpu().numpy().view(np.uint16)
        return t.to(torch.int32).cpu().numpy()

    return SuffStats(
        hist=hist_field(stats.hist),
        count=stats.count.to(torch.int32).cpu().numpy(),
        vmax=stats.vmax.cpu().numpy(),
        marg_l=hist_field(stats.marg_l),
        marg_r=hist_field(stats.marg_r),
        diff_hist=hist_field(stats.diff_hist),
        glcm_sumsq=stats.glcm_sumsq.cpu().numpy(),
        pair_count=stats.pair_count.to(torch.int32).cpu().numpy(),
        dstats=None if stats.dstats is None else stats.dstats.cpu().numpy(),
    )


def finalize_features(
    stats: SuffStats,
    *,
    include_intensity: bool = True,
    include_glcm: bool = True,
    backend: str = "host",
) -> FinalizedFeatures:
    """Reduce :class:`SuffStats` to the (B, 23*C) feature matrix
    (tpumcia's ``finalize_features``). ``'host'``: float64 numpy values and
    flags; ``'hybrid'``: the u32 or packed wire, assembled in float64
    (needs < 2^16 pixels per channel); ``'device'``:
    a float32 tensor and bool flags on the statistics' device."""
    if backend == "host":
        return _host_finalize(_pack_for_transfer(stats), include_intensity, include_glcm)
    if backend == "hybrid":
        from tpumcia_torch.features.hybrid import finalize_hybrid

        return finalize_hybrid(
            stats, include_intensity=include_intensity, include_glcm=include_glcm
        )
    if backend == "device":
        return _finalize(stats, include_intensity, include_glcm)
    raise ValueError(f"unknown backend {backend!r}")
