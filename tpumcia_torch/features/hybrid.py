"""Hybrid exact finalisation: device scalar reduction + host f64 assembly
(the counterpart of ``tpumcia.features.hybrid``).

The device reduces each (image, channel)'s statistics to 20 u32 words: exact
integers (counts, min/max levels, the level-weighted sum, integer
percentile indices, first moments, and the quadratic sums as exact u32)
plus five f32 sums (central moments m2..m4 from exact integer deviation
numerators, entropy, homogeneity). The host decodes the words and assembles
every feature in float64 from them. Valid for levels <= 256 and per-channel
pixel counts < 2^16, which ``extract.hybrid_wire_ok`` enforces. Above 256
levels :func:`finalize_hybrid` sends the packed f32 wire instead
(:func:`_device_reduce_packed`, 61 f32 per (image, channel), wide sums as
exact 16-bit halves).

Words are built in int64 and sent as int32 bit patterns (the CPU build of
torch has no uint32 shifts); the host reads them back as uint32.

Wire layout (B, C, 20), as in tpumcia:
  w0    : n | min_lev<<16 | max_lev<<24
  w1    : npairs | (vmax+1)<<16 | count_overflow<<31
  w2    : total_raw
  w3-7  : percentile (idx_lo | idx_hi<<8) pairs, 2 per word (9 pairs + pad)
  w8-12 : m2 m3 m4 entropy homog_sum    (f32 bit patterns)
  w13-15: s_i s_j dissim_raw
  w16-18: s_i2 s_j2 s_d2                (exact u32)
  w19   : sum(G^2)                      (exact u32)

The multi-offset wire (B, C, 12 + 9*O) ships the intensity words once and
9 GLCM words per offset, so a whole offset list is one copy to the host:
  shared w0-2 : as w0, (vmax+1) | count_overflow<<31, total_raw
  shared w3-7 : percentile pairs      shared w8-11: m2 m3 m4 entropy
  offset +0-4 : npairs, homog_sum (f32 bits), s_i, s_j, dissim_raw
  offset +5-8 : s_i2 s_j2 s_d2 sum(G^2)   (exact u32)
"""

from __future__ import annotations

import numpy as np
import torch

from tpumcia_torch.features.finalize import FinalizedFeatures
from tpumcia_torch.features.stats import SuffStats

_Q10 = np.arange(1, 10, dtype=np.int32)  # q*10 for q = 0.1 .. 0.9
WIRE_WORDS = 20
_U32 = 0xFFFFFFFF


def _device_reduce(stats: SuffStats) -> dict:
    f32 = torch.float32
    i64 = torch.int64
    hist = stats.hist.to(i64)  # (B, C, L) exact counts
    L = hist.shape[-1]
    dev = hist.device
    k = torch.arange(L, device=dev)
    n = stats.count.to(i64)
    safe_n = torch.clamp(n, min=1)

    # --- intensity: exact integer pieces ---------------------------------
    nz = (hist > 0).to(torch.uint8)  # argmax rejects bool
    min_lev = torch.argmax(nz, dim=-1)
    max_lev = (L - 1) - torch.argmax(nz.flip(-1), dim=-1)
    total_raw = (hist * k).sum(-1)

    cdf = torch.cumsum(hist, dim=-1)
    q10 = torch.as_tensor(_Q10, device=dev).to(i64)
    num = q10[None, None, :] * (safe_n[..., None] - 1)
    k_lo = num // 1000
    rem = num - k_lo * 1000
    k_hi = k_lo + (rem > 0).to(i64)

    def value_at(kq):  # (B, C, 9) -> level index of the order statistic
        return torch.clamp(
            (cdf[:, :, None, :] <= kq[..., None]).sum(-1), max=L - 1
        )

    idx_lo = value_at(k_lo)
    idx_hi = value_at(k_hi)

    # central moments from the exact mean numerator e = n*k - T:
    # dev = e / ((L-1)*n)
    e = safe_n[..., None] * k[None, None, :] - total_raw[..., None]
    dev_ = e.to(f32) / (float(L - 1) * safe_n[..., None].to(f32))
    hist_f = hist.to(f32)
    dev2 = dev_ * dev_
    hd2 = hist_f * dev2
    nf = safe_n.to(f32)
    m2 = hd2.sum(-1) / nf
    m3 = (hd2 * dev_).sum(-1) / nf
    m4 = (hd2 * dev2).sum(-1) / nf

    p = hist_f / nf[..., None]
    entropy = -torch.where(
        p > 0, p * torch.log2(torch.where(p > 0, p, 1.0)), 0.0
    ).sum(-1)

    return dict(
        n=n, vmax=stats.vmax.to(i64), min_lev=min_lev, max_lev=max_lev,
        total_raw=total_raw, idx_lo=idx_lo, idx_hi=idx_hi,
        m2=m2, m3=m3, m4=m4, entropy=entropy,
        **_glcm_reduce(stats),
    )


def _glcm_reduce(stats: SuffStats) -> dict:
    """The GLCM half of :func:`_device_reduce`: the exact integer pieces of
    one offset's marginals and difference reductions, from ``dstats``
    (<= 256 levels) or from the difference histogram."""
    i64 = torch.int64
    L = stats.marg_l.shape[-1]
    k = torch.arange(L, device=stats.marg_l.device)
    if stats.dstats is not None:
        if L > 256:
            # the dstats hi limb is exact in f32 only at <= 256 levels
            raise ValueError("hybrid reduction with kernel dstats requires levels <= 256")
        ds = stats.dstats
        dissim_raw, homog_sum = ds[..., 2].to(i64), ds[..., 3]
    else:
        dh = stats.diff_hist
        d = _signed_diffs(dh)
        dissim_raw = (dh.to(i64) * d.abs()).sum(-1)
        homog_sum = (dh.to(torch.float32) / (1.0 + (d * d).to(torch.float32))).sum(-1)
    return dict(
        s_i=(stats.marg_l.to(i64) * k).sum(-1),
        s_j=(stats.marg_r.to(i64) * k).sum(-1),
        dissim_raw=dissim_raw,
        homog_sum=homog_sum,
        npairs=stats.pair_count.to(i64),
    )


def _signed_diffs(diff_hist: torch.Tensor) -> torch.Tensor:
    """The level difference d = i - j of each of the 2L-1 bins, int64."""
    n = diff_hist.shape[-1]
    return torch.arange(n, device=diff_hist.device) - (n - 1) // 2


def _s_d2(stats: SuffStats) -> torch.Tensor:
    """sum(G*d^2) in int64: from the dstats limbs or the difference histogram."""
    if stats.dstats is not None:
        ds = stats.dstats.to(torch.int64)
        return (ds[..., 0] << 8) + ds[..., 1]
    d = _signed_diffs(stats.diff_hist)
    return (stats.diff_hist.to(torch.int64) * d * d).sum(-1)


def _wire_u32_quads(stats: SuffStats):
    """Exact u32 quadratic sums ``(s_i2, s_j2, s_d2, sum(G^2))`` as int64
    values reduced mod 2^32 (every true total is < 2^32 here)."""
    i64 = torch.int64
    L = stats.marg_l.shape[-1]
    k = torch.arange(L, device=stats.marg_l.device)
    k2 = k * k
    s_i2 = (stats.marg_l.to(i64) * k2).sum(-1) & _U32
    s_j2 = (stats.marg_r.to(i64) * k2).sum(-1) & _U32
    s_d2 = _s_d2(stats) & _U32
    limbs = stats.glcm_sumsq.to(i64)  # weights 2^24, 2^13, 2^8, 1
    sumsq = (
        (limbs[..., 0] << 24) + (limbs[..., 1] << 13)
        + (limbs[..., 2] << 8) + limbs[..., 3]
    ) & _U32
    return s_i2, s_j2, s_d2, sumsq


def _to_i32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32-bit pattern."""
    words = words & _U32
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _fbits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _U32


def _device_reduce_wire(stats: SuffStats) -> torch.Tensor:
    """(B, C, 20) int32 holding the u32 wire words (levels <= 256)."""
    r = _device_reduce(stats)
    i64 = torch.int64
    n = r["n"]
    w0 = n | (r["min_lev"] << 16) | (r["max_lev"] << 24)
    # bit 31: count >= 2^16, where the 16-bit fields wrap; npairs <= n is
    # masked so an overflowing count cannot smear into the vmax/flag bits
    w1 = (r["npairs"] & 0xFFFF) | ((r["vmax"] + 1) << 16) | ((n >= 65536).to(i64) << 31)
    w2 = r["total_raw"]
    pair = r["idx_lo"] | (r["idx_hi"] << 8)  # (B, C, 9), 16 bits each
    pair = torch.cat([pair, torch.zeros_like(pair[..., :1])], dim=-1)
    w_pct = pair[..., 0::2] | (pair[..., 1::2] << 16)  # (B, C, 5)
    w_float = torch.stack(
        [_fbits(r[f]) for f in ("m2", "m3", "m4", "entropy", "homog_sum")], dim=-1
    )
    s_i2, s_j2, s_d2, sumsq = _wire_u32_quads(stats)
    tail = torch.stack(
        [r["s_i"], r["s_j"], r["dissim_raw"], s_i2, s_j2, s_d2, sumsq], dim=-1
    )
    words = torch.cat(
        [torch.stack([w0, w1, w2], dim=-1), w_pct, w_float, tail], dim=-1
    )
    return _to_i32_bits(words)


MULTI_WIRE_SHARED = 12
MULTI_WIRE_PER_OFFSET = 9


def multi_wire_words(num_offsets: int) -> int:
    return MULTI_WIRE_SHARED + MULTI_WIRE_PER_OFFSET * num_offsets


def _device_reduce_wire_multi(all_stats) -> torch.Tensor:
    """(B, C, 12 + 9*O) int32 holding the multi-offset u32 wire words for a
    sequence of per-offset :class:`SuffStats` (``all_stats[0]`` carries the
    intensity histogram; count and vmax are shared)."""
    r0 = _device_reduce(all_stats[0])
    i64 = torch.int64
    n = r0["n"]
    w0 = n | (r0["min_lev"] << 16) | (r0["max_lev"] << 24)
    w1 = ((r0["vmax"] + 1) & 0xFFFF) | ((n >= 65536).to(i64) << 31)
    pair = r0["idx_lo"] | (r0["idx_hi"] << 8)
    pair = torch.cat([pair, torch.zeros_like(pair[..., :1])], dim=-1)
    w_pct = pair[..., 0::2] | (pair[..., 1::2] << 16)  # (B, C, 5)
    w_float = torch.stack(
        [_fbits(r0[f]) for f in ("m2", "m3", "m4", "entropy")], dim=-1
    )
    words = [torch.stack([w0, w1, r0["total_raw"]], dim=-1), w_pct, w_float]
    for o, stats in enumerate(all_stats):
        g = r0 if o == 0 else _glcm_reduce(stats)
        s_i2, s_j2, s_d2, sumsq = _wire_u32_quads(stats)
        words.append(torch.stack(
            [g["npairs"], _fbits(g["homog_sum"]), g["s_i"], g["s_j"],
             g["dissim_raw"], s_i2, s_j2, s_d2, sumsq],
            dim=-1,
        ))
    return _to_i32_bits(torch.cat(words, dim=-1))


def _quad_shift(levels: int) -> int:
    """Limb shift of the packed wire's quadratic sums: the square's hi part
    stays <= 2^15 per level, so each limb sum stays below 2^31 for counts
    < 2^16 (tpumcia's ``_quad_shift``; base 256 up to 256 levels)."""
    if levels > 32768:
        raise ValueError("hybrid reduction supports at most 32768 levels")
    return max(8, 2 * int(levels - 1).bit_length() - 15)


# the packed wire's layout (tpumcia's): 10 narrow scalars (f32-exact), 10
# wide integer sums as exact 16-bit (hi, lo) f32 halves, then the percentile
# triples and the sum(G^2) limbs
_NARROW_FIELDS = (
    "n", "vmax", "min_lev", "max_lev", "m2", "m3", "m4",
    "entropy", "homog_sum", "npairs",
)
_WIDE_FIELDS = (
    "total_raw", "s_i", "s_j", "dissim_raw",
    "s_i2_hi", "s_i2_lo", "s_j2_hi", "s_j2_lo", "s_d2_hi", "s_d2_lo",
)
_VEC_FIELDS = (("idx_lo", 9), ("idx_hi", 9), ("rem", 9), ("sumsq", 4))
PACKED_WORDS = len(_NARROW_FIELDS) + 2 * len(_WIDE_FIELDS) + sum(w for _, w in _VEC_FIELDS)


def _device_reduce_packed(stats: SuffStats) -> torch.Tensor:
    """(B, C, 61) f32: the packed wire of tpumcia's ``_device_reduce_packed``
    for any level count (the u32 wire's 8-bit level fields stop at 256),
    from statistics with the difference histogram (which every statistics
    pass above 256 levels carries)."""
    f32, i64 = torch.float32, torch.int64
    r = _device_reduce(stats)
    L = stats.marg_l.shape[-1]
    S = _quad_shift(L)
    lo_mask = (1 << S) - 1
    k = torch.arange(L, device=stats.marg_l.device)
    i2 = k * k
    d = _signed_diffs(stats.diff_hist)
    d2 = d * d

    def limbs(counts, sq):  # sum(counts * sq) as (hi, lo) limb sums
        c = counts.to(i64)
        return (c * (sq >> S)).sum(-1), (c * (sq & lo_mask)).sum(-1)

    (s_i2_hi, s_i2_lo), (s_j2_hi, s_j2_lo), (s_d2_hi, s_d2_lo) = (
        limbs(stats.marg_l, i2), limbs(stats.marg_r, i2), limbs(stats.diff_hist, d2))
    r.update(
        s_i2_hi=s_i2_hi, s_i2_lo=s_i2_lo, s_j2_hi=s_j2_hi, s_j2_lo=s_j2_lo,
        s_d2_hi=s_d2_hi, s_d2_lo=s_d2_lo,
        rem=(torch.as_tensor(_Q10, device=k.device).to(i64)
             * (torch.clamp(r["n"], min=1)[..., None] - 1)) % 1000,
        sumsq=stats.glcm_sumsq,
    )
    parts = [r[f].to(f32)[..., None] for f in _NARROW_FIELDS]
    for f in _WIDE_FIELDS:
        v = r[f]  # a non-negative integer sum below 2^31
        parts += [(v >> 16).to(f32)[..., None], (v & 0xFFFF).to(f32)[..., None]]
    parts += [r[f].to(f32) for f, _ in _VEC_FIELDS]
    return torch.cat(parts, dim=-1)


# --- host side (numpy copies of tpumcia.features.hybrid) -------------------


def unpack_wire_multi(packed: np.ndarray, num_offsets: int) -> list[dict]:
    """Decode the multi-offset u32 wire into one :func:`assemble_reduced`
    dict per offset (the first carries the intensity fields; every dict
    carries n and vmax for the degenerate flags). O(B*C) numpy only."""
    p = np.ascontiguousarray(np.asarray(packed))
    if p.dtype != np.uint32 or p.shape[-1] != multi_wire_words(num_offsets):
        raise ValueError(
            f"expected (..., {multi_wire_words(num_offsets)}) uint32 words for "
            f"{num_offsets} offsets; got {p.dtype} {p.shape}"
        )
    i64 = np.int64
    shared = {}
    w0 = p[..., 0]
    shared["n"] = (w0 & 0xFFFF).astype(i64)
    shared["min_lev"] = ((w0 >> 16) & 0xFF).astype(i64)
    shared["max_lev"] = ((w0 >> 24) & 0xFF).astype(i64)
    w1 = p[..., 1]
    shared["vmax"] = (w1 & 0x7FFF).astype(i64) - 1
    shared["count_overflow"] = (w1 >> 31) != 0
    shared["total_raw"] = p[..., 2].astype(i64)
    pct = p[..., 3:8]
    pairs = np.stack([pct & 0xFFFF, pct >> 16], axis=-1).reshape(
        *pct.shape[:-1], 10
    )[..., :9]
    shared["idx_lo"] = (pairs & 0xFF).astype(i64)
    shared["idx_hi"] = ((pairs >> 8) & 0xFF).astype(i64)
    shared["rem"] = (
        _Q10.astype(i64)[None, None, :] * np.maximum(shared["n"] - 1, 0)[..., None]
    ) % 1000
    floats = np.ascontiguousarray(p[..., 8:12]).view(np.float32)
    for i, f in enumerate(("m2", "m3", "m4", "entropy")):
        shared[f] = floats[..., i]
    out = []
    for o in range(num_offsets):
        base = MULTI_WIRE_SHARED + MULTI_WIRE_PER_OFFSET * o
        d = dict(shared)
        d["npairs"] = p[..., base].astype(i64)
        d["homog_sum"] = np.ascontiguousarray(
            p[..., base + 1:base + 2]
        ).view(np.float32)[..., 0]
        d["s_i"] = p[..., base + 2].astype(i64)
        d["s_j"] = p[..., base + 3].astype(i64)
        d["dissim_raw"] = p[..., base + 4].astype(i64)
        d["s_i2"] = p[..., base + 5].astype(np.float64)
        d["s_j2"] = p[..., base + 6].astype(np.float64)
        d["s_d2"] = p[..., base + 7].astype(np.float64)
        d["sumsq_value"] = p[..., base + 8].astype(np.float64)
        out.append(d)
    return out


def unpack_wire(packed: np.ndarray) -> dict:
    """Decode the u32 wire into the dict :func:`assemble_reduced` consumes.
    O(B*C) numpy only."""
    p = np.ascontiguousarray(np.asarray(packed))
    if p.dtype != np.uint32 or p.shape[-1] != WIRE_WORDS:
        raise ValueError(f"expected (..., {WIRE_WORDS}) uint32 words; got {p.dtype} {p.shape}")
    i64 = np.int64
    out = {}
    w0 = p[..., 0]
    out["n"] = (w0 & 0xFFFF).astype(i64)
    out["min_lev"] = ((w0 >> 16) & 0xFF).astype(i64)
    out["max_lev"] = ((w0 >> 24) & 0xFF).astype(i64)
    w1 = p[..., 1]
    out["npairs"] = (w1 & 0xFFFF).astype(i64)
    out["vmax"] = ((w1 >> 16) & 0x7FFF).astype(i64) - 1
    out["count_overflow"] = (w1 >> 31) != 0
    out["total_raw"] = p[..., 2].astype(i64)
    pct = p[..., 3:8]
    pairs = np.stack([pct & 0xFFFF, pct >> 16], axis=-1).reshape(
        *pct.shape[:-1], 10
    )[..., :9]
    out["idx_lo"] = (pairs & 0xFF).astype(i64)
    out["idx_hi"] = ((pairs >> 8) & 0xFF).astype(i64)
    out["rem"] = (
        _Q10.astype(i64)[None, None, :] * np.maximum(out["n"] - 1, 0)[..., None]
    ) % 1000
    floats = np.ascontiguousarray(p[..., 8:13]).view(np.float32)
    out["m2"] = floats[..., 0]
    out["m3"] = floats[..., 1]
    out["m4"] = floats[..., 2]
    out["entropy"] = floats[..., 3]
    out["homog_sum"] = floats[..., 4]
    out["s_i"] = p[..., 13].astype(i64)
    out["s_j"] = p[..., 14].astype(i64)
    out["dissim_raw"] = p[..., 15].astype(i64)
    out["s_i2"] = p[..., 16].astype(np.float64)
    out["s_j2"] = p[..., 17].astype(np.float64)
    out["s_d2"] = p[..., 18].astype(np.float64)
    out["sumsq_value"] = p[..., 19].astype(np.float64)
    return out


def unpack_reduced(packed: np.ndarray, *, levels: int = 256) -> dict:
    """Decode the packed f32 wire into the dict :func:`assemble_reduced`
    consumes (tpumcia's ``unpack_reduced``). O(B*C) numpy only."""
    from tpumcia_torch.features.stats import glcm_sumsq_value

    packed = np.asarray(packed)
    if packed.shape[-1] != PACKED_WORDS:
        raise ValueError(f"expected (..., {PACKED_WORDS}) packed words; got {packed.shape}")
    f64 = np.float64
    out = {}
    i = 0
    for f in _NARROW_FIELDS:
        out[f] = packed[..., i]
        i += 1
    for f in _WIDE_FIELDS:
        out[f] = packed[..., i].astype(f64) * 65536.0 + packed[..., i + 1].astype(f64)
        i += 2
    for f, width in _VEC_FIELDS:
        out[f] = packed[..., i:i + width]
        i += width
    base = float(1 << _quad_shift(levels))
    for q in ("s_i2", "s_j2", "s_d2"):
        out[q] = base * out.pop(f"{q}_hi") + out.pop(f"{q}_lo")
    out["sumsq_value"] = glcm_sumsq_value(out.pop("sumsq"), np, f64)
    out["count_overflow"] = out["n"] >= 65536
    return out


def finalize_hybrid(
    stats: SuffStats, *, include_intensity: bool = True, include_glcm: bool = True
) -> FinalizedFeatures:
    """tpumcia's ``finalize_hybrid``: the u32 wire at <= 256 levels, the
    packed f32 wire above, one copy to the host, f64 assembly. Refuses
    per-channel pixel counts >= 65536, past the wires' exact bounds."""
    levels = stats.hist.shape[-1]
    if levels <= 256:
        reduced = unpack_wire(_device_reduce_wire(stats).cpu().numpy().view(np.uint32))
        ok = not np.any(reduced["count_overflow"])
    else:
        reduced = unpack_reduced(_device_reduce_packed(stats).cpu().numpy(), levels=levels)
        ok = float(np.max(reduced["n"], initial=0)) < 65536
    if not ok:
        raise ValueError(
            "hybrid finalize requires per-channel pixel counts < 65536 "
            "(images this large should use precision='exact')"
        )
    return assemble_reduced(
        reduced, levels=levels, include_intensity=include_intensity,
        include_glcm=include_glcm,
    )


def assemble_reduced(
    reduced: dict,
    *,
    levels: int = 256,
    include_intensity: bool = True,
    include_glcm: bool = True,
) -> FinalizedFeatures:
    """Host f64 assembly of a device reduction (:func:`unpack_wire`)."""
    r = {kk: np.asarray(v) for kk, v in reduced.items()}
    f64 = np.float64
    top = float(levels - 1)  # level value divisor

    n = r["n"].astype(f64)
    safe_n = np.maximum(n, 1)
    empty = n == 0

    def z(a):
        return np.where(empty, 0.0, a)

    blocks = []
    B, C = r["n"].shape
    if include_intensity:
        min_v = z(r["min_lev"].astype(f64) / top)
        max_v = z(r["max_lev"].astype(f64) / top)
        frac = r["rem"].astype(f64) / 1000.0
        pct = (r["idx_lo"] + frac * (r["idx_hi"] - r["idx_lo"])) / top
        pct = np.where(empty[..., None], 0.0, pct)
        total = r["total_raw"].astype(f64) / top
        mean = total / safe_n
        m2 = r["m2"].astype(f64)
        std = np.sqrt(m2)
        zero_var = m2 == 0
        safe_m2 = np.where(zero_var, 1.0, m2)
        nanv = np.full_like(m2, np.nan)
        kurt = np.where(zero_var, nanv, r["m4"] / (safe_m2 * safe_m2) - 3.0)
        skew = np.where(zero_var, nanv, r["m3"] / safe_m2**1.5)
        feats = np.stack(
            [min_v]
            + [pct[..., i] for i in range(9)]
            + [max_v, z(total), z(mean), z(std),
               np.where(empty, 0.0, kurt), np.where(empty, 0.0, skew),
               z(r["entropy"].astype(f64))],
            axis=-1,
        )
        blocks.append(feats.reshape(B, -1))

    if include_glcm:
        N = r["npairs"].astype(f64)
        safe_N = np.maximum(N, 1.0)
        s_d2 = r["s_d2"]
        s_i2 = r["s_i2"]
        s_j2 = r["s_j2"]
        s_i = r["s_i"].astype(f64)
        s_j = r["s_j"].astype(f64)

        contrast = s_d2 / safe_N
        dissimilarity = r["dissim_raw"].astype(f64) / safe_N
        homogeneity = r["homog_sum"].astype(f64) / safe_N
        asm = r["sumsq_value"] / (safe_N * safe_N)
        energy = np.sqrt(asm)
        # correlation from exact integer sums: cov*N^2 = N*s_ij - s_i*s_j
        s_ij = (s_i2 + s_j2 - s_d2) / 2.0
        cov_nn = safe_N * s_ij - s_i * s_j
        var_i_nn = safe_N * s_i2 - s_i * s_i
        var_j_nn = safe_N * s_j2 - s_j * s_j
        denom = np.sqrt(np.maximum(var_i_nn, 0.0) * np.maximum(var_j_nn, 0.0))
        # skimage: correlation = 1 when either marginal variance is zero
        # (exactly var_nn == 0, since var_nn are exact integers)
        ok = (var_i_nn > 0) & (var_j_nn > 0)
        correlation = np.where(ok, cov_nn / np.where(ok, denom, 1.0), 1.0)
        glcm = np.stack(
            [contrast, dissimilarity, homogeneity, asm, energy, correlation],
            axis=-1,
        )
        blocks.append(glcm.reshape(B, -1))

    values = np.concatenate(blocks, axis=1)
    degenerate = (r["n"] == 0) | (r["vmax"] <= 0)
    return FinalizedFeatures(values=values, degenerate=degenerate)
