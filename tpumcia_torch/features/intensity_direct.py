"""Direct (non-histogram) intensity features for float or high-bit-depth
data (counterpart of ``tpumcia.features.intensity_direct``).

The histogram path assumes level-quantised pixels. For float images or
16-bit data analysed without quantisation, this module computes the same 17
features (``registry.INTENSITY_FEATURES``' order) directly on the device:
order statistics from a sort (masked pixels sorted to +inf, numpy-linear
percentiles), moments from mean-centred float32 sums, and the entropy of the
distinct values from run lengths of the sorted values. Accuracy ~1e-6
relative (float32), against the histogram path's exact integers.
"""

from __future__ import annotations

import torch

from tpumcia_torch.features.stats import on_device
from tpumcia_torch.preprocess.normalize import _as_float32
from tpumcia_torch.utils.device import require_device

_QS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


def intensity_features_direct(images, mask=None, *, device="cuda") -> torch.Tensor:
    """(B, H, W, C) images (numpy or a tensor) and an optional (B, H, W) or
    (B, H, W, C) mask -> (B, C, 17) float32 on ``device``. Masked-out pixels
    take part in no statistic; an empty mask gives zeros for that channel,
    and a constant channel NaN kurtosis and skew."""
    x = _as_float32(on_device(images, require_device(device, "intensity_features_direct")))
    B, H, W, C = x.shape
    P = H * W
    xt = x.permute(0, 3, 1, 2).reshape(B, C, P)
    if mask is None:
        w = torch.ones_like(xt, dtype=torch.bool)
    else:
        m = on_device(mask, device)
        if m.dim() == 3:
            m = m[..., None]
        w = (m != 0).permute(0, 3, 1, 2).expand(B, C, H, W).reshape(B, C, P)

    n = w.sum(-1).to(torch.float32)  # (B, C)
    safe_n = torch.clamp(n, min=1.0)
    empty = n == 0
    s = torch.sort(torch.where(w, xt, torch.inf), dim=-1).values  # valid values first

    min_v = torch.where(empty, 0.0, s[..., 0])
    max_idx = torch.clamp(n - 1, 0, P - 1).to(torch.int64)
    max_v = torch.where(empty, 0.0, torch.gather(s, -1, max_idx[..., None])[..., 0])

    # numpy-linear percentiles at q = 0.1 .. 0.9 (the reference's quirk)
    qs = torch.tensor(_QS, dtype=torch.float32, device=x.device)
    pos = qs / 100.0 * (safe_n[..., None] - 1)  # (B, C, 9)
    k_lo = torch.floor(pos).to(torch.int64)
    k_hi = torch.ceil(pos).to(torch.int64)
    frac = pos - k_lo.to(torch.float32)
    v_lo = torch.gather(s, -1, k_lo.clamp(0, P - 1))
    v_hi = torch.gather(s, -1, k_hi.clamp(0, P - 1))
    pct = torch.where(empty[..., None], 0.0, v_lo + frac * (v_hi - v_lo))

    total = torch.where(w, xt, 0.0).sum(-1)
    mean = total / safe_n
    dev = torch.where(w, xt - mean[..., None], 0.0)
    m2 = (dev ** 2).sum(-1) / safe_n
    m3 = (dev ** 3).sum(-1) / safe_n
    m4 = (dev ** 4).sum(-1) / safe_n
    std = torch.sqrt(m2)
    zero_var = m2 == 0
    safe_m2 = torch.where(zero_var, 1.0, m2)
    kurt = torch.where(zero_var, torch.nan, m4 / safe_m2 ** 2 - 3.0)
    skew = torch.where(zero_var, torch.nan, m3 / safe_m2 ** 1.5)

    # entropy of the distinct values: run lengths of the sorted values
    valid = torch.isfinite(s)
    newrun = torch.cat([valid[..., :1], (s[..., 1:] != s[..., :-1]) & valid[..., 1:]], dim=-1)
    idx = torch.arange(P, device=x.device)
    starts = torch.sort(torch.where(newrun, idx, P), dim=-1).values
    next_start = torch.cat([starts[..., 1:], torch.full_like(starts[..., :1], P)], dim=-1)
    run_len = (torch.minimum(next_start.to(torch.float32), n[..., None]) - starts).to(torch.float32)
    run_valid = starts < n[..., None]
    p = torch.where(run_valid, run_len / safe_n[..., None], 1.0)
    entropy = -torch.where(
        run_valid & (p > 0), p * torch.log2(torch.where(p > 0, p, 1.0)), 0.0
    ).sum(-1)

    def z(a):
        return torch.where(empty, 0.0, a)

    feats = [min_v, *pct.unbind(-1), max_v, z(total), z(mean), z(std), z(kurt), z(skew), z(entropy)]
    return torch.stack(feats, dim=-1)
