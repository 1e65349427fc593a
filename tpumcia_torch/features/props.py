"""GLCM texture properties from explicit co-occurrence matrices
(counterpart of ``tpumcia.features.props``).

``skimage.feature.graycoprops``' semantics (the reference's calls,
ipynb:301-306) for users who work with the matrices from
:func:`tpumcia_torch.features.stats.glcm_matrix`. The feature pipeline never
builds the matrices: it uses histogram sufficient statistics.
"""

from __future__ import annotations

import torch

from tpumcia_torch.features.registry import GLCM_FEATURES
from tpumcia_torch.features.stats import on_device
from tpumcia_torch.utils.device import require_device


def glcm_properties(glcm, *, device="cuda") -> dict[str, torch.Tensor]:
    """(..., L, L) co-occurrence counts -> the 6 properties in float32 on
    ``device``, each shaped like the leading dims. skimage's semantics: each
    matrix is normalised; correlation is 1 where a marginal's variance is 0."""
    g = on_device(glcm, require_device(device, "glcm_properties")).to(torch.float32)
    L = g.shape[-1]
    total = g.sum((-2, -1), keepdim=True)
    p = g / torch.where(total == 0, 1.0, total)

    i = torch.arange(L, dtype=torch.float32, device=g.device)
    di = i[:, None] - i[None, :]
    contrast = (p * di ** 2).sum((-2, -1))
    dissimilarity = (p * di.abs()).sum((-2, -1))
    homogeneity = (p / (1.0 + di ** 2)).sum((-2, -1))
    asm = (p * p).sum((-2, -1))
    energy = torch.sqrt(asm)

    pi = p.sum(-1)  # (..., L) row marginal
    pj = p.sum(-2)
    mu_i = (pi * i).sum(-1)
    mu_j = (pj * i).sum(-1)
    d_i = i - mu_i[..., None]
    d_j = i - mu_j[..., None]
    var_i = (pi * d_i ** 2).sum(-1)
    var_j = (pj * d_j ** 2).sum(-1)
    cov = (p * (d_i[..., :, None] * d_j[..., None, :])).sum((-2, -1))
    ok = (var_i > 0) & (var_j > 0)
    correlation = torch.where(ok, cov / torch.where(ok, torch.sqrt(var_i * var_j), 1.0), 1.0)

    values = (contrast, dissimilarity, homogeneity, asm, energy, correlation)
    return dict(zip(GLCM_FEATURES, values))


def graycoprops(glcm, prop: str = "contrast", *, device="cuda") -> torch.Tensor:
    """``skimage.feature.graycoprops``' call shape (the reference's,
    ipynb:301-306): (..., L, L, D, A) matrices (e.g. from
    ``glcm_matrix(distances=[..], angles=[..])``) -> (..., D, A) values of
    one property ('contrast', 'dissimilarity', 'homogeneity', 'ASM',
    'energy', 'correlation'; any case)."""
    require_device(device, "graycoprops")
    names = {n.lower(): n for n in GLCM_FEATURES}
    if prop.lower() not in names:
        raise ValueError(f"unknown property {prop!r}; one of {list(GLCM_FEATURES)}")
    g = on_device(glcm, device).movedim(-1, 0).movedim(-1, 0)  # (D, A, ..., L, L)
    vals = glcm_properties(g, device=device)[names[prop.lower()]]  # (D, A, ...)
    return vals.movedim(0, -1).movedim(0, -1)
