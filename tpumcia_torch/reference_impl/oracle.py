"""CPU oracle for the reference feature semantics (golden-test ground truth).

A copy of ``tpumcia.reference_impl.oracle`` (numpy and scipy only), so that
the port and ``chip_smoke.py`` can hold finished features against the
notebook's semantics without importing tpumcia. It reproduces, in plain
numpy/scipy, the per-channel feature definitions of the reference notebook
(`channel_importance_hand_crafted_features.ipynb`):

* cell 9  (raw .ipynb lines 148-156): noise-channel synthesis,
* cell 13 (raw .ipynb lines 206-311): 17 intensity features + 6 GLCM features
  per channel, 23*C features total, in dict-insertion column order.

Deliberately preserved reference quirks (SURVEY.md §2.3):

* ``percentileXX`` features pass q = 0.1 .. 0.9 to ``np.percentile`` — i.e. the
  0.1th–0.9th percentiles, *not* the 10th–90th (ipynb:242-250).
* GLCM rescale ``(ch / ch.max()) * 255`` then ``astype(uint8)`` truncates
  (ipynb:293-295); an all-zero channel divides 0/0 — the oracle raises there,
  the production path defines the result instead.
* scipy ``kurtosis``/``skew`` defaults: fisher=True, bias=True (ipynb:259-260).

scikit-image is not a dependency, so ``graycomatrix``, ``graycoprops``,
``shannon_entropy`` and the gaussian noise model are re-implemented here from
their public definitions (pre-0.19 spelling in the reference:
``greycomatrix``/``greycoprops``; semantics unchanged).
"""

from __future__ import annotations

import warnings

import numpy as np
from scipy.stats import kurtosis, skew

# ---------------------------------------------------------------------------
# skimage-equivalent primitives
# ---------------------------------------------------------------------------


def shannon_entropy(image: np.ndarray, base: float = 2.0) -> float:
    """Entropy -sum(p log_base p) over the counts of unique pixel values.

    Matches ``skimage.measure.shannon_entropy`` (used at ipynb:262): the
    probability vector comes from ``np.unique`` counts, so any set of distinct
    values (not just integers) is supported.
    """
    _, counts = np.unique(np.asarray(image).ravel(), return_counts=True)
    p = counts / counts.sum()
    return float(-(p * (np.log(p) / np.log(base))).sum())


def graycomatrix(
    image: np.ndarray,
    distances,
    angles,
    levels: int = 256,
    symmetric: bool = False,
    normed: bool = False,
) -> np.ndarray:
    """Gray-level co-occurrence matrix, semantics of ``skimage.feature.graycomatrix``.

    For each distance d and angle a, counts pairs
    ``(image[r, c], image[r + round(d sin a), c + round(d cos a)])`` over all
    positions whose offset neighbour is inside the image. The reference invokes
    it with ``distances=[5], angles=[0], levels=256`` and default
    ``symmetric=False, normed=False`` (ipynb:298), i.e. horizontal offset +5.

    Returns an ``(levels, levels, len(distances), len(angles))`` array
    (uint32 counts, or float64 if ``normed``).
    """
    image = np.ascontiguousarray(image)
    if image.ndim != 2:
        raise ValueError("graycomatrix expects a 2D image")
    if image.dtype.kind not in "ui":
        raise ValueError("graycomatrix expects an integer image")
    if image.size and int(image.max()) >= levels:
        raise ValueError("image values must be < levels")

    rows, cols = image.shape
    out = np.zeros((levels, levels, len(distances), len(angles)), dtype=np.uint32)
    for di, d in enumerate(distances):
        for ai, a in enumerate(angles):
            dr = int(round(np.sin(a) * d))
            dc = int(round(np.cos(a) * d))
            r0, r1 = max(0, -dr), min(rows, rows - dr)
            c0, c1 = max(0, -dc), min(cols, cols - dc)
            if r0 >= r1 or c0 >= c1:
                continue
            i = image[r0:r1, c0:c1].ravel().astype(np.intp)
            j = image[r0 + dr : r1 + dr, c0 + dc : c1 + dc].ravel().astype(np.intp)
            np.add.at(out[:, :, di, ai], (i, j), 1)
    if symmetric:
        out = out + out.transpose(1, 0, 2, 3)
    if normed:
        out = out.astype(np.float64)
        sums = out.sum(axis=(0, 1), keepdims=True)
        sums[sums == 0] = 1
        out = out / sums
    return out


_PROPS = ("contrast", "dissimilarity", "homogeneity", "ASM", "energy", "correlation")


def graycoprops(glcm: np.ndarray, prop: str = "contrast") -> np.ndarray:
    """Texture properties of a GLCM, semantics of ``skimage.feature.graycoprops``.

    The GLCM is normalised to a probability matrix per (distance, angle) plane,
    then reduced with the standard Haralick-style weights. ``correlation`` is
    defined as 1 where either marginal standard deviation vanishes.
    Reference call sites: ipynb:301-306.
    """
    if prop not in _PROPS:
        raise ValueError(f"unknown GLCM property {prop!r}")
    glcm = np.asarray(glcm, dtype=np.float64)
    levels = glcm.shape[0]
    num_d, num_a = glcm.shape[2], glcm.shape[3]

    sums = glcm.sum(axis=(0, 1), keepdims=True)
    sums[sums == 0] = 1
    p = glcm / sums

    i = np.arange(levels, dtype=np.float64).reshape(levels, 1, 1, 1)
    j = np.arange(levels, dtype=np.float64).reshape(1, levels, 1, 1)

    if prop == "contrast":
        return (p * (i - j) ** 2).sum(axis=(0, 1))
    if prop == "dissimilarity":
        return (p * np.abs(i - j)).sum(axis=(0, 1))
    if prop == "homogeneity":
        return (p / (1.0 + (i - j) ** 2)).sum(axis=(0, 1))
    if prop == "ASM":
        return (p**2).sum(axis=(0, 1))
    if prop == "energy":
        return np.sqrt((p**2).sum(axis=(0, 1)))

    # correlation
    mean_i = (i * p).sum(axis=(0, 1))
    mean_j = (j * p).sum(axis=(0, 1))
    var_i = (p * (i - mean_i) ** 2).sum(axis=(0, 1))
    var_j = (p * (j - mean_j) ** 2).sum(axis=(0, 1))
    std_i, std_j = np.sqrt(var_i), np.sqrt(var_j)
    cov = (p * (i - mean_i) * (j - mean_j)).sum(axis=(0, 1))
    out = np.ones((num_d, num_a), dtype=np.float64)
    nonzero = (std_i > 1e-15) & (std_j > 1e-15)
    out[nonzero] = cov[nonzero] / (std_i[nonzero] * std_j[nonzero])
    return out


# ---------------------------------------------------------------------------
# Channel synthesis (reference cell 9)
# ---------------------------------------------------------------------------


def add_noise_channels(
    im: np.ndarray,
    rng: np.random.Generator | None = None,
    num_noise: int = 2,
    var: float = 0.01,
) -> np.ndarray:
    """Grayscale (H, W) uint8 -> (H, W, 1 + num_noise) uint8.

    Channel 1 is the image; the others are clipped gaussian noise on a zero
    image, matching ``skimage.util.random_noise(image*0.0)`` (gaussian mode,
    mean 0, var 0.01, output clipped to [0, 1]) at ipynb:150-156. The stack is
    scaled back by 255 and cast to uint8 (truncation).

    Unlike the reference (unseeded numpy global RNG), this takes an explicit
    ``rng`` for reproducibility; pass None to use a fresh default generator.
    """
    if rng is None:
        rng = np.random.default_rng()
    image = np.asarray(im) / 255.0
    chans = [image]
    for _ in range(num_noise):
        noise = rng.normal(0.0, np.sqrt(var), size=image.shape)
        chans.append(np.clip(noise, 0.0, 1.0))
    stacked = np.stack(chans, axis=2) * 255.0
    return stacked.astype(np.uint8)


# ---------------------------------------------------------------------------
# Feature extractors (reference cell 13)
# ---------------------------------------------------------------------------

_PCTS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)

INTENSITY_FEATURES = (
    "min_intensity",
    "percentile10_intensity",
    "percentile20_intensity",
    "percentile30_intensity",
    "percentile40_intensity",
    "percentile50_intensity",
    "percentile60_intensity",
    "percentile70_intensity",
    "percentile80_intensity",
    "percentile90_intensity",
    "max_intensity",
    "total_intensity",
    "mean_intensity",
    "std_intensity",
    "kurtosis_intensity",
    "skew_intensity",
    "shannon_entropy",
)

GLCM_FEATURES = (
    "contrast",
    "dissimilarity",
    "homogeneity",
    "ASM",
    "energy",
    "correlation",
)


def basic_statistical_features(image: np.ndarray) -> dict[str, float]:
    """17 intensity features per channel of a float (H, W, C) image.

    Column order and names match ipynb:241-262 exactly, including the
    percentile-q quirk (q = 0.1 .. 0.9, *not* 10 .. 90).
    """
    image = np.asarray(image)
    feats: dict[str, float] = {}
    for ch in range(image.shape[2]):
        plane = image[:, :, ch]
        suffix = f"_Ch{ch + 1}"
        feats["min_intensity" + suffix] = float(plane.min())
        for q in _PCTS:
            name = f"percentile{int(q * 100)}_intensity{suffix}"
            feats[name] = float(np.percentile(plane, q))
        feats["max_intensity" + suffix] = float(plane.max())
        feats["total_intensity" + suffix] = float(plane.sum())
        feats["mean_intensity" + suffix] = float(plane.mean())
        feats["std_intensity" + suffix] = float(plane.std())
        with warnings.catch_warnings():
            # constant channels hit scipy's expected "Precision loss
            # occurred in moment calculation" RuntimeWarning; the NaN
            # result is the contract the tests pin, the warning is noise
            warnings.simplefilter("ignore", RuntimeWarning)
            feats["kurtosis_intensity" + suffix] = float(
                kurtosis(plane.ravel())
            )
            feats["skew_intensity" + suffix] = float(skew(plane.ravel()))
        feats["shannon_entropy" + suffix] = shannon_entropy(plane)
    return feats


def glcm_features(
    image: np.ndarray, distance: int = 5, angle: float = 0.0
) -> dict[str, float]:
    """6 GLCM features per channel of a float (H, W, C) image.

    Per channel (ipynb:291-306): rescale to ``(ch / ch.max()) * 255`` and
    truncate to uint8, build the 256-level GLCM at the given offset, then
    reduce with the 6 properties. Raises on an all-zero channel (where the
    reference's 0/0 is undefined behaviour).
    """
    image = np.asarray(image)
    feats: dict[str, float] = {}
    for ch in range(image.shape[2]):
        plane = image[:, :, ch].astype(np.float64)
        peak = plane.max()
        if peak == 0:
            raise FloatingPointError(
                f"channel {ch} is all-zero; reference GLCM rescale is 0/0"
            )
        scaled = ((plane / peak) * 255.0).astype(np.uint8)
        glcm = graycomatrix(scaled, distances=[distance], angles=[angle], levels=256)
        suffix = f"_Ch{ch + 1}"
        for prop in GLCM_FEATURES:
            feats[prop + suffix] = float(graycoprops(glcm, prop)[0, 0])
    return feats


def feature_names(num_channels: int) -> list[str]:
    """Column names in reference order: 17 intensity per channel, then 6 GLCM
    per channel (23*C total; 69 for C=3 — ipynb:316)."""
    names = [
        f"{f}_Ch{ch + 1}" for ch in range(num_channels) for f in INTENSITY_FEATURES
    ]
    names += [f"{f}_Ch{ch + 1}" for ch in range(num_channels) for f in GLCM_FEATURES]
    return names


def feature_vector(image: np.ndarray, distance: int = 5, angle: float = 0.0) -> np.ndarray:
    """Full 23*C feature vector (float64) of a float (H, W, C) image, in
    reference column order (intensity block then GLCM block, ipynb:327-334)."""
    feats = basic_statistical_features(image)
    feats.update(glcm_features(image, distance=distance, angle=angle))
    order = feature_names(image.shape[2])
    return np.array([feats[name] for name in order], dtype=np.float64)
