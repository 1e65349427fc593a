"""Feature naming and column layout (a numpy copy of
``tpumcia.features.registry``).

Column order is the reference's dict-insertion order (SURVEY.md §2.3;
ipynb:327-334): the 17 intensity features for channel 1..C first, then the 6
GLCM features for channel 1..C — 23*C columns (69 for C=3, ipynb:316).
Names carry a 1-based ``_Ch{i}`` suffix like the reference, but channel
membership in this framework is always resolved from the parsed index, never
by substring (the reference's substring match breaks at >= 10 channels,
SURVEY.md §3.3).
"""

from __future__ import annotations

import re

INTENSITY_FEATURES: tuple[str, ...] = (
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

GLCM_FEATURES: tuple[str, ...] = (
    "contrast",
    "dissimilarity",
    "homogeneity",
    "ASM",
    "energy",
    "correlation",
)

NUM_INTENSITY = len(INTENSITY_FEATURES)  # 17
NUM_GLCM = len(GLCM_FEATURES)  # 6
NUM_PER_CHANNEL = NUM_INTENSITY + NUM_GLCM  # 23

_CH_RE = re.compile(r"_Ch(\d+)$")


def feature_names(
    num_channels: int,
    include_intensity: bool = True,
    include_glcm: bool = True,
    channel_names: list[str] | None = None,
    glcm_pair_labels: list[str] | None = None,
    include_morphology: bool = False,
) -> list[str]:
    """Column names in reference order. ``channel_names`` (h5 contract key
    ``channels``, README.md:13) replaces the default Ch1..ChC suffixes.
    ``glcm_pair_labels``: one tag per (distance, angle) pair for multi-offset
    GLCM (None = the reference's single-offset plain names)."""
    if channel_names is not None and len(channel_names) != num_channels:
        raise ValueError("channel_names length must equal num_channels")

    def suffix(ch: int) -> str:
        if channel_names is not None:
            return f"_{channel_names[ch]}"
        return f"_Ch{ch + 1}"

    names: list[str] = []
    if include_intensity:
        names += [f + suffix(c) for c in range(num_channels) for f in INTENSITY_FEATURES]
    if include_glcm:
        for label in glcm_pair_labels if glcm_pair_labels else [None]:
            tag = f"_{label}" if label else ""
            names += [
                f + tag + suffix(c)
                for c in range(num_channels)
                for f in GLCM_FEATURES
            ]
    if include_morphology:
        # morphology names append last, matching extract.py and the
        # positional layout below
        from tpumcia_torch.features.morphology import morphology_feature_names

        names += morphology_feature_names(num_channels, channel_names)
    return names


def num_features(
    num_channels: int,
    include_intensity: bool = True,
    include_glcm: bool = True,
    num_glcm_blocks: int = 1,
    include_morphology: bool = False,
) -> int:
    per = (NUM_INTENSITY if include_intensity else 0) + (
        NUM_GLCM * num_glcm_blocks if include_glcm else 0
    )
    if include_morphology:
        from tpumcia_torch.features.morphology import MORPHOLOGY_FEATURES

        per += len(MORPHOLOGY_FEATURES)
    return per * num_channels


def channel_of_column(name: str) -> int | None:
    """0-based channel index parsed from a ``_Ch{i}`` column name, or None."""
    m = _CH_RE.search(name)
    return int(m.group(1)) - 1 if m else None


def columns_by_channel(names: list[str], num_channels: int) -> list[list[int]]:
    """Exact-index grouping of feature columns per channel (the fixed version
    of the reference's substring grouping at ipynb:458-462)."""
    groups: list[list[int]] = [[] for _ in range(num_channels)]
    for idx, name in enumerate(names):
        ch = channel_of_column(name)
        if ch is not None and 0 <= ch < num_channels:
            groups[ch].append(idx)
    return groups


def columns_by_channel_positional(
    num_channels: int,
    include_intensity: bool = True,
    include_glcm: bool = True,
    num_glcm_blocks: int = 1,
    include_morphology: bool = False,
) -> list[list[int]]:
    """Per-channel column groups from the deterministic block layout
    (intensity C x 17 channel-major, then per-offset GLCM C x 6 blocks, then
    morphology C x 8) —
    independent of the column *names*, so it works with custom h5 channel
    names."""
    groups: list[list[int]] = [[] for _ in range(num_channels)]
    col = 0
    if include_intensity:
        for c in range(num_channels):
            groups[c].extend(range(col, col + NUM_INTENSITY))
            col += NUM_INTENSITY
    if include_glcm:
        for _ in range(num_glcm_blocks):
            for c in range(num_channels):
                groups[c].extend(range(col, col + NUM_GLCM))
                col += NUM_GLCM
    if include_morphology:
        from tpumcia_torch.features.morphology import MORPHOLOGY_FEATURES

        nm = len(MORPHOLOGY_FEATURES)
        for c in range(num_channels):
            groups[c].extend(range(col, col + nm))
            col += nm
    return groups
