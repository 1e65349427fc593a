"""Channel-ablation importance: the score drop when a whole channel's
features are neutralised (replaced by their dataset mean); a numpy copy of
``tpumcia.importance.ablation``. BASELINE.json configs 2-3 call for
"permutation and ablation scoring over the feature matrix"; ablation
removes a channel's information where permutation breaks its alignment with
the labels.
"""

from __future__ import annotations

import numpy as np


def channel_ablation_importance(
    head,
    X,
    y,
    channel_columns: list[list[int]],
    *,
    fill: str = "mean",
) -> np.ndarray:
    """(C,) score drops: baseline accuracy minus accuracy with each channel's
    feature columns replaced by ``fill`` ('mean' of X, or 'zero'), scored by
    ``head.score``."""
    if fill not in ("mean", "zero"):
        raise ValueError(f"fill must be 'mean' or 'zero'; got {fill!r}")
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y)
    baseline = head.score(X, y)
    fill_row = X.mean(axis=0) if fill == "mean" else np.zeros(X.shape[1], np.float32)

    drops = np.zeros(len(channel_columns))
    for c, cols in enumerate(channel_columns):
        Xa = X.copy()
        Xa[:, cols] = fill_row[cols]
        drops[c] = baseline - head.score(Xa, y)
    return drops
