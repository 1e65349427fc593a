"""Mean-decrease-in-impurity (MDI) feature importance (counterpart of
``tpumcia.importance.mdi``).

The reference reads ``model.feature_importances_`` from its random forest
(ipynb:434): the impurity decreases accumulated while the trees were grown,
normalised. The port computes them from the forest head's tree arrays
(``heads.forest_mdi``); aggregation to channels lives in
``importance/channels.py``.
"""

from __future__ import annotations

import numpy as np


def mdi_importance(head) -> np.ndarray:
    """(F,) normalised MDI importances of a RandomForestHead."""
    from tpumcia_torch.models.heads import RandomForestHead

    if not isinstance(head, RandomForestHead):
        raise TypeError(
            f"MDI is defined for forests; {type(head).__name__} has no "
            "impurity decreases (use permutation or coefficient importance)"
        )
    return head.mdi_importance()


def mdi_channel_importance(head, features, *, threshold: float = 0.01, match: str = "exact"):
    """Notebook cells 23+25 in one call: MDI, then per-channel aggregation
    (exact matching groups by the matrix's positional column layout, so
    custom channel names group correctly)."""
    from tpumcia_torch.importance.channels import aggregate_channel_importance

    out = aggregate_channel_importance(
        mdi_importance(head),
        features.names,
        features.num_channels,
        threshold=threshold,
        match=match,
        method="mdi",
        groups=features.channel_columns() if match == "exact" else None,
    )
    out.channel_names = getattr(features, "channel_names", None)
    return out
