"""Channel-importance aggregation and the high-level
:func:`channel_importance` (counterpart of ``tpumcia.importance.channels``).

The reference aggregates per-feature importances into channels by *name
substring* ("Ch1" in name) with a 0.01 floor (ipynb:458-462), which breaks
at >= 10 channels ("Ch1" matches "Ch10"). The default here groups by the
parsed channel index; ``match='substring'`` replicates the reference.
:func:`channel_importance` takes every method of tpumcia's, ``'mdi'`` for
the forest head included.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpumcia_torch.features import registry


@dataclass
class ChannelImportanceResult:
    per_channel: list[np.ndarray]  # filtered importance values per channel
    mean: np.ndarray  # (C,) mean of filtered values (0 if none)
    total: np.ndarray  # (C,) sum of filtered values
    ranking: np.ndarray  # channel indices sorted by total, descending
    feature_importances: np.ndarray  # (F,) the per-feature values aggregated
    feature_names: list[str]
    method: str = "mdi"
    channel_names: list[str] | None = None  # display names (h5 contract)
    extras: dict = field(default_factory=dict)

    @property
    def num_channels(self) -> int:
        return len(self.per_channel)

    def top_channel(self) -> int:
        return int(self.ranking[0])

    def channel_label(self, c: int) -> str:
        if self.channel_names is not None and c < len(self.channel_names):
            return self.channel_names[c]
        return f"Ch{c + 1}"

    def summary(self) -> str:
        lines = [f"channel importance ({self.method}):"]
        for c in self.ranking:
            lines.append(
                f"  {self.channel_label(c)}: total={self.total[c]:.4f} "
                f"mean={self.mean[c]:.4f} n={len(self.per_channel[c])}"
            )
        return "\n".join(lines)


def aggregate_channel_importance(
    importances,
    names: list[str],
    num_channels: int,
    *,
    threshold: float = 0.01,
    match: str = "exact",
    method: str = "mdi",
    groups: list[list[int]] | None = None,
) -> ChannelImportanceResult:
    """Group per-feature importances into per-channel distributions.

    ``threshold`` drops features with importance <= threshold before
    aggregation (reference ipynb:459: ``value > 0.01``).
    ``groups`` (per-channel column index lists) overrides name-based
    matching — required when columns carry custom h5 channel names
    (contract key ``channels``, README.md:13) that no ``_Ch{i}`` parse can
    resolve.
    """
    imp = np.asarray(importances, dtype=np.float64)
    if imp.shape[0] != len(names):
        raise ValueError("importances and names length mismatch")
    if threshold is None:
        threshold = -np.inf  # keep everything (incl. zero/negative drops)

    if groups is not None:
        if len(groups) != num_channels:
            raise ValueError("groups length must equal num_channels")
    elif match == "exact":
        groups = registry.columns_by_channel(list(names), num_channels)
        if all(len(g) == 0 for g in groups):
            # custom channel names carry no _Ch{i} suffix; silently
            # returning zeros would fake a "no channel matters" result
            raise ValueError(
                "no _Ch{i} suffixes found in feature names; pass "
                "groups= (e.g. FeatureMatrix.channel_columns()) for "
                "custom channel names"
            )
    elif match == "substring":
        # reference semantics (ipynb:462): `"Ch{i}" in name`
        groups = [
            [j for j, n in enumerate(names) if f"Ch{c + 1}" in n]
            for c in range(num_channels)
        ]
        if all(len(g) == 0 for g in groups):
            # same guard as the exact branch: custom channel names carry no
            # Ch{i} substring, and silently returning zeros would fake a
            # "no channel matters" result
            raise ValueError(
                "no Ch{i} substrings found in feature names; pass groups= "
                "(e.g. FeatureMatrix.channel_columns()) for custom channel "
                "names"
            )
    else:
        raise ValueError(f"unknown match mode {match!r}")

    per_channel = []
    for cols in groups:
        vals = imp[cols]
        per_channel.append(vals[vals > threshold])
    total = np.array([v.sum() for v in per_channel])
    mean = np.array([v.mean() if len(v) else 0.0 for v in per_channel])
    return ChannelImportanceResult(
        per_channel=per_channel,
        mean=mean,
        total=total,
        ranking=np.argsort(total)[::-1],
        feature_importances=imp,
        feature_names=list(names),
        method=method,
    )


def _sweep(head, X, y, *, n_repeats, seed, groups, mesh):
    """The permutation sweep, with its groups over the mesh's data axis when
    one is given."""
    if mesh is not None:
        from tpumcia_torch.parallel.sharding import permutation_importance_sharded

        return permutation_importance_sharded(
            head, X, y, mesh=mesh, n_repeats=n_repeats, seed=seed, groups=groups,
        )
    from tpumcia_torch.importance.permutation import permutation_importance

    return permutation_importance(head, X, y, n_repeats=n_repeats, seed=seed, groups=groups)


def channel_importance(
    head,
    features,
    labels=None,
    *,
    method: str = "auto",
    config=None,
    eval_features=None,
    eval_labels=None,
    mesh=None,
) -> ChannelImportanceResult:
    """Per-feature importances from the head, aggregated per channel
    (tpumcia's ``channel_importance``, notebook cells 23-28). ``method``:

    - ``'mdi'``: the forest head's impurity importances;
    - ``'coef'``: |weight| importances of a logistic head;
    - ``'permutation'``: each channel's columns permuted jointly, on the
      evaluation set (``eval_features``/``eval_labels``, else
      ``features``/``labels``), on the head's device;
    - ``'permutation_features'``: the reference's per-feature permutation
      importances, aggregated per channel (ipynb:493-505);
    - ``'ablation'``: the score drop with a channel's columns set to their
      mean;
    - ``'auto'``: ``'mdi'`` for a forest, ``'permutation'`` otherwise.

    ``mesh``: a ``parallel.Mesh``; both permutation methods then run the
    sharded sweep (``parallel.sharding.permutation_importance_sharded``).
    """
    from tpumcia_torch.config import ImportanceConfig
    from tpumcia_torch.features.extract import FeatureMatrix
    from tpumcia_torch.models.heads import LogisticHead, RandomForestHead

    cfg = config or ImportanceConfig()
    if mesh is not None:
        from tpumcia_torch.parallel.mesh import check_mesh

        check_mesh(mesh)
    if not isinstance(features, FeatureMatrix):
        raise TypeError("features must be a FeatureMatrix (need column names)")
    names = features.names
    C = features.num_channels
    if method == "auto":
        method = "mdi" if isinstance(head, RandomForestHead) else "permutation"
    ch_names = getattr(features, "channel_names", None)
    # positional groups work whatever the channel names; substring matching
    # keeps the reference's name-based grouping
    pos_groups = features.channel_columns() if cfg.channel_match == "exact" else None

    if method == "mdi":
        if not isinstance(head, RandomForestHead):
            raise TypeError("mdi requires a RandomForestHead")
        out = aggregate_channel_importance(
            head.mdi_importance(), names, C, threshold=cfg.mdi_threshold,
            match=cfg.channel_match, method="mdi", groups=pos_groups,
        )
        out.channel_names = ch_names
        return out

    if method == "coef":
        if not isinstance(head, LogisticHead):
            raise TypeError("coef requires a LogisticHead")
        out = aggregate_channel_importance(
            head.coefficient_importance(), names, C, threshold=cfg.mdi_threshold,
            match=cfg.channel_match, method="coef", groups=pos_groups,
        )
        out.channel_names = ch_names
        return out

    X = eval_features.values if isinstance(eval_features, FeatureMatrix) else eval_features
    y = eval_labels
    if X is None:
        X, y = features.values, labels
        if features.device_values is not None:
            X = features.device_values  # the copy already on the device
    if y is None:
        raise ValueError(f"method {method!r} needs labels for scoring")
    X = X if isinstance(X, torch.Tensor) else np.asarray(X)

    if method == "permutation":
        groups = features.channel_columns()
        res = _sweep(head, X, y, n_repeats=cfg.n_repeats, seed=cfg.seed, groups=groups, mesh=mesh)
        total = res.importances_mean.copy()
        # a grouped sweep has no per-feature resolution: each channel's mean
        # drop is broadcast onto its columns
        feat_imp = np.zeros(len(names))
        for c, cols in enumerate(groups):
            feat_imp[cols] = total[c]
        out = ChannelImportanceResult(
            per_channel=[res.importances[c] for c in range(C)],
            mean=total,
            total=total,
            ranking=np.argsort(total)[::-1],
            feature_importances=feat_imp,
            feature_names=names,
            method="permutation",
            channel_names=ch_names,
        )
        out.extras["permutation"] = res
        return out

    if method == "permutation_features":
        res = _sweep(head, X, y, n_repeats=cfg.n_repeats, seed=cfg.seed, groups=None, mesh=mesh)
        out = aggregate_channel_importance(
            res.importances_mean, names, C, threshold=None, match=cfg.channel_match,
            method="permutation_features", groups=pos_groups,
        )
        out.channel_names = ch_names
        out.extras["permutation"] = res
        return out

    if method == "ablation":
        from tpumcia_torch.importance.ablation import channel_ablation_importance

        host = X.cpu().numpy() if isinstance(X, torch.Tensor) else X
        drops = channel_ablation_importance(head, host, y, features.channel_columns())
        return ChannelImportanceResult(
            per_channel=[np.array([d]) for d in drops],
            mean=drops,
            total=drops,
            ranking=np.argsort(drops)[::-1],
            feature_importances=np.zeros(len(names)),
            feature_names=names,
            method="ablation",
            channel_names=ch_names,
        )

    raise ValueError(f"unknown method {method!r}")
